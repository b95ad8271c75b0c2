"""The fp32 forward conv unit (``conv_f32_kernel`` in
m3f_torch/csrc/conv_bn_f32.cu, wrapped by ``ops.conv_bn.conv_unit_fwd``
for fp32 x) where a CPU can hold it: its tiling (``f32_fwd_plan``) at every
fused unit's serving and training shape, a numpy run of the kernel's walk
(position tiles of 64, K in chunks of 16 input channels a tap, the neighbour
gather with its zero padding, the two-rounding prologue, partial rows of
the sums per range) against the JAX package's Pallas units in fp32 under
interpret mode (as tests/test_conv_bn_fused.py runs them), the scoped fp32
precision of ``nn.full_fp32`` (no TF32) across threads, and the refusal of
fp32 training on the card before any launch. The kernel itself runs only
on the card (chip_smoke.py, phase kernel_conv_f32).

Tolerances: y within F32_TOL of its largest magnitude (fp32 sums in another
order); the sums per channel rtol 1e-4 / atol 1e-2 (tests/test_torch_conv_bn.py,
from tests/test_conv_bn_fused.py:41-46)."""

import dataclasses
import threading

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import m3f.pytorch_tpu.ops.pallas.conv_bn as cb
import m3f_torch.config as tc
from m3f_torch import nn as tnn
from m3f_torch.models.r2plus1d import midplanes
from m3f_torch.ops import conv_bn, cuda_lib
from m3f_torch.train.loop import refuse_fp32_units_training

F32_TOL = 2e-5
S_RTOL, S_ATOL = 1e-4, 1e-2
SMS = 132


def _emulate(x, w, inv, shift, kind, sms=SMS):
    """The kernel's walk in numpy (fp32): returns (y, s1, s2)."""
    b, t, h, wd, ci = x.shape
    co = w.shape[-1]
    taps = 9 if kind == "spatial" else 3
    plan = conv_bn.f32_fwd_plan(b, t, h, wd, co, sms)
    m_all = b * t * h * wd
    xf = x.reshape(m_all, ci)
    wk = w.reshape(taps * ci, co)
    m = np.arange(plan.m_tiles * 64)
    ok_m = m < m_all
    img, r = m // (h * wd), m % (h * wd)
    gh, gw, gt = r // wd, r % wd, img % t
    acc = np.zeros((len(m), plan.n_tiles * 64), np.float32)
    for step in range(taps * -(-ci // 16)):
        tap, c0 = divmod(step, -(-ci // 16))
        c0 *= 16
        if kind == "spatial":
            dh, dw = tap // 3 - 1, tap % 3 - 1
            ok = ok_m & (gh + dh >= 0) & (gh + dh < h) & (gw + dw >= 0) \
                & (gw + dw < wd)
            src = m + dh * wd + dw
        else:
            ok = ok_m & (gt + tap - 1 >= 0) & (gt + tap - 1 < t)
            src = m + (tap - 1) * h * wd
        a = np.zeros((len(m), 16), np.float32)
        cs = np.arange(c0, min(c0 + 16, ci))
        v = xf[np.where(ok, src, 0)][:, cs]
        if inv is not None:
            v = np.maximum(np.float32(v * inv[cs]) + shift[cs], np.float32(0))
        a[:, :len(cs)] = np.where(ok[:, None], v, 0)
        bm = np.zeros((16, plan.n_tiles * 64), np.float32)
        bm[:len(cs), :co] = wk[tap * ci + cs]
        acc += a @ bm
    y = acc[:m_all, :co]
    # one partial row per range of tiles_per_range tiles, summed in order
    rows = [y[r * plan.tiles_per_range * 64:(r + 1) * plan.tiles_per_range * 64]
            for r in range(plan.ranges)]
    s1 = np.sum([q.sum(0) for q in rows], axis=0, dtype=np.float32)
    s2 = np.sum([(q * q).sum(0) for q in rows], axis=0, dtype=np.float32)
    return y.reshape(b, t, h, wd, co), s1, s2


# (kind, x shape, w shape): a partial last position tile (M not a multiple
# of 64), partial chunks (C_in 24, 8), a partial output-channel tile (C_out
# 40, 72), 1x1 images (every spatial tap but the centre in the padding),
# one frame and two (temporal padding), clips across position tiles
EMU_CASES = [
    ("spatial", (2, 3, 5, 7, 24), (3, 3, 24, 40)),
    ("spatial", (3, 2, 1, 1, 8), (3, 3, 8, 72)),
    ("spatial", (1, 2, 9, 4, 40), (3, 3, 40, 16)),
    ("temporal", (2, 1, 3, 5, 24), (3, 24, 40)),
    ("temporal", (3, 2, 4, 5, 16), (3, 16, 72)),
    ("temporal", (2, 5, 6, 3, 40), (3, 40, 24)),
]


def _data(xshape, wshape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*xshape).astype(np.float32),
            (0.1 * rng.randn(*wshape)).astype(np.float32),
            (rng.rand(xshape[-1]) + 0.5).astype(np.float32),
            (0.1 * rng.randn(xshape[-1])).astype(np.float32))


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("kind,xshape,wshape", EMU_CASES)
def test_kernel_walk_matches_pallas_unit_fp32(kind, xshape, wshape, affine):
    x, w, inv, shift = _data(xshape, wshape, seed=len(xshape) + xshape[0])
    a = (inv, shift) if affine else (None, None)
    got = _emulate(x, w, *a, kind)
    ja = tuple(jnp.asarray(v) for v in a) if affine else (None, None)
    wants = [cb.conv_unit_reference(jnp.asarray(x), jnp.asarray(w), *ja,
                                    kind=kind)]
    if kind == "spatial" or xshape[1] > 1:    # the Pallas unit's T-axis
        with pltpu.force_tpu_interpret_mode():  # im2col needs two frames
            wants.append(cb.conv_unit(jnp.asarray(x), jnp.asarray(w), *ja,
                                      kind=kind))
    for want in wants:
        y = np.asarray(want[0])
        assert np.abs(got[0] - y).max() <= F32_TOL * np.abs(y).max()
        for g, s in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, np.asarray(s), rtol=S_RTOL,
                                       atol=S_ATOL)
    # and the CPU wrapper (the plain version) gives the same unit
    port = conv_bn.conv_unit_fwd(
        torch.from_numpy(x), torch.from_numpy(w),
        *(torch.from_numpy(v) for v in a) if affine else (None, None),
        kind=kind)
    assert np.abs(port[0].numpy() - y).max() <= F32_TOL * np.abs(y).max()


def _unit_shapes(clips, mode):
    """(x shape, C_out) of every fused unit of R(2+1)D-18 over ``clips``."""
    out = []
    for c, t, s in ((64, 16, 56), (128, 8, 28), (256, 4, 14), (512, 2, 7)):
        mid = midplanes(c, c, mode=mode)
        out += [((clips, t, s, s, c), mid), ((clips, t, s, s, mid), c)]
    return out


@pytest.mark.parametrize("mode", ["flops", "lane"])
@pytest.mark.parametrize("clips", [128, 32])
def test_plan_covers_every_unit_shape(clips, mode):
    """Every position tile in exactly one range, at most 65535 ranges (the
    grid's y), about 8 blocks a multiprocessor, every output channel in a
    tile."""
    for xs, co in _unit_shapes(clips, mode):
        b, t, h, w, _ = xs
        p = conv_bn.f32_fwd_plan(b, t, h, w, co, SMS)
        assert p.m_tiles == -(-b * t * h * w // 64)
        assert (p.ranges - 1) * p.tiles_per_range < p.m_tiles \
            <= p.ranges * p.tiles_per_range
        assert p.ranges <= 65535 and p.n_tiles * 64 >= co
        assert p.blocks <= 8 * SMS + p.n_tiles
        assert p.blocks >= min(p.m_tiles * p.n_tiles, 4 * SMS)


def test_full_fp32_turns_tf32_off_while_any_thread_is_inside():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, True
        inside, release = threading.Event(), threading.Event()
        seen = []

        def hold():
            with tnn.full_fp32():
                inside.set()
                release.wait(10)
        th = threading.Thread(target=hold)
        th.start()
        inside.wait(10)
        with tnn.full_fp32():
            seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        # this thread left first: the other is still inside
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        release.set()
        th.join()
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        assert seen == [(False, False), (False, False), (True, True)]
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_model_precision_scope_is_for_fp32_on_the_card_only():
    """``M3F.precision`` is ``full_fp32`` for an fp32 model whose weights
    lie on the card, nothing for a CPU model (TF32 exists only there) or a
    bf16 one; chip_smoke.py's serve_backbones shows the scope on the card."""
    from m3f_torch.models.m3f import M3F
    cfg = tc.ModelConfig(audio=tc.AudioNetConfig(channels=(4, 8), feature_dim=8),
                         visual=tc.VisualNetConfig(block_channels=(8,),
                                                   blocks_per_stage=(1,),
                                                   stem_channels=8,
                                                   feature_dim=8),
                         gru=tc.GRUConfig(hidden_size=8))
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        for dtype in ("float32", "bfloat16"):
            m = M3F(dataclasses.replace(cfg, compute_dtype=dtype), device="cpu")
            with m.precision():
                assert cudnn.allow_tf32
    finally:
        cudnn.allow_tf32 = saved


def _model(dtype, use_video=True, **visual):
    from m3f_torch.models.m3f import M3F
    cfg = tc.ModelConfig(
        compute_dtype=dtype, use_video=use_video,
        audio=tc.AudioNetConfig(channels=(4, 8), feature_dim=8),
        visual=tc.VisualNetConfig(block_channels=(8, 16),
                                  blocks_per_stage=(2, 1), stem_channels=8,
                                  feature_dim=16, **visual),
        gru=tc.GRUConfig(hidden_size=8))
    return M3F(cfg, device="cpu")


def test_fp32_training_on_the_card_is_refused_before_any_launch():
    """An fp32 model whose visual branch runs fused units (a 2plus1d
    identity block) is refused for the card before anything launches; bf16,
    the CPU, and the families without fused units train."""
    before = dict(cuda_lib.launches)
    for model in (_model("float32"), _model("float32", stem_s2d=True),
                  _model("float32", mid_mode="lane")):
        with pytest.raises(NotImplementedError,
                           match="fp32 conv-unit backward kernels"):
            refuse_fp32_units_training(model, "cuda")
    assert cuda_lib.launches == before
    for model, dev in ((_model("bfloat16"), "cuda"), (_model("float32"), "cpu"),
                       (_model("float32", conv_mode="3d"), "cuda"),
                       (_model("float32", conv_mode="mc3"), "cuda"),
                       (_model("float32", se_ratio=4), "cuda"),
                       (_model("float32", bn_two_pass=True), "cuda"),
                       (_model("float32", use_video=False), "cuda")):
        refuse_fp32_units_training(model, dev)
