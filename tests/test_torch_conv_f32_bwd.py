"""The fp32 conv-unit backward (``bwd_data_f32_kernel`` and
``bwd_filter_f32_kernel`` in m3f_torch/csrc/conv_bn_f32.cu, wrapped by
``ops.conv_bn.conv_unit_bwd_data`` / ``conv_unit_bwd_filter`` for fp32 x)
where a CPU can hold it: a numpy run of each kernel's walk against the JAX
package's Pallas backward in fp32 under interpret mode (``_spatial_bwd`` /
``_temporal_bwd``, as tests/test_torch_conv_bn_bwd.py runs them; a clip of
one frame against the XLA composition ``_xla_bwd``, since the Pallas
temporal units need two frames) and against the port's plain version, at
the forward's EMU_CASES with and without the prologue; the two tilings
(``f32_bwd_data_plan``, ``f32_bwd_filter_plan``) at every fused unit's train
shape; and the plain versions' convs run without TF32. The kernels
themselves run only on the card (chip_smoke.py, phase kernel_conv_f32_bwd).

Data walk: tiles of 64 positions x 64 input channels, K in chunks of 16
output channels of one tap, ge formed at the gather from gy, y, gs1 and gs2
at the tap's neighbour (0 in the padding and past C_out) against the
filter's mirrored tap, then the two-rounding xa, the mask, dx = dxa * inv
and one partial row of dinv / dshift per range of tiles, summed in order.
Filter walk: slices of chunks of 16 positions, x^ formed at the gather (0
in the padding), ge at the load, one partial [K, C_out] a slice, the
partials summed in slice order.

Tolerances: dx per element within 2e-5 of its largest magnitude (fp32 sums
in another order over K up to 648); dw per element within 1e-5 of
sum |x^|*|ge| plus 1e-6 of that sum's largest (the form of
tests/test_torch_conv_bn_bwd.py); dinv / dshift per channel rtol 1e-4, plus
1e-5 of sum |x * dxa| (sum |dxa|) for channels whose terms cancel."""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import m3f.pytorch_tpu.ops.pallas.conv_bn as jcb
from m3f_torch.ops import conv_bn
from test_torch_conv_f32 import EMU_CASES, SMS, _unit_shapes

DX_TOL = 2e-5
DW_REL, DW_ABS = 1e-5, 1e-6
S_RTOL, S_REL = 1e-4, 1e-5
KC = 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fold(gy, y, gs1, gs2):
    """ge = gy + (gs1 + (2 y) gs2), fp32, each op rounded (numpy float32
    arithmetic rounds every op; no fused multiply-add)."""
    return gy + (gs1 + (np.float32(2) * y) * gs2)


def _neighbour(kind, m, tap, t, h, w):
    """(source position, inside) of the neighbour of positions ``m`` that
    ``tap`` reads, as the kernels' ``neighbour<KIND>``."""
    img, r = m // (h * w), m % (h * w)
    gh, gw, gt = r // w, r % w, img % t
    if kind == "spatial":
        dh, dw = tap // 3 - 1, tap % 3 - 1
        ok = (gh + dh >= 0) & (gh + dh < h) & (gw + dw >= 0) & (gw + dw < w)
        src = m + dh * w + dw
    else:
        ok = (gt + tap - 1 >= 0) & (gt + tap - 1 < t)
        src = m + (tap - 1) * h * w
    return np.where(ok, src, 0), ok


def _emulate_data(x, w, inv, shift, y, gy, gs1, gs2, kind, sms=SMS):
    """The data kernel's walk in numpy (fp32): returns (dx, dinv, dshift)."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    taps = 9 if kind == "spatial" else 3
    plan = conv_bn.f32_bwd_data_plan(b, t, h, wd, ci, sms)
    m_all = b * t * h * wd
    wt = conv_bn.f32_bwd_data_filter(torch.from_numpy(w), kind).numpy()
    gyf, yf = gy.reshape(m_all, co), y.reshape(m_all, co)
    m = np.arange(plan.m_tiles * 64)
    ok_m = m < m_all
    nck = -(-co // KC)
    acc = np.zeros((len(m), plan.n_tiles * 64), np.float32)
    for step in range(taps * nck):
        tap, c0 = divmod(step, nck)
        cs = np.arange(c0 * KC, min(c0 * KC + KC, co))
        src, ok = _neighbour(kind, np.minimum(m, m_all - 1), tap, t, h, wd)
        ok &= ok_m
        a = np.zeros((len(m), KC), np.float32)
        a[:, :len(cs)] = np.where(ok[:, None], _fold(
            gyf[src][:, cs], yf[src][:, cs], gs1[cs], gs2[cs]), 0)
        bm = np.zeros((KC, plan.n_tiles * 64), np.float32)
        bm[:len(cs), :ci] = wt[tap * co + cs]
        acc += a @ bm
    dxh = acc[:m_all, :ci]
    if inv is None:
        return dxh.reshape(x.shape), None, None
    xf = x.reshape(m_all, ci)
    xa = (xf * inv) + shift
    dxa = np.where(xa > 0, dxh, np.float32(0))
    span = plan.tiles_per_range * 64
    dinv = np.zeros(ci, np.float32)
    dshift = np.zeros(ci, np.float32)
    for r in range(plan.ranges):             # one partial row per range
        q = slice(r * span, (r + 1) * span)
        dinv = dinv + (xf[q] * dxa[q]).sum(0)
        dshift = dshift + dxa[q].sum(0)
    return (dxa * inv).reshape(x.shape), dinv, dshift


def _emulate_filter(x, inv, shift, y, gy, gs1, gs2, kind, sms=SMS):
    """The filter kernel's walk in numpy (fp32): returns dw in the
    reference layout."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    taps = 9 if kind == "spatial" else 3
    plan = conv_bn.f32_bwd_filter_plan(b, t, h, wd, ci, co, kind, sms)
    m_all = b * t * h * wd
    k = taps * ci
    xh = x.reshape(m_all, ci)
    if inv is not None:
        xh = np.maximum((xh * inv) + shift, np.float32(0))
    ge = _fold(gy.reshape(m_all, co), y.reshape(m_all, co), gs1, gs2)
    parts = []
    for s in range(plan.slices):
        acc = np.zeros((plan.k_tiles * 64, plan.n_tiles * 64), np.float32)
        for c in range(s * plan.chunks_per_slice,
                       min(plan.chunks, (s + 1) * plan.chunks_per_slice)):
            m = c * KC + np.arange(KC)
            ok_m = m < m_all
            a = np.zeros((KC, plan.k_tiles * 64), np.float32)
            for tap in range(taps):
                src, ok = _neighbour(kind, np.minimum(m, m_all - 1), tap, t,
                                     h, wd)
                a[:, tap * ci:(tap + 1) * ci] = np.where(
                    (ok & ok_m)[:, None], xh[src], 0)
            bm = np.zeros((KC, plan.n_tiles * 64), np.float32)
            bm[ok_m, :co] = ge[m[ok_m]]
            acc += a.T @ bm
        parts.append(acc[:k, :co])
    dw = parts[0]
    for p in parts[1:]:                      # in slice order
        dw = dw + p
    return dw.reshape((3, 3, ci, co) if kind == "spatial" else (3, ci, co))


def _case_id(kind, xs, ws):
    return f"{kind}-{'x'.join(map(str, xs))}-to-{ws[-1]}"


CASES = [pytest.param(i, affine, id=f"{_case_id(*c)}-{'affine' if affine else 'plain'}")
         for i, c in enumerate(EMU_CASES) for affine in (False, True)]


@functools.lru_cache(maxsize=None)
def _inputs(i, affine):
    """Inputs from a numpy seed, y from the reference's forward, and the
    reference's backward: the Pallas one in interpret mode, or the XLA
    composition for a clip of one frame."""
    kind, xs, ws = EMU_CASES[i]
    rng = np.random.RandomState(100 + i)
    co = ws[-1]
    x = rng.randn(*xs).astype(np.float32)
    w = (0.1 * rng.randn(*ws)).astype(np.float32)
    inv = (rng.rand(xs[-1]) + 0.5).astype(np.float32) if affine else None
    shift = (0.1 * rng.randn(xs[-1])).astype(np.float32) if affine else None
    gy = rng.randn(*xs[:-1], co).astype(np.float32)
    gs1 = rng.randn(co).astype(np.float32)
    gs2 = (0.01 * rng.randn(co)).astype(np.float32)
    j = lambda v: None if v is None else jnp.asarray(v)
    y = np.asarray(jcb.conv_unit_reference(j(x), j(w), j(inv), j(shift),
                                           kind=kind)[0])
    args = (j(x), j(w), j(inv), j(shift), j(y), j(gy), j(gs1), j(gs2))
    if kind == "temporal" and xs[1] < 2:
        want = jcb._xla_bwd(kind, *args)
    else:
        bwd = jcb._spatial_bwd if kind == "spatial" else jcb._temporal_bwd
        want = bwd(*args, interpret=True)
    want = tuple(None if v is None else np.asarray(v) for v in want)
    t = lambda v: None if v is None else torch.from_numpy(v)
    plain = conv_bn.conv_unit_bwd_reference(
        t(x), t(w), t(inv), t(shift), t(y), t(gy), t(gs1), t(gs2), kind=kind)
    plain = tuple(None if v is None else v.numpy() for v in plain)
    return kind, (x, w, inv, shift, y, gy, gs1, gs2), want, plain


@pytest.mark.parametrize("i,affine", CASES)
def test_data_walk_matches_pallas_backward_fp32(i, affine):
    kind, (x, w, inv, shift, y, gy, gs1, gs2), want, plain = _inputs(i, affine)
    dx, dinv, dshift = _emulate_data(x, w, inv, shift, y, gy, gs1, gs2, kind)
    for ref in (want, plain):
        assert np.abs(dx - ref[0]).max() <= DX_TOL * np.abs(ref[0]).max()
        if inv is None:
            assert ref[2] is None and dinv is None and dshift is None
            continue
        # the scale of each channel's summation error
        mask = (x * inv + shift) > 0
        dxa = np.where(mask, ref[0] / inv, 0)
        axes = tuple(range(x.ndim - 1))
        for got, r, scale in ((dinv, ref[2], np.abs(x * dxa).sum(axes)),
                              (dshift, ref[3], np.abs(dxa).sum(axes))):
            assert (np.abs(got - r) <= S_RTOL * np.abs(r) + S_REL * scale).all()


@pytest.mark.parametrize("i,affine", CASES)
def test_filter_walk_matches_pallas_backward_fp32(i, affine):
    kind, (x, w, inv, shift, y, gy, gs1, gs2), want, plain = _inputs(i, affine)
    dw = _emulate_filter(x, inv, shift, y, gy, gs1, gs2, kind)
    xh = np.maximum(x * inv + shift, 0) if inv is not None else x
    ge = _fold(gy, y, gs1, gs2)
    absw = conv_bn.conv_unit_bwd_filter_reference(
        torch.from_numpy(np.abs(xh)), None, None,
        torch.zeros(ge.shape), torch.from_numpy(np.abs(ge)),
        torch.zeros(ge.shape[-1]), torch.zeros(ge.shape[-1]), kind=kind).numpy()
    lim = DW_REL * absw + DW_ABS * absw.max()
    for ref in (want, plain):
        assert dw.shape == ref[1].shape
        assert (np.abs(dw - ref[1]) <= lim).all(), np.abs(dw - ref[1]).max()


def test_walks_see_the_padding_and_the_slices():
    """The walks' checks can fail: ge formed through the formula in the
    padding (gs1 there) and x^ formed through the prologue in the padding
    (relu(shift) there) each miss the reference at the 1x1-image and
    one-frame cases, and a dw without its last slice's share where the
    walk takes several slices."""
    for i in (1, 3):                       # 1x1 images; a clip of one frame
        kind, (x, w, inv, shift, y, gy, gs1, gs2), want, _ = _inputs(i, True)
        ci, co = x.shape[-1], gy.shape[-1]
        pad = ((0, 0), (0, 0), (1, 1), (1, 1), (0, 0)) if kind == "spatial" \
            else ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0))
        # ge through the formula in the padding: y = gy = 0 there gives gs1
        gep = _fold(np.pad(gy, pad), np.pad(y, pad), gs1, gs2)
        kern, _ = conv_bn._torch_kernel(torch.from_numpy(w), kind)
        flip = kern.flip(2, 3, 4).transpose(0, 1)
        dxh = torch.nn.functional.conv3d(
            torch.from_numpy(gep).permute(0, 4, 1, 2, 3), flip).permute(
                0, 2, 3, 4, 1).numpy()
        wrong_dx = np.where(x * inv + shift > 0, dxh, 0) * inv
        assert np.abs(wrong_dx - want[0]).max() > DX_TOL * np.abs(want[0]).max()
        # x^ through the prologue in the padding: relu(shift) there
        xhp = np.maximum(np.pad(x, pad) * inv + shift, 0)
        ge = _fold(gy, y, gs1, gs2)
        ksize = (1, 3, 3) if kind == "spatial" else (3, 1, 1)
        wrong_dw = torch.nn.grad.conv3d_weight(
            torch.from_numpy(xhp).permute(0, 4, 1, 2, 3), (co, ci) + ksize,
            torch.from_numpy(ge).permute(0, 4, 1, 2, 3)).numpy()
        wrong_dw = (wrong_dw[:, :, 0].transpose(2, 3, 1, 0) if kind == "spatial"
                    else wrong_dw[:, :, :, 0, 0].transpose(2, 1, 0))
        assert np.abs(wrong_dw - want[1]).max() > DW_REL * np.abs(want[1]).max()
    for i in (0, 3):                       # 14 and 2 chunks of 16 positions
        kind, (x, w, inv, shift, y, gy, gs1, gs2), want, _ = _inputs(i, True)
        b, t, h, wd, ci = x.shape
        co, m = gy.shape[-1], b * t * h * wd
        plan = conv_bn.f32_bwd_filter_plan(b, t, h, wd, ci, co, kind, SMS)
        assert plan.slices > 1
        last = plan.positions_of(plan.slices - 1, m)
        keep = np.ones((m, 1), np.float32)
        keep[last.start:last.stop] = 0
        ge = (_fold(gy, y, gs1, gs2).reshape(m, co) * keep).reshape(gy.shape)
        zero = torch.zeros(co)
        short = conv_bn.conv_unit_bwd_filter_reference(
            *(torch.from_numpy(v) for v in (x, inv, shift)),
            torch.zeros(gy.shape), torch.from_numpy(ge), zero, zero,
            kind=kind).numpy()
        assert np.abs(short - want[1]).max() > DW_REL * np.abs(want[1]).max()


@pytest.mark.parametrize("mode", ["flops", "lane"])
@pytest.mark.parametrize("clips", [128, 32])
@pytest.mark.parametrize("part", ["data", "filter"])
def test_plans_cover_every_train_shape(part, clips, mode):
    """Every fused unit's shape: the data gradient's position tiles each in
    exactly one range, at most 65535 ranges (the grid's y), every input
    channel in a tile, its partial rows of dinv / dshift; the filter
    gradient's chunks of 16 positions each in exactly one slice, none
    empty, at most 65535 slices and K tiles (the grid's z and y), the
    partials within _FILTER_PART_BYTES, about 8 blocks a multiprocessor
    where the work allows."""
    for xs, co in _unit_shapes(clips, mode):
        b, t, h, w, ci = xs
        m = b * t * h * w
        for kind in ("spatial", "temporal"):
            if part == "data":
                p = conv_bn.f32_bwd_data_plan(b, t, h, w, ci, SMS)
                assert p == conv_bn.f32_fwd_plan(b, t, h, w, ci, SMS)
                assert p.m_tiles == -(-m // 64)
                assert (p.ranges - 1) * p.tiles_per_range < p.m_tiles \
                    <= p.ranges * p.tiles_per_range
                assert p.ranges <= 65535 and p.n_tiles * 64 >= ci
                assert p.blocks >= min(p.m_tiles * p.n_tiles, 4 * SMS)
                continue
            p = conv_bn.f32_bwd_filter_plan(b, t, h, w, ci, co, kind, SMS)
            k = (9 if kind == "spatial" else 3) * ci
            assert p.k_tiles * 64 >= k > (p.k_tiles - 1) * 64
            assert p.n_tiles * 64 >= co > (p.n_tiles - 1) * 64
            assert p.chunks == -(-m // KC)
            assert (p.slices - 1) * p.chunks_per_slice < p.chunks \
                <= p.slices * p.chunks_per_slice
            covered = [p.positions_of(s, m) for s in range(p.slices)]
            assert covered[0].start == 0 and covered[-1].stop == m
            assert all(len(r) > 0 for r in covered)
            assert all(a.stop == c.start for a, c in zip(covered, covered[1:]))
            assert p.slices <= 65535 and p.k_tiles <= 65535
            assert p.part_bytes <= conv_bn._FILTER_PART_BYTES
            assert p.part_bytes == (4 * k * co * p.slices if p.slices > 1 else 0)
            tiles = p.k_tiles * p.n_tiles
            assert p.blocks == tiles * p.slices
            # slices >= half the wanted count (chunks cut into equal runs)
            assert 2 * p.blocks >= min(tiles * p.chunks, 8 * SMS,
                                       tiles * (conv_bn._FILTER_PART_BYTES
                                                // (4 * k * co)))


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_plain_backward_runs_its_convs_without_tf32(kind, monkeypatch):
    """The plain versions' convs (``F.conv3d`` of the data gradient,
    ``torch.nn.grad.conv3d_weight`` of the filter gradient) run inside
    ``nn.full_fp32``, as the plain forward does: on the card cuDNN would
    otherwise run an fp32 conv in TF32 when chip_smoke.py calls them alone
    to hold the fp32 kernels. TF32 is turned on before the call, seen off
    inside each conv and on again after."""
    cudnn = torch.backends.cudnn
    seen = []

    def spy(fn, name):
        def wrapped(*a, **k):
            seen.append((name, cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(torch.nn.functional, "conv3d",
                        spy(torch.nn.functional.conv3d, "conv3d"))
    monkeypatch.setattr(torch.nn.grad, "conv3d_weight",
                        spy(torch.nn.grad.conv3d_weight, "conv3d_weight"))
    _, xs, ws = next(c for c in EMU_CASES if c[0] == kind)
    rng = np.random.RandomState(5)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    x, w, inv, shift = t(*xs), t(*ws), t(xs[-1]).abs(), t(xs[-1])
    co = ws[-1]
    y, gy, gs1, gs2 = t(*xs[:-1], co), t(*xs[:-1], co), t(co), t(co)
    saved = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        conv_bn.conv_unit_bwd_reference(x, w, inv, shift, y, gy, gs1, gs2,
                                        kind=kind)
        after = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert [s[0] for s in seen] == ["conv3d", "conv3d_weight"]
    assert all(not s[1] and not s[2] for s in seen), seen
    assert after == (True, True)
