"""Every visual backbone of the JAX package in the port
(m3f_torch/models/r2plus1d.py): ``conv_mode`` 3d (r3d_18) and mc3 (mc3_18),
the SE branch, the space-to-depth stem (with 2plus1d and with 3d) and
``mid_mode="lane"``, in fp32 and bf16, against the JAX package on one set of
weights (``R2Plus1D.init`` → numpy → ``from_jax_params`` → the port). Small
size: 2 stages (8, 16 channels, a downsample in stage 2), 8x16x16 clips,
inputs and loss weights numpy from a seed.

Held: the pooled and per-frame outputs in eval; the train-mode output with
the BatchNorm buffers it updates (one training step's loss and parameter
gradients: tests/test_torch_backbones_grads.py); the 2plus1d variants also
against JAX's ``pallas_fused`` backend in interpret mode (as
tests/test_conv_bn_fused.py runs it). Whole models:
``M3F`` per-frame predictions, and r3d_18 / mc3_18 / SE torchvision-layout
state dicts through the port's import script, served by
``Predictor(device="cpu")`` against the JAX ``Predictor`` on the same file.
Plus ``midplanes`` for every block of the 18- and 34-layer recipes in both
modes, ``space_to_depth_hw`` / ``s2d_stem_kernel`` bit for bit, and the
configurations both packages refuse.

Tolerances (tests/test_torch_models.py): F32_TOL (fp32: both sides
accumulate in fp32, only the summation order differs) and BF16_TOL (bf16:
the two frameworks' bf16 convs can round an output one ulp apart and the
error carries through the layers), each relative to the largest magnitude
of the compared array."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.infer import Predictor as JPredictor
from m3f.pytorch_tpu.models import r2plus1d as jr
from m3f.pytorch_tpu.models.m3f import M3F as JM3F
from m3f.pytorch_tpu.train import convert as jconv
from m3f_torch.infer import Predictor
from m3f_torch.models import r2plus1d as tr
from m3f_torch.models.m3f import M3F
from m3f_torch.scripts import import_torch_checkpoint as timp
from m3f_torch.train.checkpoint import from_jax_params

F32_TOL = 2e-5
BF16_TOL = 3e-2
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}

VARIANTS = {"3d": dict(conv_mode="3d"), "mc3": dict(conv_mode="mc3"),
            "se": dict(se_ratio=4), "s2d": dict(stem_s2d=True),
            "s2d_3d": dict(stem_s2d=True, conv_mode="3d"),
            "lane": dict(mid_mode="lane")}
FACTORIZED = ("se", "s2d", "lane")      # the 2plus1d variants
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _vis(mod, variant, **kw):
    return mod.VisualNetConfig(block_channels=(8, 16), blocks_per_stage=(2, 1),
                               stem_channels=8, feature_dim=16,
                               **VARIANTS[variant], **kw)


@functools.lru_cache(maxsize=None)
def _jax_init(variant):
    params, state = jr.R2Plus1D(_vis(jc, variant)).init(
        jax.random.PRNGKey(len(variant)))
    return jax.device_get(params), jax.device_get(state)


def _port(variant):
    params, state = _jax_init(variant)
    m = tr.R2Plus1D(_vis(tc, variant), torch.Generator().manual_seed(0))
    m.load_state_dict(from_jax_params(params, state))
    return m


def _clips(dtype, seed=1):
    x = np.random.RandomState(seed).rand(2, 8, 16, 16, 3).astype(np.float32)
    return x, torch.from_numpy(x).to(getattr(torch, dtype))


def _jax_apply(variant, backend, params, state, x, dtype, train, per_frame):
    model = jr.R2Plus1D(_vis(jc, variant, conv_backend=backend))
    with jax.default_matmul_precision("highest"), \
            pltpu.force_tpu_interpret_mode():
        return model.apply(params, state, jnp.asarray(x, dtype), train=train,
                           per_frame=per_frame)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: max |diff| / max |want| = {err} > {tol}"


def _cases():
    cases = []
    for v in VARIANTS:
        for d in DTYPES:
            backends = ("xla", "pallas_fused") if v in FACTORIZED else ("xla",)
            for b in backends:
                cases.append(pytest.param(v, d, b, id=f"{v}-{d}-{b}"))
    return cases


@pytest.mark.parametrize("variant,dtype,backend", _cases())
def test_eval_pooled_and_per_frame_match_jax(variant, dtype, backend):
    port = _port(variant).eval()
    params, state = _jax_init(variant)
    x, xt = _clips(dtype)
    tprime = 8 if variant == "mc3" else 4          # mc3 never strides time
    for per_frame, shape in ((False, (2, 16)), (True, (2, tprime, 16))):
        with torch.no_grad():
            got = port(xt, per_frame=per_frame).float().numpy()
        want, _ = _jax_apply(variant, backend, params, state, x, dtype,
                             False, per_frame)
        assert got.shape == shape
        _close(got, want, TOL[dtype], f"per_frame={per_frame}")


@pytest.mark.parametrize("variant,dtype,backend", _cases())
def test_train_mode_output_and_bn_buffers_match_jax(variant, dtype, backend):
    port = _port(variant).train()
    params, state = _jax_init(variant)
    x, xt = _clips(dtype, seed=2)
    with torch.no_grad():
        got = port(xt, per_frame=True, train=True).float().numpy()
    want, new_state = _jax_apply(variant, backend, params, state, x, dtype,
                                 True, True)
    _close(got, want, TOL[dtype], "train-mode output")
    want_bn = from_jax_params({}, jax.device_get(new_state))
    buffers = dict(port.named_buffers())
    assert buffers.keys() == want_bn.keys()
    for name, b in buffers.items():
        _close(b.numpy(), want_bn[name].numpy(), TOL[dtype], name)


def _model(mod, variant, dtype, audio=(4, 8)):
    return mod.ModelConfig(audio=mod.AudioNetConfig(channels=audio,
                                                    feature_dim=8),
                           visual=_vis(mod, variant),
                           gru=mod.GRUConfig(hidden_size=8),
                           compute_dtype=dtype, per_frame=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_m3f_per_frame_matches_jax(variant, dtype):
    """The whole model: per-frame features upsampled T' → L (mc3: T' = L)."""
    jcfg = _model(jc, variant, dtype)
    params, state = JM3F(jcfg).init(jax.random.PRNGKey(3))
    port = M3F(_model(tc, variant, dtype), device="cpu")
    port.load_state_dict(from_jax_params(jax.device_get(params),
                                         jax.device_get(state)))
    rng = np.random.RandomState(5)
    video = rng.randint(0, 256, (1, 2, 16, 32, 32, 3), dtype=np.uint8)
    wav = (rng.randn(1, 2, 15 * jcfg.mel.hop_length) * 0.3).astype(np.float32)
    got = port(video=torch.from_numpy(video), wav=torch.from_numpy(wav)).numpy()
    with jax.default_matmul_precision("highest"):
        want, _ = JM3F(jcfg).apply(params, state, video=jnp.asarray(video),
                                   wav=jnp.asarray(wav))
    assert got.shape == want.shape == (1, 2, 16, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _serve_cfg(mod, variant):
    return mod.ExperimentConfig(
        name="backbone",
        # the import script's audio CNN has the reference's four stages
        model=_model(mod, variant, "float32", audio=(4, 8, 8, 16)),
        window=mod.WindowConfig(windows_per_clip=2, eval_stride=8),
        data=mod.DataConfig(image_size=32),
        train=mod.TrainConfig(batch_size=2))


@pytest.mark.parametrize("variant", ["3d", "mc3", "se"])
def test_torchvision_state_dict_imported_and_served(tmp_path, variant):
    """A torchvision-layout r3d_18 / mc3_18 / SE state dict (the JAX
    export of an init, every array redrawn) through the port's import
    script; the port's Predictor on the file equals the JAX Predictor on
    it."""
    cfg = _serve_cfg(jc, variant)
    params, state = JM3F(cfg.model).init(jax.random.PRNGKey(6))
    sd = jconv.export_m3f(params, state)
    rng = np.random.RandomState(7)
    sd = {k: (np.asarray(v) if v.dtype == np.int64 else
              rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
              if k.endswith("running_var") else
              (rng.randn(*v.shape) * 0.2).astype(np.float32))
          for k, v in sd.items()}
    want_mode = {"3d": "3d", "mc3": "mc3", "se": "2plus1d"}[variant]
    assert jconv.detect_visual_mode(sd, "visual") == want_mode
    pt, npz = str(tmp_path / "model.pth"), str(tmp_path / "model.npz")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    assert timp.main([pt, npz, "--kind", "m3f"]) == 0
    port = Predictor(cfg=_serve_cfg(tc, variant), checkpoint=npz, device="cpu")
    jp = JPredictor(cfg=cfg, checkpoint=npz)
    rng = np.random.RandomState(8)
    frames = rng.randint(0, 256, (40, 32, 32, 3), dtype=np.uint8)
    wav = (rng.randn(40 * 16000 // 30 + 16000) * 0.3).astype(np.float32)
    got = port.predict_video(frames=frames, waveform=wav)["pred"]
    want = jp.predict_video(frames=frames, waveform=wav)["pred"]
    assert got.shape == want.shape == (40, 2)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("have,model", [("3d", "se"), ("mc3", "3d")],
                         ids=["r3d_on_2plus1d_se", "mc3_on_r3d"])
def test_import_refuses_a_file_of_another_family(tmp_path, have, model):
    """A file of one family on a model of another raises before any weight
    is copied: other names (r3d_18 on R(2+1)D), or the same names with other
    shapes (mc3_18's (1,3,3) kernels on r3d_18's (3,3,3)), through
    ``Predictor.reload`` and ``load_model_checkpoint``."""
    from m3f_torch.train.checkpoint import load_model_checkpoint
    from m3f_torch.train.loop import Trainer
    cfg = _serve_cfg(jc, have)
    params, state = JM3F(cfg.model).init(jax.random.PRNGKey(6))
    sd = jconv.export_m3f(params, state)
    pt, npz = str(tmp_path / "model.pth"), str(tmp_path / "model.npz")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, pt)
    assert timp.main([pt, npz, "--kind", "m3f"]) == 0
    port = Predictor(cfg=_serve_cfg(tc, model), device="cpu")
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    with pytest.raises(ValueError, match="does not fit"):
        port.reload(npz)
    for k, v in port.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    template = Trainer(_serve_cfg(tc, model), device="cpu").init_state()
    with pytest.raises(ValueError, match="architecture mismatch"):
        load_model_checkpoint(template, npz)


RECIPES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


@pytest.mark.parametrize("depth", sorted(RECIPES))
@pytest.mark.parametrize("mode", ["flops", "lane"])
def test_midplanes_equal_jax_for_every_block(depth, mode):
    pairs, in_c = [], 64
    for out_c, n in zip((64, 128, 256, 512), RECIPES[depth]):
        for _ in range(n):
            pairs.append((in_c, out_c))
            in_c = out_c
    got = [tr.midplanes(i, o, mode=mode) for i, o in pairs]
    assert got == [jr.midplanes(i, o, mode=mode) for i, o in pairs]
    if mode == "lane":
        # R(2+1)D-18's lane widths: identity blocks 128 / 256 / 512 / 1152,
        # downsample blocks 256 / 512 / 896
        assert sorted(set(got)) == [128, 256, 512, 896, 1152]
        assert all(m % 8 == 0 for m in got)


def test_midplanes_unknown_mode_raises_in_both():
    for fn in (tr.midplanes, jr.midplanes):
        with pytest.raises(ValueError, match="mid_mode"):
            fn(64, 64, mode="wide")


@pytest.mark.parametrize("kt", [1, 3])
def test_space_to_depth_and_s2d_kernel_bit_equal_jax(kt):
    rng = np.random.RandomState(kt)
    x = rng.randn(2, 3, 6, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tr.space_to_depth_hw(torch.from_numpy(x)).numpy(),
        np.asarray(jr.space_to_depth_hw(jnp.asarray(x))))
    k = rng.randn(kt, 7, 7, 3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        tr.s2d_stem_kernel(torch.from_numpy(k)).numpy(),
        np.asarray(jr.s2d_stem_kernel(jnp.asarray(k))))


def test_s2d_stem_pads_explicitly_and_equals_the_strided_stem():
    """The s2d stem conv is the stride-(1,2,2) 7x7 stem on the same
    weights (fp32; only the order of the sums differs), through an
    explicit asymmetric pad of (2, 1) in H and W."""
    for mode in ("2plus1d", "3d"):
        plain = tr.R2Plus1D(tc.VisualNetConfig(conv_mode=mode, block_channels=(8,),
                                               blocks_per_stage=(1,),
                                               stem_channels=8),
                            torch.Generator().manual_seed(0))
        s2d = tr.R2Plus1D(tc.VisualNetConfig(conv_mode=mode, block_channels=(8,),
                                             blocks_per_stage=(1,),
                                             stem_channels=8, stem_s2d=True),
                          torch.Generator().manual_seed(0))
        x = torch.from_numpy(np.random.RandomState(9).rand(1, 4, 12, 10, 3)
                             .astype(np.float32))
        with torch.no_grad():
            got, want = s2d._stem_conv(x), plain._stem_conv(x)
        assert got.shape == want.shape == (1, 4, 6, 5,
                                           45 if mode == "2plus1d" else 8)
        _close(got.numpy(), want.numpy(), F32_TOL, mode)
    with pytest.raises(ValueError, match="even"):
        s2d._stem_conv(torch.zeros(1, 4, 11, 10, 3))


BAD = {"unknown_conv_mode": dict(conv_mode="slowfast"),
       "lane_with_3d": dict(conv_mode="3d", mid_mode="lane"),
       "lane_with_mc3": dict(conv_mode="mc3", mid_mode="lane"),
       "unknown_mid_mode": dict(mid_mode="wide")}


@pytest.mark.parametrize("bad", list(BAD))
def test_refuses_what_jax_refuses(bad):
    """tests/test_conv_modes.py:54-66 (and an unknown mid_mode): JAX raises
    ValueError when it builds the blocks, the port when it builds the
    model."""
    kw = dict(block_channels=(4, 8), blocks_per_stage=(1, 1), stem_channels=4,
              feature_dim=8, **BAD[bad])
    with pytest.raises(ValueError):
        jr.R2Plus1D(jc.VisualNetConfig(**kw)).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="conv_mode|mid_mode"):
        tr.R2Plus1D(tc.VisualNetConfig(**kw), torch.Generator().manual_seed(0))


def test_routing_fuses_only_stride1_identity_2plus1d_blocks(monkeypatch):
    """Which blocks take the fused units: stride-1 identity blocks of the
    2plus1d family without SE (lane and s2d included); none under SE, 3d or
    mc3."""
    calls = []
    real = tr.conv_unit
    monkeypatch.setattr(tr, "conv_unit",
                        lambda *a, **k: calls.append(k["kind"]) or real(*a, **k))
    _, xt = _clips("float32")
    for variant, want in (("lane", 2), ("s2d", 2), ("se", 0), ("3d", 0),
                          ("mc3", 0), ("s2d_3d", 0)):
        calls.clear()
        m = _port(variant).eval()
        assert [m.fused(b) for b in m.blocks].count(True) == want, variant
        with torch.no_grad():
            m(xt)
        assert calls == ["spatial", "temporal"] * 2 * want, variant
