"""The port's models (m3f_torch/models) against the JAX package on one set
of weights: ``M3F.init`` / branch ``init`` → numpy → ``from_jax_params`` →
the port. Inputs are numpy from a seed. fp32 is held tight (both sides
accumulate in fp32; only the summation order differs); bf16 looser (the two
frameworks' bf16 convs can round an output one ulp apart, and the error
carries through the layers). The port's fused block routing must equal both
JAX conv backends."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.models.audio import AudioCNN as JAudio
from m3f.pytorch_tpu.models.m3f import M3F as JM3F
from m3f.pytorch_tpu.models.r2plus1d import R2Plus1D as JR2
from m3f_torch.models.audio import AudioCNN
from m3f_torch.models.m3f import M3F
from m3f_torch.models.r2plus1d import R2Plus1D, midplanes
from m3f_torch.train.checkpoint import from_jax_params

F32_TOL = 2e-5
BF16_TOL = 3e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _gen():
    return torch.Generator().manual_seed(0)


def _load(module, params, state):
    module.load_state_dict(from_jax_params(jax.device_get(params),
                                           jax.device_get(state)))
    return module


def _visual(mod, **kw):
    return mod.VisualNetConfig(block_channels=(8, 16), blocks_per_stage=(2, 1),
                               stem_channels=8, feature_dim=16, **kw)


def _model(mod, dtype="float32", **kw):
    return mod.ModelConfig(audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
                           visual=_visual(mod), gru=mod.GRUConfig(hidden_size=8),
                           compute_dtype=dtype, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_frame", [False, True])
def test_audio_cnn(per_frame, dtype):
    jcfg = jc.AudioNetConfig(channels=(4, 8, 16), feature_dim=8)
    params, state = JAudio(jcfg).init(jax.random.PRNGKey(1))
    port = _load(AudioCNN(tc.AudioNetConfig(channels=(4, 8, 16), feature_dim=8),
                          _gen()), params, state).eval()
    mel = np.random.RandomState(0).randn(3, 16, 64).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(mel).to(getattr(torch, dtype)),
                   per_frame=per_frame).float().numpy()
    with jax.default_matmul_precision("highest"):
        want, _ = JAudio(jcfg).apply(params, state, jnp.asarray(mel, dtype),
                                     per_frame=per_frame)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_midplanes():
    for i, o in [(64, 64), (64, 128), (128, 256), (3, 64), (512, 512)]:
        mid = (27 * i * o) // (9 * i + 3 * o)
        assert midplanes(i, o) == mid
        assert midplanes(i, o, mode="lane") == max(128, (mid + 63) // 128 * 128)
    with pytest.raises(ValueError, match="mid_mode"):
        midplanes(64, 64, mode="wide")


def test_r2plus1d_fused_routing_equals_both_jax_backends():
    params, state = JR2(_visual(jc)).init(jax.random.PRNGKey(2))
    port = _load(R2Plus1D(_visual(tc), _gen()), params, state).eval()
    assert [b.has_downsample for b in port.blocks] == [False, False, True]
    clips = np.random.RandomState(1).rand(1, 4, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(clips), per_frame=True).numpy()
    with jax.default_matmul_precision("highest"):
        for backend in ("xla", "pallas_fused"):
            with pltpu.force_tpu_interpret_mode():
                want, _ = JR2(_visual(jc, conv_backend=backend)).apply(
                    params, state, jnp.asarray(clips), per_frame=True)
            np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=backend)


def test_r2plus1d_unknown_conv_backend_raises():
    # Both reference backends route the same way in the port; a value that
    # would be silently ignored is refused.
    for backend in ("xla", "pallas_fused"):
        R2Plus1D(_visual(tc, conv_backend=backend), _gen())
    with pytest.raises(ValueError, match="conv_backend"):
        R2Plus1D(_visual(tc, conv_backend="cudnn"), _gen())


def _m3f_inputs(seed, spw, W=2, L=16, S=32):
    rng = np.random.RandomState(seed)
    video = rng.randint(0, 256, (1, W, L, S, S, 3), dtype=np.uint8)
    wav = (rng.randn(1, W, spw) * 0.3).astype(np.float32)
    return video, wav


M3F_CASES = [
    pytest.param("float32", True, None, id="f32-per_frame"),
    pytest.param("float32", False, None, id="f32-pooled"),
    pytest.param("float32", True, 640, id="f32-dynamic_hop"),
    pytest.param("bfloat16", True, None, id="bf16-per_frame"),
]


@pytest.mark.parametrize("dtype,per_frame,hop", M3F_CASES)
def test_m3f_forward(dtype, per_frame, hop):
    jcfg = _model(jc, dtype, per_frame=per_frame)
    params, state = JM3F(jcfg).init(jax.random.PRNGKey(3))
    port = _load(M3F(_model(tc, dtype, per_frame=per_frame), device="cpu"),
                 params, state)
    mel = jcfg.mel
    spw = 15 * (mel.max_hop_length if hop else mel.hop_length)
    video, wav = _m3f_inputs(4, spw)
    got = port(video=torch.from_numpy(video), wav=torch.from_numpy(wav),
               hop=hop).numpy()
    with jax.default_matmul_precision("highest"):
        want, _ = JM3F(jcfg).apply(params, state, video=jnp.asarray(video),
                                   wav=jnp.asarray(wav),
                                   hop=None if hop is None else jnp.int32(hop))
    assert got.shape == want.shape == ((1, 2, 16, 2) if per_frame else (1, 2, 2))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_m3f_single_branch_models():
    for use_audio, use_video in ((True, False), (False, True)):
        jcfg = dataclasses.replace(_model(jc), use_audio=use_audio,
                                   use_video=use_video)
        params, state = JM3F(jcfg).init(jax.random.PRNGKey(5))
        port = _load(M3F(dataclasses.replace(_model(tc), use_audio=use_audio,
                                             use_video=use_video), device="cpu"),
                     params, state)
        video, wav = _m3f_inputs(6, 15 * jcfg.mel.hop_length)
        # audio-only takes a precomputed log-mel [B, W, F, n_mels]
        mel = np.random.RandomState(7).randn(1, 2, 16, 64).astype(np.float32)
        feed = {"video": video} if use_video else {"mel": mel}
        got = port(**{k: torch.from_numpy(v) for k, v in feed.items()}).numpy()
        with jax.default_matmul_precision("highest"):
            want, _ = JM3F(jcfg).apply(params, state,
                                       **{k: jnp.asarray(v) for k, v in feed.items()})
        np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("two_pass", [False, True])
def test_batchnorm_train_eval_and_affine_from_stats(two_pass):
    """The reference's BN formulas: one-pass (clamped) or two-pass batch
    variance, unbiased running update with momentum, normalize in the
    compute dtype; affine_from_stats from channel sums."""
    from m3f.pytorch_tpu.nn import BatchNorm as JBN
    from m3f_torch.nn import BatchNorm
    rng = np.random.RandomState(7)
    x = (rng.randn(4, 5, 6) * 2 + 1).astype(np.float32)
    p = {"scale": rng.rand(6).astype(np.float32) + 0.5,
         "bias": rng.randn(6).astype(np.float32)}
    s = {"mean": rng.randn(6).astype(np.float32),
         "var": rng.rand(6).astype(np.float32) + 0.5}
    jbn = JBN(6, two_pass=two_pass)
    for train in (False, True):
        bn = BatchNorm(6, two_pass=two_pass)
        bn.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in {**p, **s}.items()})
        got = bn(torch.from_numpy(x), train=train).detach().numpy()
        want, ns = jbn.apply(p, s, jnp.asarray(x), train)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(ns[k]),
                                       rtol=1e-6, atol=1e-6)
        xf = x.reshape(-1, 6)
        s1, s2 = xf.sum(0), (xf * xf).sum(0)
        bn.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in {**p, **s}.items()})
        inv, shift = bn.affine_from_stats(torch.from_numpy(s1), torch.from_numpy(s2),
                                          float(len(xf)), train=train)
        jinv, jshift, _ = jbn.affine_from_stats(p, s, jnp.asarray(s1),
                                                jnp.asarray(s2), float(len(xf)), train)
        np.testing.assert_allclose(inv.detach().numpy(), np.asarray(jinv), rtol=1e-5)
        np.testing.assert_allclose(shift.detach().numpy(), np.asarray(jshift),
                                   rtol=1e-5, atol=1e-5)
