"""The port's train-time options against the JAX package: augmentation
(``m3f_torch/ops/augment.py``) and dropout (``m3f_torch/models/m3f.py``),
with the reference's random draws fed in, and their determinism in the
trainer.

- ``apply_augment`` with JAX's ``bernoulli`` / ``uniform`` draws equals
  ``augment_clips`` bit for bit, bf16 and fp32, uint8 and float input, each
  knob on and off; ``flip_prob`` 0 and 1; the draws are a fixed function of
  ``(seed, step)``;
- ``apply_dropout`` with JAX's keep mask equals ``_dropout`` bit for bit;
  the whole model's ``forward_train`` with JAX's two masks fed in matches
  ``M3F.apply(train=True, rng)`` on the same weights (``F32_TOL`` /
  ``BF16_TOL`` of tests/test_torch_predictor.py); eval ignores dropout;
- a ``fit`` of 4 steps with both options equals a fit of 2 steps, a
  checkpoint and a resume of 2 more, bit for bit on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
import m3f_torch.models.m3f as port_m3f
from m3f.pytorch_tpu.data.windowing import samples_per_window
from m3f.pytorch_tpu.models.m3f import M3F as JM3F
from m3f.pytorch_tpu.models.m3f import _dropout as jdropout
from m3f.pytorch_tpu.ops.augment import augment_clips as jaugment
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import WindowSequencer, example_stream
from m3f_torch.models.m3f import M3F, apply_dropout
from m3f_torch.ops.augment import apply_augment, augment_clips, augment_draws
from m3f_torch.train.checkpoint import Checkpointer, from_jax_params
from m3f_torch.train.loop import Trainer

F32_TOL = 2e-5      # fp32 compute: order-only differences end to end
BF16_TOL = 3e-2     # bf16 compute: one-ulp rounding differences carried
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _jax_draws(key, b, flip_prob, brightness, contrast):
    """The draws ``augment_clips`` of the JAX package makes from ``key``."""
    kf, kb, kc = jax.random.split(key, 3)
    flip = jax.random.bernoulli(kf, flip_prob, (b,))
    scale = jax.random.uniform(kc, (b,), jnp.float32, 1.0 - contrast,
                               1.0 + contrast)
    shift = jax.random.uniform(kb, (b,), jnp.float32, -brightness, brightness)
    return (torch.from_numpy(np.array(flip)),
            torch.from_numpy(np.array(scale)),
            torch.from_numpy(np.array(shift)))


def _clips(kind, seed=0, shape=(4, 2, 3, 6, 5, 3)):
    rng = np.random.RandomState(seed)
    if kind == "uint8":
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["uint8", "float"])
@pytest.mark.parametrize("knobs", [(0.5, 0.1, 0.1), (0.5, 0.3, 0.0),
                                   (0.5, 0.0, 0.25), (1.0, 0.2, 0.4)],
                         ids=["default", "no_contrast", "no_brightness",
                              "strong"])
def test_augment_with_the_reference_draws_is_bit_exact(dtype, kind, knobs):
    flip_prob, brightness, contrast = knobs
    tdt, jdt = DTYPES[dtype]
    video = _clips(kind)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jaugment(key, jnp.asarray(video), flip_prob=flip_prob,
                        brightness=brightness, contrast=contrast,
                        compute_dtype=jdt)
        draws = _jax_draws(key, video.shape[0], flip_prob, brightness, contrast)
        got = apply_augment(torch.from_numpy(video), *draws,
                            brightness=brightness, contrast=contrast,
                            compute_dtype=tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_flip_prob_extremes(kind):
    video = torch.from_numpy(_clips(kind))
    plain = video.float() / (255.0 if kind == "uint8" else 1.0)
    gen = torch.Generator().manual_seed(0)
    never = augment_clips(video, flip_prob=0.0, brightness=0.0, contrast=0.0,
                          compute_dtype=torch.float32, generator=gen)
    always = augment_clips(video, flip_prob=1.0, brightness=0.0, contrast=0.0,
                           compute_dtype=torch.float32, generator=gen)
    assert torch.equal(never, plain)
    assert torch.equal(always, plain.flip(-2))


def test_draws_are_per_example_and_a_function_of_seed_and_step():
    tr = Trainer(_cfg(tc, augment=True), device="cpu")

    def draws(seed, step):
        return augment_draws(8, flip_prob=0.5, brightness=0.1, contrast=0.1,
                             generator=tr._step_generator(seed, step),
                             device="cpu")
    a, b = draws(0, 5), draws(0, 5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for other in (draws(0, 6), draws(1, 5)):
        assert not all(torch.equal(x, y) for x, y in zip(a, other))
    flip, scale, shift = a
    assert flip.shape == scale.shape == shift.shape == (8,)
    assert ((scale >= 0.9) & (scale <= 1.1)).all()
    assert ((shift >= -0.1) & (shift <= 0.1)).all()
    # each example's decision covers all its windows and frames
    video = torch.from_numpy(_clips("uint8", shape=(8, 2, 3, 4, 4, 3)))
    out = apply_augment(video, *a, brightness=0.1, contrast=0.1,
                        compute_dtype=torch.float32)
    for i in range(8):
        ref = apply_augment(video[i:i + 1, :1, :1], flip[i:i + 1],
                            scale[i:i + 1], shift[i:i + 1], brightness=0.1,
                            contrast=0.1, compute_dtype=torch.float32)
        assert torch.equal(out[i:i + 1, :1, :1], ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_apply_dropout_with_the_reference_mask_is_bit_exact(dtype, rate):
    tdt, jdt = DTYPES[dtype]
    x = np.random.RandomState(1).randn(3, 40, 12).astype(np.float32)
    key = jax.random.PRNGKey(7)
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    want = jdropout(key, jnp.asarray(x, jdt), rate)
    got = apply_dropout(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(np.array(keep)), rate)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), _np(want))


def _cfg(mod, rig="fusion", dtype="float32", dropout=0.0, augment=False,
         **train):
    if rig == "audio_only":
        model = mod.ModelConfig(
            use_audio=True, use_video=False,
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype=dtype,
            dropout=dropout)
    else:
        model = mod.ModelConfig(
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            visual=mod.VisualNetConfig(block_channels=(8, 16),
                                       blocks_per_stage=(2, 1),
                                       stem_channels=8, feature_dim=16),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype=dtype,
            dropout=dropout)
    base = dict(batch_size=2, num_steps=4, log_every=1, eval_every=0,
                checkpoint_every=2, mesh=mod.MeshConfig(num_data=1))
    base.update(train)
    return mod.ExperimentConfig(
        name="options", model=model, window=mod.WindowConfig(windows_per_clip=2),
        data=mod.DataConfig(synthetic_num_videos=2, synthetic_video_frames=64,
                            image_size=32, augment=augment),
        train=mod.TrainConfig(**base))


@pytest.mark.parametrize("rig,dtype", [("audio_only", "float32"),
                                       ("fusion", "float32"),
                                       ("audio_only", "bfloat16")])
def test_forward_train_with_the_reference_masks(monkeypatch, rig, dtype):
    rate = 0.3
    jcfg = _cfg(jc, rig, dtype, dropout=rate).model
    jm = JM3F(jcfg)
    params, state = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)
    b, w = 2, 2
    wav = rng.randn(b, w, samples_per_window(
        jcfg.mel, jcfg.audio.mel_frames_per_window)).astype(np.float32)
    video = (rng.randint(0, 256, (b, w, 16, 32, 32, 3)).astype(np.uint8)
             if rig == "fusion" else None)
    key = jax.random.PRNGKey(11)
    want, _ = jm.apply(params, state, wav=wav, video=video, train=True, rng=key)
    keys = list(jax.random.split(key))
    asked = []

    def reference_mask(shape, p, generator, device):
        assert p == rate
        asked.append(tuple(shape))
        return torch.from_numpy(np.array(
            jax.random.bernoulli(keys[len(asked) - 1], 1.0 - p, tuple(shape))))
    monkeypatch.setattr(port_m3f, "dropout_mask", reference_mask)
    model = M3F(_cfg(tc, rig, dtype, dropout=rate).model, device="cpu")
    model.load_state_dict(from_jax_params(jax.device_get(params),
                                          jax.device_get(state)))
    got = model.forward_train(
        wav=torch.from_numpy(wav),
        video=None if video is None else torch.from_numpy(video))
    assert len(asked) == 2 and asked[0][:2] == asked[1][:2] == (b, w * 16)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)
    # the masks matter: the same forward with no dropout differs
    nodrop, _ = jm.apply(params, state, wav=wav, video=video, train=False)
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() < \
        np.abs(np.asarray(nodrop) - np.asarray(want)).max()


def test_eval_ignores_dropout():
    with_drop = M3F(_cfg(tc, "audio_only", dropout=0.5).model, device="cpu")
    without = M3F(_cfg(tc, "audio_only").model, device="cpu")
    without.load_state_dict(with_drop.state_dict())
    wav = torch.from_numpy(np.random.RandomState(3).randn(
        2, 2, samples_per_window(with_drop.cfg.mel, 16)).astype(np.float32))
    assert torch.equal(with_drop(wav=wav), without(wav=wav))
    gen = torch.Generator().manual_seed(0)
    a = with_drop.forward_train(wav=wav, generator=gen)
    b = with_drop.forward_train(wav=wav, generator=gen)
    assert not torch.equal(a, b)           # the stream moved on


def _factory(cfg):
    ds = SyntheticAVDataset(cfg.data, cfg.model.mel)
    seq = WindowSequencer(cfg.window, cfg.model.mel, mel_frames=16)
    return lambda skip: example_stream(ds, seq, cfg.train.batch_size, seed=0,
                                       skip_batches=skip)


def test_resume_repeats_the_options_bit_for_bit(tmp_path):
    """Augmentation and dropout draw from (seed, step): 4 steps in one fit
    equal 2 steps, a checkpoint and a resume of 2, bit for bit; the options
    move the run off the plain one."""
    cfg = _cfg(tc, dropout=0.2, augment=True)
    whole_tr = Trainer(cfg, device="cpu")
    whole, hist = whole_tr.fit(_factory(cfg), log=lambda s: None)
    ck = Checkpointer(str(tmp_path / "run"), keep=2, cfg=cfg)
    Trainer(cfg, device="cpu").fit(_factory(cfg), num_steps=2,
                                   log=lambda s: None, checkpointer=ck)
    assert ck.all_steps() == [2]
    tr = Trainer(cfg, device="cpu")
    resumed, hist_r = tr.fit(_factory(cfg), log=lambda s: None,
                             checkpointer=Checkpointer(str(tmp_path / "run"),
                                                       keep=2, cfg=cfg))
    assert resumed.step == whole.step == 4
    assert hist_r["loss"] == hist["loss"][2:]
    for group in ("params", "bn_state"):
        a, b = getattr(whole, group), getattr(resumed, group)
        for n in a:
            assert torch.equal(a[n], b[n]), (group, n)
    plain = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               dropout=0.0),
                                data=dataclasses.replace(cfg.data,
                                                         augment=False))
    _, hist_p = Trainer(plain, device="cpu").fit(_factory(plain),
                                                 log=lambda s: None)
    assert all(x != y for x, y in zip(hist["loss"], hist_p["loss"]))
    assert all(np.isfinite(hist["loss"]))
