"""The port's serving path (m3f_torch/infer/predictor.py → train/loop.py)
against the JAX ``Predictor`` on one JAX checkpoint ``.npz``: a nominal-rate
video, an off-rate (fps=25, per-video mel hop) one and a chunked one
(``window.eval_max_windows``), plus the checkpoint layouts and input checks.
Small model, 32×32 frames; inputs are numpy from a seed."""

import dataclasses

import numpy as np
import pytest
import torch
import jax

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.infer import Predictor as JPredictor
from m3f.pytorch_tpu.train.checkpoint import Checkpointer, save_pytree
from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
from m3f_torch.infer import Predictor
from m3f_torch.train.checkpoint import read_model_checkpoint

F32_TOL = 2e-5      # fp32 compute: order-only differences end to end
BF16_TOL = 3e-2     # bf16 compute: one-ulp rounding differences carried


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tiny(mod, dtype="float32"):
    return mod.ExperimentConfig(
        name="pred_tiny",
        model=mod.ModelConfig(
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            visual=mod.VisualNetConfig(block_channels=(8, 16),
                                       blocks_per_stage=(2, 1),
                                       stem_channels=8, feature_dim=16),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype=dtype),
        window=mod.WindowConfig(windows_per_clip=2, eval_stride=8,
                                eval_max_windows=6),
        data=mod.DataConfig(image_size=32),
        train=mod.TrainConfig(batch_size=2))


def _video(n, fps, seed):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    wav = (rng.randn(int(round(n / fps * 16000)) + 16000) * 0.3).astype(np.float32)
    return frames, wav


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, tmp_path_factory):
    """(dtype, JAX Predictor, port Predictor) on one JAX checkpoint."""
    cfg = tiny(jc, request.param)
    state = JTrainer(cfg).init_state()
    d = tmp_path_factory.mktemp(f"ckpt_{request.param}")
    path = Checkpointer(str(d), keep=1, cfg=cfg).save(jax.device_get(state))
    port = Predictor(cfg=tiny(tc, request.param), checkpoint=path, device="cpu")
    return request.param, JPredictor(cfg=cfg, checkpoint=path), port


# 48 frames: 5 windows, fused, the last W=2 sequence half padding (its
# backward lane reads the padding window); 160 frames: 19 windows > 6,
# chunked in chunks of 16, the last one with a half-padding sequence too
@pytest.mark.parametrize("n,fps", [(48, None), (48, 25.0), (160, None)],
                         ids=["nominal", "off_rate", "chunked"])
def test_predict_video_matches_jax(pair, n, fps):
    dtype, jp, port = pair
    frames, wav = _video(n, fps or 30.0, seed=n)
    got = port.predict_video(frames=frames, waveform=wav, fps=fps)["pred"]
    want = jp.predict_video(frames=frames, waveform=wav, fps=fps)["pred"]
    assert got.shape == want.shape == (n, 2)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_chunked_equals_fused_and_predict_many():
    port = Predictor(cfg=tiny(tc), device="cpu")
    frames, wav = _video(70, 30.0, seed=9)
    chunked = port.predict_video(frames=frames, waveform=wav)["pred"]
    cfg = dataclasses.replace(port.cfg, window=dataclasses.replace(
        port.cfg.window, eval_max_windows=0))
    fused = Predictor(cfg=cfg, device="cpu")
    fused.model.load_state_dict(port.model.state_dict())
    np.testing.assert_allclose(chunked, fused.predict_video(
        frames=frames, waveform=wav)["pred"], rtol=1e-6, atol=1e-6)
    many = dict(port.predict_many(iter([("a", {"frames": frames, "waveform": wav})])))
    np.testing.assert_array_equal(many["a"], chunked)


def _counted(items, pulled):
    """Yield ``items``, recording in ``pulled`` how many were taken."""
    for item in items:
        pulled.append(item[0])
        yield item


# a fused, an off-rate and a chunked video (160 frames: 19 windows > 6)
_MANY = (("a", 48, None), ("b", 48, 25.0), ("c", 160, None), ("d", 70, None))


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_predict_many_pipeline_equals_serial(pipeline):
    """``predict_many`` with ``pipeline`` videos in flight: each result bit
    for bit ``predict_video``'s, in input order, and the input generator
    pulled at most ``pipeline`` videos ahead of the result yielded."""
    port = Predictor(cfg=tiny(tc), device="cpu")
    videos = []
    for vid, n, fps in _MANY:
        frames, wav = _video(n, fps or 30.0, seed=n + len(vid))
        videos.append((vid, {"frames": frames, "waveform": wav, "fps": fps}))
    pulled = []
    got = []
    for vid, pred in port.predict_many(_counted(videos, pulled),
                                       pipeline=pipeline):
        got.append(vid)
        assert len(pulled) <= len(got) - 1 + pipeline
        v = dict(videos)[vid]
        want = port.predict_video(v["frames"], v["waveform"],
                                  fps=v["fps"])["pred"]
        np.testing.assert_array_equal(pred, want)
    assert got == [vid for vid, _, _ in _MANY]


def test_predict_many_matches_jax(pair):
    """The port's ``predict_many(..., pipeline=2)`` against the JAX one on the
    same weights, at the tolerance of ``test_predict_video_matches_jax``."""
    dtype, jp, port = pair
    videos = []
    for vid, n, fps in _MANY[:3]:
        frames, wav = _video(n, fps or 30.0, seed=n)
        videos.append((vid, {"frames": frames, "waveform": wav, "fps": fps}))
    got = list(port.predict_many(iter(videos), pipeline=2))
    want = list(jp.predict_many(iter(videos), pipeline=2))
    assert [v for v, _ in got] == [v for v, _ in want] == ["a", "b", "c"]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_checkpoint_layouts_and_ema(tmp_path):
    """Full TrainState layout prefers ``.ema/``; the import-script layout
    (``params/``, ``state/``) loads too; a mismatching file raises and
    leaves the old weights serving."""
    cfg = tiny(jc)
    state = jax.device_get(JTrainer(cfg).init_state())
    full = Checkpointer(str(tmp_path), keep=1, cfg=cfg).save(state)
    with np.load(full) as z:
        data = {k: z[k] for k in z.files}
    ema = {".ema/" + k[len(".params/"):]: v * 2 for k, v in data.items()
           if k.startswith(".params/")}
    np.savez(tmp_path / "ema.npz", **data, **ema)
    sd_full, step = read_model_checkpoint(full)
    sd_ema, _ = read_model_checkpoint(str(tmp_path / "ema.npz"))
    assert step == 0
    k = "head.kernel"
    np.testing.assert_array_equal(sd_ema[k].numpy(), 2 * sd_full[k].numpy())
    np.testing.assert_array_equal(sd_ema["audio.bn.0.mean"].numpy(),
                                  sd_full["audio.bn.0.mean"].numpy())
    save_pytree({"params": state.params, "state": state.bn_state},
                str(tmp_path / "import.npz"))
    sd_imp, _ = read_model_checkpoint(str(tmp_path / "import.npz"))
    assert sd_imp.keys() == sd_full.keys()
    for key in sd_full:
        np.testing.assert_array_equal(sd_imp[key].numpy(), sd_full[key].numpy())
    p = Predictor(cfg=tiny(tc), checkpoint=full, device="cpu")
    assert p.reload(str(tmp_path / "ema.npz"))["reloads"] == 1
    wide = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, gru=jc.GRUConfig(hidden_size=16)))
    wstate = jax.device_get(JTrainer(wide).init_state())
    save_pytree({"params": wstate.params, "state": wstate.bn_state},
                str(tmp_path / "wide.npz"))
    before = p.model.head.kernel.clone()
    with pytest.raises(ValueError, match="does not fit"):
        p.reload(str(tmp_path / "wide.npz"))
    assert torch.equal(p.model.head.kernel, before)


def test_input_checks():
    p = Predictor(cfg=tiny(tc), device="cpu")
    frames, wav = _video(20, 30.0, seed=1)
    with pytest.raises(ValueError, match="uint8"):
        p.predict_video(frames=frames.astype(np.float32), waveform=wav)
    with pytest.raises(ValueError, match="shape"):
        p.predict_video(frames=frames[:, :16], waveform=wav)
    with pytest.raises(ValueError, match="fps"):
        p.predict_video(frames=frames, waveform=wav, fps=1000)
    with pytest.raises(ValueError, match="1-D"):
        p.predict_video(frames=frames, waveform=wav[None])
    with pytest.raises(ValueError, match="audio"):
        p.predict_video(frames=frames)


class _CountingLock:
    """A context manager that counts its entries and notes what ran inside."""

    def __init__(self):
        self.entered = 0
        self.held = False

    def __enter__(self):
        self.entered += 1
        self.held = True

    def __exit__(self, *exc):
        self.held = False


def test_reload_takes_lock_only_for_the_swap(tmp_path, monkeypatch):
    """``reload(checkpoint, lock)``: the lock is entered exactly once, around
    the swap and not during the read; a failed reload (missing file,
    mismatching architecture) never takes it and leaves the predictions
    unchanged; the returned dict equals the JAX package's for the same
    checkpoint."""
    import m3f_torch.infer.predictor as mod
    cfg = tiny(jc)
    state = jax.device_get(JTrainer(cfg).init_state())
    first = Checkpointer(str(tmp_path / "a"), keep=1, cfg=cfg).save(state)
    moved = state._replace(
        params=jax.tree_util.tree_map(lambda v: v * 1.5, state.params),
        step=np.asarray(7, np.int32))
    second = Checkpointer(str(tmp_path / "b"), keep=1, cfg=cfg).save(moved)
    port = Predictor(cfg=tiny(tc), checkpoint=first, device="cpu")
    frames, wav = _video(24, 30.0, seed=3)
    before = port.predict_video(frames=frames, waveform=wav)["pred"]

    lock = _CountingLock()
    held_during_load = []
    real_load = mod.read_model_checkpoint

    def watched_load(path):
        held_during_load.append(lock.held)
        return real_load(path)
    monkeypatch.setattr(mod, "read_model_checkpoint", watched_load)
    held_during_swap = []
    real_swap = port.model.load_state_dict

    def watched_swap(sd, *a, **k):
        held_during_swap.append(lock.held)
        return real_swap(sd, *a, **k)
    monkeypatch.setattr(port.model, "load_state_dict", watched_swap)

    # failures first: the lock is never taken, the old weights keep serving
    with pytest.raises(FileNotFoundError):
        port.reload(str(tmp_path / "missing.npz"), lock=lock)
    wide = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, gru=jc.GRUConfig(hidden_size=16)))
    wstate = jax.device_get(JTrainer(wide).init_state())
    save_pytree({"params": wstate.params, "state": wstate.bn_state},
                str(tmp_path / "wide.npz"))
    with pytest.raises(ValueError, match="does not fit"):
        port.reload(str(tmp_path / "wide.npz"), lock=lock)
    assert lock.entered == 0 and held_during_swap == []
    assert port.reload_count == 0 and port.checkpoint_path == first
    np.testing.assert_array_equal(
        port.predict_video(frames=frames, waveform=wav)["pred"], before)

    held_during_load.clear()
    info = port.reload(second, lock=lock)
    assert lock.entered == 1 and not lock.held
    assert held_during_load == [False] and held_during_swap == [True]
    jinfo = JPredictor(cfg=cfg, checkpoint=first).reload(second)
    assert info == jinfo == {"checkpoint": second, "step": 7, "reloads": 1}
    assert port.checkpoint_path == second
    after = port.predict_video(frames=frames, waveform=wav)["pred"]
    assert np.abs(after - before).max() > 1e-4
    # without a lock, as before
    assert port.reload(first)["reloads"] == 2
    np.testing.assert_array_equal(
        port.predict_video(frames=frames, waveform=wav)["pred"], before)
