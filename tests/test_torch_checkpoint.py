"""The port's checkpoints (m3f_torch/train/checkpoint.py, save side and
resume): the layout is the JAX package's TrainState layout for the model, so
the reference's ``load_model_checkpoint`` serves a port-trained checkpoint;
``to_jax_params`` inverts ``_convert`` bitwise; save → restore is bitwise and
a resumed run equals an uninterrupted one; the safety paths (config hash,
corrupt file, keep-K, an optimizer state that fits neither layout, writer
failures, SIGTERM)."""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch
import jax

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.models.m3f import M3F as JM3F
from m3f.pytorch_tpu.train.checkpoint import Checkpointer as JCheckpointer
from m3f.pytorch_tpu.train.checkpoint import load_model_checkpoint as jload
from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import WindowSequencer, example_stream
from m3f_torch.models.m3f import M3F
from m3f_torch.train.checkpoint import (Checkpointer, _convert, _flatten,
                                        from_jax_params, read_model_checkpoint,
                                        to_jax_params)
from m3f_torch.train.loop import Trainer


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(mod, **train):
    base = dict(batch_size=2, num_steps=4, log_every=1, eval_every=0,
                checkpoint_every=2, mesh=mod.MeshConfig(num_data=1),
                ema_decay=0.9)
    base.update(train)
    return mod.ExperimentConfig(
        name="t",
        model=mod.ModelConfig(
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            visual=mod.VisualNetConfig(block_channels=(8, 16),
                                       blocks_per_stage=(2, 1),
                                       stem_channels=8, feature_dim=16),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype="float32"),
        window=mod.WindowConfig(windows_per_clip=2),
        data=mod.DataConfig(synthetic_num_videos=2, synthetic_video_frames=64,
                            image_size=32),
        train=mod.TrainConfig(**base))


def _factory(cfg):
    ds = SyntheticAVDataset(cfg.data, cfg.model.mel)
    seq = WindowSequencer(cfg.window, cfg.model.mel, mel_frames=16)
    return lambda skip: example_stream(ds, seq, cfg.train.batch_size, seed=0,
                                       skip_batches=skip)


def _fit(cfg, ck=None, num_steps=None):
    tr = Trainer(cfg, device="cpu")
    state, _ = tr.fit(_factory(cfg), num_steps=num_steps, log=lambda s: None,
                      checkpointer=ck)
    return tr, state


def test_to_jax_params_inverts_the_converter_on_a_fusion_model():
    """Every leaf of the full-width fusion model, both directions, bitwise."""
    port = M3F(tc.fusion().model, device="cpu")
    sd = port.state_dict()
    params = to_jax_params({n: p for n, p in port.named_parameters()})
    state = to_jax_params(dict(port.named_buffers()))
    back = _convert({**params, **state})
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    jp, js = JM3F(jc.fusion().model).init(jax.random.PRNGKey(0))
    flat = {**_flatten(jax.device_get(jp)), **_flatten(jax.device_get(js))}
    again = to_jax_params(from_jax_params(jax.device_get(jp), jax.device_get(js)))
    assert again.keys() == flat.keys()
    for k, v in flat.items():
        assert np.array_equal(again[k], np.asarray(v)), k


def test_save_restore_is_bitwise_and_resume_equals_uninterrupted(tmp_path):
    cfg = _cfg(tc, checkpoint_dir=str(tmp_path))
    _, whole = _fit(cfg)
    ck = Checkpointer(str(tmp_path / "run"), keep=2, cfg=cfg)
    _fit(cfg, ck, num_steps=2)
    assert ck.all_steps() == [2]
    tr, resumed = _fit(cfg, Checkpointer(str(tmp_path / "run"), keep=2, cfg=cfg))
    assert resumed.step == whole.step == 4
    for group in ("params", "bn_state", "ema"):
        a, b = getattr(whole, group), getattr(resumed, group)
        for n in a:
            assert torch.equal(a[n], b[n]), (group, n)
    # restoring the newest file reproduces the state bitwise
    fresh = Trainer(cfg, device="cpu")
    st = Checkpointer(str(tmp_path / "run"), cfg=cfg).maybe_restore(
        fresh.init_state())
    assert st.step == 4
    for n, p in resumed.params.items():
        assert torch.equal(st.params[n], p)
    for n, m in resumed.opt_state["mu"].items():
        assert torch.equal(st.opt_state["mu"][n], m)
    assert st.opt_state["count"] == resumed.opt_state["count"] == 4


def test_keep_k_prunes_and_corrupt_newest_falls_back(tmp_path):
    cfg = _cfg(tc, checkpoint_every=1)
    ck = Checkpointer(str(tmp_path), keep=2, cfg=cfg)
    _fit(cfg, ck, num_steps=3)
    assert ck.all_steps() == [2, 3]
    with open(ck._path(3), "wb") as f:
        f.write(b"not a zip file")
    st = ck.maybe_restore(Trainer(cfg, device="cpu").init_state())
    assert st.step == 2


def test_config_hash_mismatch_raises(tmp_path):
    cfg = _cfg(tc)
    ck = Checkpointer(str(tmp_path), cfg=cfg)
    _fit(cfg, ck, num_steps=2)
    other = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, optim=dataclasses.replace(cfg.train.optim, optimizer="sgd")))
    with pytest.raises(RuntimeError, match="different config"):
        Checkpointer(str(tmp_path), cfg=other).maybe_restore(
            Trainer(other, device="cpu").init_state())


def test_a_jax_optimizer_state_is_refused(tmp_path):
    """Only when it fits neither layout: a JAX-written TrainState resumes
    (tests/test_torch_resume.py holds every optimizer variant); a file
    tagged with another optimizer layout, and one whose optimizer leaves
    miss a key, are refused by name — never skipped for an older file, nor
    replaced by fresh moments."""
    jcfg, cfg = _cfg(jc), _cfg(tc)
    jt = JTrainer(jcfg)
    src = JCheckpointer(str(tmp_path / "jax"), cfg=jcfg)
    path = src.save(jax.device_get(jt.init_state()))
    st = Checkpointer(str(tmp_path / "jax"), cfg=cfg).maybe_restore(
        Trainer(cfg, device="cpu").init_state())
    assert st.step == 0 and st.opt_state["count"] == 0
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    for name, edit, words in (
            ("tag", lambda d: d.update(__meta__=np.frombuffer(
                b'{"opt_layout": "optax/9"}', np.uint8)), "optax/9"),
            ("key", lambda d: d.pop(".opt_state/1/0/.count"),
             r"missing=\['.opt_state/1/0/.count'\]")):
        d = tmp_path / name
        d.mkdir()
        older = Checkpointer(str(d), cfg=cfg)
        older.save(Trainer(cfg, device="cpu").init_state())
        bad = dict(data, **{".step": np.asarray(5, np.int32)})
        edit(bad)
        np.savez(d / "ckpt_00000005.npz", **bad)
        with pytest.raises(ValueError, match=words):
            older.maybe_restore(Trainer(cfg, device="cpu").init_state())


def test_the_jax_package_serves_a_port_checkpoint(tmp_path):
    """A port-trained checkpoint loads in the reference's
    ``load_model_checkpoint`` (EMA preferred) and in the port's loader, and
    the reference's whole-video eval on it matches the port's."""
    cfg = _cfg(tc)
    tr, state = _fit(cfg, num_steps=2)
    path = Checkpointer(str(tmp_path), cfg=cfg).save(state)
    jcfg = _cfg(jc)
    jt = JTrainer(jcfg)
    jstate = jload(jt.init_state(), path)
    assert int(jstate.step) == 2
    sd, step = read_model_checkpoint(path)
    assert step == 2
    for n, e in state.ema.items():
        assert torch.equal(sd[n], e)
    video = SyntheticAVDataset(cfg.data, cfg.model.mel).load_video("synth_0001")
    with jax.default_matmul_precision("highest"):
        want = jt.evaluate_video(jstate, video)
    got = tr.evaluate_video(state, video)
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([got["ccc_v"], got["ccc_a"]],
                               [want["ccc_v"], want["ccc_a"]], atol=1e-4)


def test_async_write_failure_is_raised_by_wait(tmp_path, monkeypatch):
    cfg = _cfg(tc)
    tr = Trainer(cfg, device="cpu")
    ck = Checkpointer(str(tmp_path), cfg=cfg)
    import m3f_torch.train.checkpoint as mc

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(mc, "save_pytree", broken)
    ck.save_async(tr.init_state())
    with pytest.raises(RuntimeError, match="disk full"):
        ck.wait()


def test_seed_from_save_best_and_sigterm(tmp_path):
    cfg = _cfg(tc)
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state()
    src = Checkpointer(str(tmp_path / "a"), cfg=cfg)
    path = src.save(state)
    best = src.save_best(state, 0.5)
    src.wait()
    assert os.path.exists(best)
    dst = Checkpointer(str(tmp_path / "b"), cfg=cfg)
    dst.seed_from(path)
    assert dst.all_steps() == [0]
    state.step = 7
    previous = signal.getsignal(signal.SIGTERM)
    try:
        dst.install_preemption_handler(lambda: state)
        with pytest.raises(SystemExit) as e:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert e.value.code == 143
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert dst.all_steps() == [0, 7]
