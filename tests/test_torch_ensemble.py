"""The port's checkpoint ensembles (``Trainer.commit_state``,
``predict_ensemble``, ``evaluate_ensemble``, ``load_model_checkpoint``)
against the JAX package's, on the same JAX-written checkpoints, mirroring
tests/test_ensemble.py. Two rigs: the JAX test's tiny audio-only model and a
narrow fusion model (32x32 frames), both in fp32.

- a singleton and a duplicate ensemble equal the single prediction exactly;
- a pair equals the per-frame float64 mean of its members exactly, and the
  reference's ``predict_ensemble`` within ``F32_TOL``;
- ``evaluate_ensemble`` scores the mean track: the reference's keys and
  values within ``F32_TOL``, rows through ``per_video_fn``;
- a video over ``window.eval_max_windows`` takes the chunked path per state;
- one ``_prepare_eval_inputs`` upload per video, whatever k;
- a snapshot state is evaluated with its own params and BN state, not with
  whatever the model holds (the repair of ``_dispatch_eval``);
- ``commit_state(eval_only=True)`` folds in the EMA, drops the optimizer
  state and the shadow and owns its tensors;
- ``load_model_checkpoint(template, path)`` on TrainState and import-layout
  files, and its two refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.data.synthetic import SyntheticAVDataset as JDS
from m3f.pytorch_tpu.train.checkpoint import Checkpointer as JCheckpointer
from m3f.pytorch_tpu.train.checkpoint import save_pytree as jsave
from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import WindowSequencer, example_stream
from m3f_torch.train.checkpoint import load_model_checkpoint
from m3f_torch.train.loop import Trainer, TrainState

F32_TOL = 2e-5      # fp32 compute: order-only differences end to end
KEYS = ("ccc_v", "ccc_a", "ccc_mean", "pooled_ccc_v", "pooled_ccc_a",
        "pooled_ccc_mean", "ccc_select")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(mod, rig, max_windows=512, ema=0.0):
    if rig == "audio_only":
        model = mod.ModelConfig(
            use_audio=True, use_video=False,
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype="float32")
        image = 16
    else:
        model = mod.ModelConfig(
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            visual=mod.VisualNetConfig(block_channels=(8, 16),
                                       blocks_per_stage=(2, 1),
                                       stem_channels=8, feature_dim=16),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype="float32")
        image = 32
    return mod.ExperimentConfig(
        name="ensemble", model=model,
        window=mod.WindowConfig(windows_per_clip=2, eval_stride=8,
                                eval_max_windows=max_windows),
        data=mod.DataConfig(synthetic_num_videos=2, synthetic_video_frames=64,
                            image_size=image),
        train=mod.TrainConfig(batch_size=2, ema_decay=ema, log_every=1,
                              eval_every=0, checkpoint_every=0,
                              mesh=mod.MeshConfig(num_data=1)))


def _jax_file(jstate, directory):
    return JCheckpointer(str(directory), keep=1).save(jax.device_get(jstate))


def _rig(rig, tmp, max_windows=512):
    """(port trainer, JAX trainer, port dataset, JAX dataset, port members
    a and b, JAX states a and b): seeds 0 and 1, through JAX checkpoint
    files."""
    jtr = JTrainer(_cfg(jc, rig, max_windows))
    ja, jb = jtr.init_state(seed=0), jtr.init_state(seed=1)
    tr = Trainer(_cfg(tc, rig, max_windows), device="cpu")
    a, b = (tr.commit_state(load_model_checkpoint(tr.init_state(),
                                                  _jax_file(js, tmp / name)),
                            eval_only=True)
            for name, js in (("a", ja), ("b", jb)))
    cfg = tr.cfg
    return (tr, jtr, SyntheticAVDataset(cfg.data, cfg.model.mel),
            JDS(jtr.cfg.data, jtr.cfg.model.mel), a, b, ja, jb)


@pytest.fixture(scope="module", params=["audio_only", "fusion"])
def rig(request, tmp_path_factory):
    return _rig(request.param, tmp_path_factory.mktemp(request.param))


def test_singleton_and_duplicate_match_single_model(rig):
    tr, _, ds, _, a, _, _, _ = rig
    video = ds.load_video(ds.video_ids()[0])
    single = tr.evaluate_video(a, video)["pred"]
    np.testing.assert_array_equal(tr.predict_ensemble([a], video), single)
    np.testing.assert_array_equal(tr.predict_ensemble([a, a], video), single)


def test_pair_is_the_per_frame_mean_and_the_reference(rig):
    tr, jtr, ds, jds, a, b, ja, jb = rig
    vid = ds.video_ids()[0]
    video = ds.load_video(vid)
    pa = tr.evaluate_video(a, video)["pred"]
    pb = tr.evaluate_video(b, video)["pred"]
    ens = tr.predict_ensemble([a, b], video)
    np.testing.assert_array_equal(
        ens, np.mean([pa, pb], axis=0, dtype=np.float64).astype(np.float32))
    assert not np.array_equal(ens, pa) and not np.array_equal(ens, pb)
    with jax.default_matmul_precision("highest"):
        want = jtr.predict_ensemble([ja, jb], jds.load_video(vid))
    np.testing.assert_allclose(ens, want, rtol=F32_TOL, atol=F32_TOL)


def test_evaluate_ensemble_scores_the_mean_track(rig):
    tr, jtr, ds, jds, a, b, ja, jb = rig
    res = tr.evaluate_ensemble([a, b], ds)
    with jax.default_matmul_precision("highest"):
        want = jtr.evaluate_ensemble([ja, jb], jds)
    assert set(res) == set(want) and res["n_models"] == want["n_models"] == 2
    for k in KEYS:
        assert np.isfinite(res[k]), k
        assert res[k] == pytest.approx(want[k], abs=1e-4), k
    # the mean track is scored, not the members' scores averaged
    ra, rb = tr.evaluate(a, ds), tr.evaluate(b, ds)
    assert res["ccc_mean"] != pytest.approx(
        (ra["ccc_mean"] + rb["ccc_mean"]) / 2, abs=1e-12)


def test_per_video_fn_rows(rig):
    tr, _, ds, _, a, b, _, _ = rig
    rows = []
    tr.evaluate_ensemble([a, b], ds, max_videos=1,
                         per_video_fn=lambda vid, r: rows.append((vid, r)))
    assert [vid for vid, _ in rows] == ds.video_ids()[:1]
    video = ds.load_video(rows[0][0])
    np.testing.assert_array_equal(rows[0][1]["pred"],
                                  tr.predict_ensemble([a, b], video))
    assert rows[0][1]["stats"].shape == (2, 6)


def test_empty_ensemble_and_empty_split_raise(rig):
    tr, _, ds, _, a, _, _, _ = rig

    class Empty:
        def video_ids(self):
            return []
    with pytest.raises(ValueError, match="at least one state"):
        tr.evaluate_ensemble([], ds)
    with pytest.raises(ValueError, match="no videos"):
        tr.evaluate_ensemble([a], Empty())
    with pytest.raises(ValueError, match="at least one state"):
        tr.predict_ensemble([], ds.load_video(ds.video_ids()[0]))


def test_chunked_route_per_state(tmp_path):
    """64 frames at stride 8: 7 windows over a limit of 4, so each state
    takes the chunked path (no shared upload); the pair is still the mean
    of the singles and the reference's."""
    tr, jtr, ds, jds, a, b, ja, jb = _rig("audio_only", tmp_path,
                                          max_windows=4)
    vid = ds.video_ids()[0]
    video = ds.load_video(vid)
    assert tr.eval_buckets(len(video["labels"])) is None
    pa = tr.evaluate_video(a, video)["pred"]
    pb = tr.evaluate_video(b, video)["pred"]
    ens = tr.predict_ensemble([a, b], video)
    np.testing.assert_array_equal(
        ens, np.mean([pa, pb], axis=0, dtype=np.float64).astype(np.float32))
    with jax.default_matmul_precision("highest"):
        want = jtr.predict_ensemble([ja, jb], jds.load_video(vid))
    np.testing.assert_allclose(ens, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("max_windows,uploads", [(512, 2), (4, 0)],
                         ids=["fused", "chunked"])
def test_one_upload_per_video(tmp_path, monkeypatch, max_windows, uploads):
    tr, _, ds, _, a, b, _, _ = _rig("audio_only", tmp_path, max_windows)
    calls = []
    real = tr._prepare_eval_inputs

    def counted(video, starts):
        calls.append(len(video["labels"]))
        return real(video, starts)
    monkeypatch.setattr(tr, "_prepare_eval_inputs", counted)
    tr.evaluate_ensemble([a, b, a], ds)
    assert len(calls) == uploads


def _snapshot(tr):
    """A state of copies of the model's params and buffers, built by hand
    (no EMA): what an ensemble member holds."""
    return TrainState({n: p.detach().clone()
                       for n, p in tr.model.named_parameters()},
                      {n: b.detach().clone()
                       for n, b in tr.model.named_buffers()}, None, 0)


@pytest.mark.parametrize("max_windows", [512, 4], ids=["fused", "chunked"])
def test_a_snapshot_is_evaluated_with_its_own_weights(max_windows):
    """Trained one step (so the BN buffers moved off their init), the
    model's params and buffers copied into a state, then the model
    re-initialised from another seed: the state's prediction is still its
    own, not the new seed's."""
    cfg = _cfg(tc, "audio_only", max_windows)
    tr = Trainer(cfg, device="cpu")
    ds = SyntheticAVDataset(cfg.data, cfg.model.mel)
    seq = WindowSequencer(cfg.window, cfg.model.mel,
                          mel_frames=cfg.model.audio.mel_frames_per_window)
    tr.fit(example_stream(ds, seq, 2, seed=0), num_steps=1, log=lambda s: None)
    video = ds.load_video(ds.video_ids()[0])
    want = tr.evaluate_video(None, video)["pred"]
    snap = _snapshot(tr)
    tr.init_state(seed=1)
    assert not np.array_equal(tr.evaluate_video(None, video)["pred"], want)
    np.testing.assert_array_equal(tr.evaluate_video(snap, video)["pred"], want)
    np.testing.assert_array_equal(tr.predict_ensemble([snap], video), want)


def test_commit_state_eval_only_owns_its_tensors():
    """With EMA on, the member's params are the shadow's values; it has no
    optimizer state and no shadow, and none of its tensors is the model's,
    so re-initialising the model leaves its prediction as it was."""
    cfg = _cfg(tc, "audio_only", ema=0.9)
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state(seed=0)
    with torch.no_grad():
        for e in state.ema.values():
            e.mul_(0.5)
    member = tr.commit_state(state, eval_only=True)
    assert member.opt_state is None and member.ema is None
    assert member.params.keys() == state.ema.keys()
    own = {id(t) for t in list(tr.model.parameters()) + list(tr.model.buffers())}
    for group in (member.params, member.bn_state):
        for n, t in group.items():
            assert id(t) not in own and not t.requires_grad
    for n, e in state.ema.items():
        assert torch.equal(member.params[n], e) and member.params[n] is not e
    ds = SyntheticAVDataset(cfg.data, cfg.model.mel)
    video = ds.load_video(ds.video_ids()[0])
    want = tr.evaluate_video(state, video)["pred"]       # the shadow's
    tr.init_state(seed=3)
    np.testing.assert_array_equal(tr.evaluate_video(member, video)["pred"], want)
    # eval_only=False moves a host state onto the device and keeps the rest
    moved = tr.commit_state(state)
    assert moved.opt_state.keys() == state.opt_state.keys()
    assert moved.ema is not None and moved.step == state.step


def _port_params(tr, jstate):
    from m3f_torch.train.checkpoint import from_jax_params
    return from_jax_params(jax.device_get(jstate.params),
                           jax.device_get(jstate.bn_state))


def test_load_model_checkpoint_trainstate_and_import_layouts(tmp_path):
    cfg_j, cfg_t = _cfg(jc, "fusion", ema=0.9), _cfg(tc, "fusion", ema=0.9)
    jtr = JTrainer(cfg_j)
    js = jax.device_get(jtr.init_state(seed=2))
    js = js._replace(ema=jax.tree_util.tree_map(lambda v: v * 2, js.params),
                     step=np.asarray(5, np.int32))
    full = JCheckpointer(str(tmp_path / "full"), keep=1).save(js)
    imp = str(tmp_path / "import.npz")
    jsave({"params": js.params, "state": js.bn_state}, imp)
    tr = Trainer(cfg_t, device="cpu")
    tpl = tr.init_state(seed=0)
    want = _port_params(tr, js)
    got = load_model_checkpoint(tpl, full)
    assert got.step == 5 and got.opt_state is tpl.opt_state
    for n, t in got.params.items():                  # the EMA shadow, preferred
        assert t.dtype == tpl.params[n].dtype and t.shape == tpl.params[n].shape
        np.testing.assert_array_equal(t.numpy(), 2 * want[n].numpy())
        assert torch.equal(got.ema[n], t) and got.ema[n] is not t
    for n, t in got.bn_state.items():
        np.testing.assert_array_equal(t.numpy(), want[n].numpy())
    got = load_model_checkpoint(tpl, imp)
    assert got.step == tpl.step
    for n, t in {**got.params, **got.bn_state}.items():
        np.testing.assert_array_equal(t.numpy(), want[n].numpy())
    # the template's own tensors are untouched
    assert not torch.equal(tpl.params["head.kernel"],
                           got.params["head.kernel"])


def test_load_model_checkpoint_refusals(tmp_path):
    """A richer checkpoint (a wider GRU stack: leaves the model lacks) and a
    poorer one (a leaf removed) are refused in both layouts, as the
    reference refuses them."""
    cfg = _cfg(jc, "audio_only")
    richer = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, gru=dataclasses.replace(cfg.model.gru, num_layers=2)))
    js = jax.device_get(JTrainer(richer).init_state(seed=0))
    rich_full = JCheckpointer(str(tmp_path / "rich"), keep=1).save(js)
    rich_imp = str(tmp_path / "rich.npz")
    jsave({"params": js.params, "state": js.bn_state}, rich_imp)
    plain = jax.device_get(JTrainer(cfg).init_state(seed=0))
    full = JCheckpointer(str(tmp_path / "plain"), keep=1).save(plain)
    with np.load(full) as z:
        data = {k: z[k] for k in z.files if k != ".params/head/bias"}
    np.savez(tmp_path / "poor.npz", **data)
    jsave({"params": plain.params, "state": plain.bn_state},
          str(tmp_path / "plain.npz"))
    with np.load(tmp_path / "plain.npz") as z:
        data = {k: z[k] for k in z.files if k != "params/head/bias"}
    np.savez(tmp_path / "poor_imp.npz", **data)
    tr = Trainer(_cfg(tc, "audio_only"), device="cpu")
    tpl = tr.init_state()
    jtpl = JTrainer(cfg).init_state()
    from m3f.pytorch_tpu.train.checkpoint import load_model_checkpoint as jload
    for path, match in ((rich_full, "lacks"), (rich_imp, "lacks"),
                        (str(tmp_path / "poor.npz"), "missing"),
                        (str(tmp_path / "poor_imp.npz"), "missing")):
        with pytest.raises(ValueError):
            jload(jtpl, path)
        with pytest.raises(ValueError, match=match):
            load_model_checkpoint(tpl, path)
