"""The port's training path (m3f_torch/train/loop.py and the models' train
mode) against the JAX package, on one set of weights (``from_jax_params``)
and numpy inputs from seeds, at narrow widths in fp32:

- one fused BasicBlock in train mode: output, new BN state and gradients vs
  both of the reference's conv backends (1e-4, what the reference's own
  test holds its two backends to);
- two-pass BatchNorm (``visual.bn_two_pass``) in train mode: the port routes
  it through the plain composition, as the reference does;
- ``Trainer.fit`` for 3 steps vs the reference's ``Trainer.fit`` on the same
  stream: loss history, step-1 metrics, BN state, params and the EMA.
  Step 1 starts from the same weights and is held tight (1e-5). Later steps
  are held to what fp32 rounding allows in a random-init R(2+1)D training on
  batch statistics: a 1e-6 relative change of one stem weight moves the
  port's own gradients by up to 5% of a leaf's largest element at these
  widths (measured), so the steps after the first are held in L2 against
  the size of the move (1/4);
- a second ``fit`` on one ``Trainer`` starts over from ``train.seed``, as
  the reference's does (same history and params, bit for bit); with
  ``keep_weights=True`` it goes on from the weights in ``Trainer.model``;
- whole-video eval and ``evaluate`` (both CCC conventions) vs the
  reference's;
- the guards: the features of ``fit`` that were once refused run now
  (``train.debug_nans`` last; tests/test_torch_cli.py holds its raise
  against the reference's).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.data.synthetic import SyntheticAVDataset as JDS
from m3f.pytorch_tpu.data.windowing import WindowSequencer as JSeq
from m3f.pytorch_tpu.data.windowing import example_stream as jstream
from m3f.pytorch_tpu.models.r2plus1d import BasicBlock as JBlock
from m3f.pytorch_tpu.models.r2plus1d import R2Plus1D as JR2
from m3f.pytorch_tpu.train.loop import BestTracker as JBest
from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import WindowSequencer, example_stream
from m3f_torch.models.r2plus1d import BasicBlock, R2Plus1D
from m3f_torch.train.checkpoint import from_jax_params
from m3f_torch.train.loop import BestTracker, Trainer

TIGHT = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _load(module, params, state):
    module.load_state_dict(from_jax_params(jax.device_get(params),
                                           jax.device_get(state)))
    return module


def _cfg(mod, optim=None, **train):
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
        train=mod.TrainConfig(batch_size=2, num_steps=3, log_every=1,
                              eval_every=0, checkpoint_every=0,
                              optim=mod.OptimConfig(**(optim or {})),
                              mesh=mod.MeshConfig(num_data=1), **train))


def _streams(jcfg, tcfg, seed=0):
    jds, tds = JDS(jcfg.data, jcfg.model.mel), SyntheticAVDataset(tcfg.data,
                                                                  tcfg.model.mel)
    jseq = JSeq(jcfg.window, jcfg.model.mel, mel_frames=16)
    tseq = WindowSequencer(tcfg.window, tcfg.model.mel, mel_frames=16)
    return (jstream(jds, jseq, jcfg.train.batch_size, seed=seed),
            example_stream(tds, tseq, tcfg.train.batch_size, seed=seed),
            jds, tds)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("backend", ["xla", "pallas_fused"])
def test_fused_block_train_matches_both_jax_backends(backend):
    jb = JBlock(8, 8)
    params, state = jb.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 8, 8, 8).astype(np.float32)
    k = rng.randn(2, 4, 8, 8, 8).astype(np.float32)

    def loss(p, xx):
        if backend == "xla":
            y, ns = jb.apply(p, state, xx, True)
        else:
            y, ns = jb.apply_fused(p, state, xx, True)
        return jnp.sum(y * k), (y, ns)

    with pltpu.force_tpu_interpret_mode():
        (_, (y, ns)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    blk = _load(BasicBlock(8, 8, torch.Generator().manual_seed(0)), params, state)
    xt = torch.from_numpy(x).requires_grad_()
    yt = blk.forward_fused(xt, train=True)
    (yt * torch.from_numpy(k)).sum().backward()
    assert _rel(yt.detach().numpy(), np.asarray(y)) < 1e-4
    want_bn = from_jax_params({}, jax.device_get(ns))
    for n, b in blk.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_bn[n].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    want_g = from_jax_params(jax.device_get(gp), {})
    for n, p in blk.named_parameters():
        assert _rel(p.grad.numpy(), want_g[n].numpy()) < 1e-4, n
    assert _rel(xt.grad.numpy(), np.asarray(gx)) < 1e-4


def test_two_pass_batchnorm_trains_like_the_reference(monkeypatch):
    """bn_two_pass: every BatchNorm is two-pass and no block takes the
    fused units (their statistics are one-pass sums); the train forward and
    its new BN state match the reference's."""
    import m3f_torch.models.r2plus1d as mr
    calls = []
    monkeypatch.setattr(mr, "conv_unit", lambda *a, **k: calls.append(1))
    vis = lambda mod: mod.VisualNetConfig(block_channels=(8, 16),
                                          blocks_per_stage=(2, 1),
                                          stem_channels=8, feature_dim=16,
                                          bn_two_pass=True)
    params, state = JR2(vis(jc)).init(jax.random.PRNGKey(2))
    port = _load(R2Plus1D(vis(tc), torch.Generator().manual_seed(0)), params,
                 state)
    assert all(m.two_pass for m in port.modules() if hasattr(m, "two_pass"))
    clips = (np.random.RandomState(1).rand(2, 8, 16, 16, 3) * 4 + 1
             ).astype(np.float32)
    got = port(torch.from_numpy(clips), per_frame=True, train=True)
    want, ns = JR2(vis(jc)).apply(params, state, jnp.asarray(clips),
                                  train=True, per_frame=True)
    assert not calls
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    want_bn = from_jax_params({}, jax.device_get(ns))
    for n, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_bn[n].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


@pytest.fixture(scope="module")
def fitted():
    """The reference's fit and the port's, 3 steps, same stream and weights
    (Adam at the default 1e-4, EMA 0.9 with its ramp)."""
    jcfg, tcfg = _cfg(jc, ema_decay=0.9), _cfg(tc, ema_decay=0.9)
    js, ts, jds, tds = _streams(jcfg, tcfg)
    jt = JTrainer(jcfg)
    with jax.default_matmul_precision("highest"):
        jstate, jhist = jt.fit(js, log=lambda s: None)
    p0, s0 = jt.model.init(jax.random.PRNGKey(0))
    pt = Trainer(tcfg, device="cpu")
    _load(pt.model, p0, s0)
    # the first step's metrics, from the same weights and the same batch
    first = next(_streams(jcfg, tcfg)[1])
    probe = Trainer(tcfg, device="cpu")
    _load(probe.model, p0, s0)
    metrics = probe.train_step(probe.init_state(keep_weights=True), first)
    jstep = jt.make_train_step()
    with jax.default_matmul_precision("highest"):
        _, jmetrics = jstep(jt.init_state(), next(_streams(jcfg, tcfg)[0]))
    tstate, thist = pt.fit(ts, log=lambda s: None, keep_weights=True)
    return dict(jt=jt, jstate=jstate, jhist=jhist, pt=pt, tstate=tstate,
                thist=thist, p0=from_jax_params(jax.device_get(p0), {}),
                metrics=metrics, jmetrics=jmetrics, jds=jds, tds=tds)


def test_fit_loss_history_and_first_step_metrics(fitted):
    jl, tl = fitted["jhist"]["loss"], fitted["thist"]["loss"]
    assert len(jl) == len(tl) == 3
    np.testing.assert_allclose(tl[0], jl[0], rtol=TIGHT)
    # later steps: the weights have moved by a noise-sensitive amount
    np.testing.assert_allclose(tl[1:], jl[1:], atol=1e-2)
    # loss and batch CCC are forward values (tight); the gradient norm sums
    # the noise-sensitive visual gradients (measured 0.2% apart)
    for k, tol in (("loss", TIGHT), ("batch_ccc", 1e-4), ("grad_norm", 1e-2)):
        np.testing.assert_allclose(float(fitted["metrics"][k]),
                                   float(fitted["jmetrics"][k]), rtol=tol,
                                   err_msg=k)


def test_fit_params_bn_state_and_ema(fitted):
    js, ts = fitted["jstate"], fitted["tstate"]
    assert ts.step == int(js.step) == 3
    want = from_jax_params(jax.device_get(js.params), {})
    p0 = fitted["p0"]
    diff = torch.cat([(ts.params[n].detach() - want[n]).flatten() for n in want])
    move = torch.cat([(want[n] - p0[n]).flatten() for n in want])
    assert diff.norm() <= 0.25 * move.norm()
    ema = from_jax_params(jax.device_get(js.ema), {})
    ediff = torch.cat([(ts.ema[n] - ema[n]).flatten() for n in ema])
    emove = torch.cat([(ema[n] - p0[n]).flatten() for n in ema])
    assert ediff.norm() <= 0.25 * emove.norm()
    bn = from_jax_params({}, jax.device_get(js.bn_state))
    for n, b in ts.bn_state.items():
        np.testing.assert_allclose(b.numpy(), bn[n].numpy(), rtol=1e-2,
                                   atol=1e-3, err_msg=n)


def _fit_params(state):
    return {n: p.detach().clone() for n, p in state.params.items()}


def test_second_fit_starts_from_the_seed_as_the_reference_does(fitted):
    """Two fits on one port Trainer: the same loss history, params, BN
    state and EMA, bit for bit, equal to a fresh Trainer's; and the second
    matches the reference's second fit on one Trainer, which starts from
    the same weights (the reference's seeded init, loaded once more), at
    the tolerances the first fit is held to."""
    jcfg, tcfg = _cfg(jc, ema_decay=0.9), _cfg(tc, ema_decay=0.9)
    tr = Trainer(tcfg, device="cpu")
    held = dict(tr.model.named_parameters())
    runs = []
    for _ in range(2):
        state, hist = tr.fit(_streams(jcfg, tcfg)[1], log=lambda s: None)
        runs.append((hist, _fit_params(state),
                     {n: b.clone() for n, b in state.bn_state.items()},
                     {n: e.clone() for n, e in state.ema.items()}))
        assert all(state.params[n] is p for n, p in held.items())
    fresh = Trainer(tcfg, device="cpu")
    fstate, fhist = fresh.fit(_streams(jcfg, tcfg)[1], log=lambda s: None)
    runs.append((fhist, _fit_params(fstate), dict(fstate.bn_state),
                 dict(fstate.ema)))
    for hist, params, bn, ema in runs[1:]:
        assert hist == runs[0][0]
        for got, want in ((params, runs[0][1]), (bn, runs[0][2]),
                          (ema, runs[0][3])):
            assert got.keys() == want.keys()
            for n in want:
                assert torch.equal(got[n], want[n]), n
    # the reference's second fit on one Trainer, against the port's second
    # fit from the reference's init
    jt, pt = fitted["jt"], Trainer(tcfg, device="cpu")
    with jax.default_matmul_precision("highest"):
        jstate, jhist = jt.fit(_streams(jcfg, tcfg)[0], log=lambda s: None)
    assert jhist["loss"] == fitted["jhist"]["loss"]
    p0, s0 = jt.model.init(jax.random.PRNGKey(0))
    pt.fit(_streams(jcfg, tcfg)[1], num_steps=1, log=lambda s: None)
    _load(pt.model, p0, s0)
    tstate, thist = pt.fit(_streams(jcfg, tcfg)[1], log=lambda s: None,
                           keep_weights=True)
    np.testing.assert_allclose(thist["loss"][0], jhist["loss"][0], rtol=TIGHT)
    np.testing.assert_allclose(thist["loss"][1:], jhist["loss"][1:], atol=1e-2)
    want = from_jax_params(jax.device_get(jstate.params), {})
    diff = torch.cat([(tstate.params[n].detach() - want[n]).flatten()
                      for n in want])
    move = torch.cat([(want[n] - fitted["p0"][n]).flatten() for n in want])
    assert diff.norm() <= 0.25 * move.norm()


def test_fit_with_keep_weights_goes_on_from_the_loaded_weights():
    tcfg = _cfg(tc)
    tr = Trainer(tcfg, device="cpu")
    state, first = tr.fit(_one_batch(tcfg), num_steps=2, log=lambda s: None)
    after = _fit_params(state)
    bn = {n: b.clone() for n, b in state.bn_state.items()}
    kept = tr.init_state(keep_weights=True)
    assert kept.step == 0
    for n, p in after.items():
        assert torch.equal(kept.params[n], p), n
    for n, b in bn.items():
        assert torch.equal(kept.bn_state[n], b), n
    _, second = tr.fit(_one_batch(tcfg), num_steps=2, log=lambda s: None,
                       keep_weights=True)
    assert second["loss"] != first["loss"]
    _, third = tr.fit(_one_batch(tcfg), num_steps=2, log=lambda s: None)
    assert third == first
    # another seed gives another init, the default the configured one
    a = _fit_params(tr.init_state(seed=5))
    b = _fit_params(tr.init_state())
    assert any(not torch.equal(a[n], b[n]) for n in a)
    fresh = dict(Trainer(tcfg, device="cpu").model.named_parameters())
    for n, p in b.items():
        assert torch.equal(p, fresh[n]), n


def test_evaluate_matches_the_reference(fitted):
    """Whole-video eval of the fitted states (EMA weights): per-video and
    pooled CCC, fused and chunked."""
    jt, pt = fitted["jt"], fitted["pt"]
    jstate, tstate = fitted["jstate"], fitted["tstate"]
    # the same weights on both sides: the reference's EMA shadow and BN
    # state carried into the port's state
    port_w = from_jax_params(jax.device_get(jstate.ema), {})
    for n in tstate.ema:
        tstate.ema[n].copy_(port_w[n])
    for n, b in from_jax_params({}, jax.device_get(jstate.bn_state)).items():
        tstate.bn_state[n].copy_(b)
    with jax.default_matmul_precision("highest"):
        want = jt.evaluate(jstate, fitted["jds"])
    got = pt.evaluate(tstate, fitted["tds"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    video = fitted["tds"].load_video("synth_0000")
    r = pt.evaluate_video(tstate, video)
    assert set(r) == {"pred", "ccc_v", "ccc_a", "stats"}
    chunked = Trainer(dataclasses.replace(
        pt.cfg, window=dataclasses.replace(pt.cfg.window, eval_max_windows=4)),
        device="cpu")
    chunked.model.load_state_dict(pt.model.state_dict())
    rc = chunked.evaluate_video(tstate, video)
    np.testing.assert_allclose(rc["pred"], r["pred"], atol=1e-5)
    np.testing.assert_allclose([rc["ccc_v"], rc["ccc_a"]],
                               [r["ccc_v"], r["ccc_a"]], atol=1e-4)


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_evaluate_pipeline_equals_serial(fitted, pipeline):
    """``evaluate(..., pipeline=)`` and ``evaluate_stream``: every video's
    result bit for bit ``evaluate_video``'s, in input order, the input
    generator pulled at most ``pipeline`` videos ahead; the metrics those of
    the serial loop."""
    pt, tstate, tds = fitted["pt"], fitted["tstate"], fitted["tds"]
    ids = tds.video_ids()
    serial = {vid: pt.evaluate_video(tstate, tds.load_video(vid))
              for vid in ids}
    seen = []
    got = pt.evaluate(tstate, tds, pipeline=pipeline,
                      per_video_fn=lambda vid, r: seen.append((vid, r)))
    assert [vid for vid, _ in seen] == list(ids)
    for vid, r in seen:
        np.testing.assert_array_equal(r["pred"], serial[vid]["pred"])
        np.testing.assert_array_equal(r["stats"], serial[vid]["stats"])
        assert (r["ccc_v"], r["ccc_a"]) == (serial[vid]["ccc_v"],
                                            serial[vid]["ccc_a"])
    assert got == pt._aggregate_eval(serial.items())
    pulled = []

    def videos():
        for vid in ids:
            pulled.append(vid)
            yield vid, tds.load_video(vid)
    for k, (vid, _) in enumerate(pt.evaluate_stream(tstate, videos(),
                                                    pipeline=pipeline)):
        assert vid == ids[k] and len(pulled) <= k + pipeline


def test_best_tracker_matches_the_reference():
    seq = [0.1, 0.3, 0.29, 0.31, 0.2, 0.2, 0.2]
    a, b = BestTracker(2, 0.005), JBest(2, 0.005)
    for i, m in enumerate(seq):
        assert a.update(m, i) == b.update(m, i)
    assert (a.best, a.best_step, a.bad_evals) == (b.best, b.best_step, b.bad_evals)


def _one_batch(cfg):
    ds = SyntheticAVDataset(cfg.data, cfg.model.mel)
    seq = WindowSequencer(cfg.window, cfg.model.mel, mel_frames=16)
    return example_stream(ds, seq, cfg.train.batch_size, seed=0)


@pytest.mark.parametrize("what", ["dropout", "augment", "init_from",
                                  "profile_dir", "debug_nans", "metric_writer"])
def test_unported_features_raise(what, tmp_path):
    """Every feature of ``fit`` that was once refused runs: ``profile_dir``
    traces the third step of a 3-step fit (tests/test_torch_profiling.py
    holds the window); dropout, augmentation, ``init_from`` (a whole-model
    file), ``debug_nans`` (on finite data) and a metric writer train a step
    with a finite loss (tests/test_torch_dropout_augment.py,
    test_torch_init_from.py, test_torch_logging.py and test_torch_cli.py
    hold them against the reference)."""
    from m3f_torch.train.checkpoint import save_pytree, to_jax_params
    from m3f_torch.utils.logging import MetricWriter
    cfg = _cfg(tc)
    if what == "dropout":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                 dropout=0.1))
    elif what == "augment":
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                augment=True))
    elif what == "init_from":
        src = Trainer(_cfg(tc, seed=1), device="cpu").model
        leaves = {f"params/{k}": v for k, v in to_jax_params(
            dict(src.named_parameters())).items()}
        leaves.update({f"state/{k}": v for k, v in to_jax_params(
            dict(src.named_buffers())).items()})
        path = str(tmp_path / "weights.npz")
        save_pytree(leaves, path, {"kind": "m3f"})
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, init_from=path))
    elif what in ("profile_dir", "debug_nans"):
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, **{what: str(tmp_path) if what == "profile_dir"
                          else True}))
    tr = Trainer(cfg, device="cpu")
    if what == "profile_dir":
        tr.fit(_one_batch(cfg), log=lambda s: None)
        assert len(list(tmp_path.glob("*.pt.trace.json.gz"))) == 1
        return
    writer = (MetricWriter(str(tmp_path / "m"), tensorboard=False)
              if what == "metric_writer" else None)
    _, hist = tr.fit(_one_batch(cfg), num_steps=1, log=lambda s: None,
                     metric_writer=writer)
    assert np.isfinite(hist["loss"]).all()
    if writer is not None:
        writer.close()
        assert (tmp_path / "m" / "train.jsonl").read_text().count("\n") == 1


@pytest.mark.parametrize("field,value", [("ema_decay", 1.0),
                                         ("eval_ccc_convention", "median")])
def test_trainer_refuses_bad_train_config(field, value):
    cfg = _cfg(tc)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **{field: value}))
    with pytest.raises(ValueError, match=field):
        Trainer(cfg, device="cpu")
