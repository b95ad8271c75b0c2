"""Resuming across the two packages: the optimizer state in the layout of the
reference's optax chain (``m3f_torch/train/checkpoint.py``
``_optax_leaves``), both ways, for every optimizer variant of
``make_optimizer``: adam (constant), adam with a cosine schedule (its count
at ``1/1``), adamw with a cosine schedule (``1/2``), sgd under
``MultiSteps`` (``accumulate_steps=2``) with ``lr_scale`` and ``freeze``
masks (``.mini_step``, ``.gradient_step``, ``.acc_grads``,
``.inner_opt_state``), and sgd with the plateau schedule (``.lr_mult``),
all with an EMA shadow.

On the narrow audio model (audio channels [4, 8], GRU hidden 8, fp32), from
the reference's init and 4 seeded batches:

- **JAX writes, the port resumes:** the reference trains 2 steps and saves
  a ``TrainState``; the port's ``Checkpointer`` resumes it. Its optimizer
  state (moments, traces, accumulators, counts) equals the file's leaves,
  mapped by this file's own reading of the layout (conv moments
  transposed as ``_convert`` transposes the kernels), to 1e-6. The port's
  next 2 steps equal the reference's own resumed steps: losses to 1e-5,
  params, BN buffers and EMA to 1e-4 of each leaf's largest element (the
  tolerances tests/test_torch_parallel.py holds this model to).
- **The port writes, JAX resumes:** the port trains 2 steps from the same
  init and saves; the reference's ``Checkpointer.maybe_restore`` resumes
  the file, its optimizer state equals the port's to 1e-6, and the two
  runs' next 2 steps agree as above.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
import torch_dist_worker as worker
from m3f.pytorch_tpu.parallel.mesh import shard_batch
from m3f.pytorch_tpu.train.checkpoint import Checkpointer as JCheckpointer
from m3f.pytorch_tpu.train.checkpoint import _flatten_with_paths
from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
from m3f_torch.train.checkpoint import Checkpointer, from_jax_params
from m3f_torch.train.loop import Trainer

VARIANTS = {
    "adam": dict(),
    "adam_cosine": dict(schedule="cosine", warmup_steps=1),
    "adamw_cosine": dict(schedule="cosine", weight_decay=0.01),
    "sgd_accumulate_masked": dict(optimizer="sgd", accumulate_steps=2,
                                  lr_scale="audio=0.5", freeze="gru"),
    "sgd_plateau": dict(optimizer="sgd", schedule="plateau"),
}
TIGHT = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(mod, optim):
    cfg = worker.audio_cfg(mod, 1)
    return cfg.replace(train=dataclasses.replace(
        cfg.train, num_steps=4,
        optim=dataclasses.replace(cfg.train.optim, learning_rate=1e-3,
                                  **optim)))


def _port_leaves(opt):
    """The port's optimizer state → {optax key: array}, read from the
    layout as this test understands it (independently of the package's
    mapping): adam's count/mu/nu or sgd's trace at ``1/0``, the schedule
    count at ``1/1`` (``1/2`` under adamw), MultiSteps around them."""
    def path(name, t):
        parts = name.split(".")
        v = t.detach().numpy()
        if parts[-1] == "weight" and v.ndim >= 4:
            parts[-1] = "kernel"
            v = np.moveaxis(v, (0, 1), (-1, -2))
        return "/".join(parts), v
    out = {}
    if "mini_step" in opt:
        out[".mini_step"] = opt["mini_step"]
        out[".gradient_step"] = opt["gradient_step"]
        for n, t in opt["acc"].items():
            p, v = path(n, t)
            out[f".acc_grads/{p}"] = v
        inner, pre = opt["inner"], ".inner_opt_state/1/"
    else:
        inner, pre = opt, "1/"
    for g in ("mu", "nu", "trace"):
        for n, t in inner.get(g, {}).items():
            p, v = path(n, t)
            out[f"{pre}0/.{g}/{p}"] = v
    if "mu" in inner:
        out[pre + "0/.count"] = inner["count"]
    return out, inner, pre


def _check_opt(opt, jax_opt_state, optim):
    """The port's optimizer state against the reference's leaves, 1e-6."""
    want, _ = _flatten_with_paths(jax.device_get(jax_opt_state))
    got, inner, pre = _port_leaves(opt)
    if "schedule_count" in inner:
        slot = 2 if optim.get("weight_decay") else 1
        got[f"{pre}{slot}/.count"] = inner["schedule_count"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(v, np.float64), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def _jax_steps(jt, step, state, batches):
    losses = []
    with jax.default_matmul_precision("highest"):
        for b in batches:
            feed = {k: b[k] for k in ("wav", "labels", "mask")}
            state, m = step(state, shard_batch(jt.mesh, feed))
            losses.append(float(m["loss"]))
    return state, losses


def _port_steps(tr, state, batches):
    return [float(tr.train_step(state, b)["loss"]) for b in batches]


def _same_state(port_state, jstate):
    """Params, BN buffers and EMA to 1e-4 of each leaf's largest element."""
    for group in ("params", "bn_state", "ema"):
        tree = jax.device_get(getattr(jstate, group))
        want = (from_jax_params({}, tree) if group == "bn_state"
                else from_jax_params(tree, {}))
        for n, t in getattr(port_state, group).items():
            w = want[n].numpy()
            err = np.abs(t.detach().numpy() - w).max() / max(np.abs(w).max(),
                                                             1e-30)
            assert err < 1e-4, (group, n, err)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def runs(request, tmp_path_factory):
    optim = VARIANTS[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    jcfg, tcfg = _cfg(jc, optim), _cfg(tc, optim)
    batches = worker.global_batches(tcfg, 4, seed=3)
    jt = JTrainer(jcfg)
    step = jt.make_train_step()
    init = jt.init_state()
    weights = from_jax_params(jax.device_get(init.params),
                              jax.device_get(init.bn_state))
    # the reference: 2 steps, saved, then its own resume and 2 more steps
    s2, _ = _jax_steps(jt, step, init, batches[:2])
    JCheckpointer(str(tmp / "jax"), cfg=jcfg).save(s2)
    jres = JCheckpointer(str(tmp / "jax"), cfg=jcfg).maybe_restore(
        jt.init_state())
    jres_opt = jax.device_get(jres.opt_state)
    j4, jlosses = _jax_steps(jt, step, jres, batches[2:])
    # the port resumes the reference's file
    tr = Trainer(tcfg, device="cpu")
    st = Checkpointer(str(tmp / "jax"), cfg=tcfg).maybe_restore(
        tr.init_state(), tr)
    assert st.step == 2
    _check_opt(st.opt_state, jres_opt, optim)
    plosses = _port_steps(tr, st, batches[2:])
    # the port writes after 2 steps from the reference's init; the
    # reference resumes that file
    pw = Trainer(tcfg, device="cpu")
    pw.model.load_state_dict(weights)
    ps = pw.init_state(keep_weights=True)
    _port_steps(pw, ps, batches[:2])
    Checkpointer(str(tmp / "port"), cfg=tcfg).save(ps)
    back = JCheckpointer(str(tmp / "port"), cfg=jcfg).maybe_restore(
        jt.init_state())
    assert int(back.step) == 2
    _check_opt(ps.opt_state, back.opt_state, optim)
    b4, blosses = _jax_steps(jt, step, back, batches[2:])
    p4losses = _port_steps(pw, ps, batches[2:])
    return dict(jlosses=jlosses, plosses=plosses, j4=j4, st=st,
                blosses=blosses, p4losses=p4losses, b4=b4, ps=ps)


def test_the_port_resumes_a_jax_written_state(runs):
    np.testing.assert_allclose(runs["plosses"], runs["jlosses"], rtol=TIGHT)
    _same_state(runs["st"], runs["j4"])


def test_jax_resumes_a_port_written_state(runs):
    np.testing.assert_allclose(runs["blosses"], runs["p4losses"], rtol=TIGHT)
    _same_state(runs["ps"], runs["b4"])
