"""Tensor parallelism of the port over the model axis
(``m3f_torch/parallel/mesh.py``) and its node-major rank layout, on the CPU
with torch's gloo backend over localhost, beside the JAX package's
(tests/test_tensor_parallel.py, tests/test_multislice.py; 8 fake CPU
devices, tests/conftest.py).

Four gloo ranks (``tests/torch_tp_worker.py``, launched once by a module
fixture) on tests/test_tensor_parallel.py's tiny config with an EMA:

- a 2 x 2 mesh trains 3 steps from the JAX init against the JAX
  ``Trainer`` at ``num_data=4, num_model=2`` and against the one-process
  port: losses to rtol 2e-5 / atol 1e-6, params and EMA to rtol 5e-4 /
  atol 5e-5 (the reference's tolerances); every rank's blocks of the
  params, Adam moments and EMA equal the slices of the one-process leaves
  (and have the block shapes); the replicated leaves are bit-equal on all
  four ranks and the blocks within each column of the mesh;
- the eval forward on a 1 x 4 mesh against one process, rtol 1e-5 / atol
  1e-6;
- checkpoints: the 2 x 2 file has the keys and shapes of a one-process
  file and of the JAX package's TP file, and resumes at 1 x 1 with every
  array equal; the JAX package's TP file resumes on the 2 x 2 mesh, which
  writes it back with every array equal; the JAX ``Trainer`` at 4 x 2
  resumes the port's 2 x 2 file with every array equal;
- ``m3f_torch.main train ... train.mesh.num_model=2`` on the four ranks;
- ``create_mesh``'s layouts and refusals over four ranks.

In this process: ``tp_spec`` against the reference's ``_tp_spec`` over
every leaf of the params, the optimizer state and the EMA (the tiny config
at 2 and 4 model ranks, hidden sizes no rank count divides, and
``distributed_train``), and ``order_ranks_for_mesh`` against
``order_devices_for_mesh`` (integers as the devices, the same slice ids):
tests/test_multislice.py's four cases and seeded random layouts, their
refusals in the same words.
"""

import dataclasses
import os
import pickle
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
import torch_tp_worker as worker
from m3f.pytorch_tpu.parallel.mesh import (_tp_spec, order_devices_for_mesh,
                                           shard_batch)
from m3f.pytorch_tpu.train.checkpoint import Checkpointer as JCheckpointer
from m3f.pytorch_tpu.train.checkpoint import _flatten_with_paths
from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
from m3f_torch.models.m3f import M3F
from m3f_torch.parallel.mesh import order_ranks_for_mesh, tp_spec
from m3f_torch.train.checkpoint import (Checkpointer, from_jax_params,
                                        load_meta)
from m3f_torch.train.loop import Trainer

REPO = Path(__file__).resolve().parents[1]
LOSS = dict(rtol=2e-5, atol=1e-6)       # tests/test_tensor_parallel.py's
STATE = dict(rtol=5e-4, atol=5e-5)
EVAL = dict(rtol=1e-5, atol=1e-6)
RANKS = 4
CASES = "mesh,train,eval,resume_jax,cli"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _whole(tree) -> dict:
    """A JAX params / EMA tree → the port's names and layout."""
    return {n: t.numpy() for n, t in
            from_jax_params(jax.device_get(tree), {}).items()}


def _jax_run(jt, state, batches):
    step = jt.make_train_step()
    loss, gnorm = [], []
    with jax.default_matmul_precision("highest"):
        for b in batches:
            state, m = step(state, shard_batch(jt.mesh, dict(b)))
            loss.append(float(m["loss"]))
            gnorm.append(float(m["grad_norm"]))
    return state, np.asarray(loss), np.asarray(gnorm)


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    jcfg = worker.tiny_cfg(jc, 4, 2)
    jt = JTrainer(jcfg)
    init = jt.init_state()
    with open(tmp / "jax_init.pkl", "wb") as f:
        pickle.dump((jax.device_get(init.params),
                     jax.device_get(init.bn_state)), f)
    batches = [worker.make_batch(jcfg, seed=i) for i in range(worker.STEPS)]
    # the reference's TP state after one step, written for the ranks
    s1, l1, g1 = _jax_run(jt, init, batches[:1])
    JCheckpointer(str(tmp / "ck_jax"), cfg=jcfg).save(s1)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_tp_worker.py"),
         str(r), str(RANKS), str(port), str(tmp), CASES], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    try:
        # the reference and the one process run while the ranks do
        s3, l3, g3 = _jax_run(jt, s1, batches[1:])
        one, tr1, st1 = worker.run_train(worker.tiny_cfg(tc, 1, 1), str(tmp))
        Checkpointer(str(tmp / "ck11"), cfg=tr1.cfg).save(st1)
        ev1 = worker.trainer_from_jax(worker.tiny_cfg(tc, 1, 1), str(tmp))
        eval_one = ev1.make_eval_forward()(
            {"wav": worker.make_batch(jcfg, seed=7)["wav"]}).numpy()
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    ranks = {c: [dict(np.load(tmp / f"{c}.rank{r}.npz"))
                 for r in range(RANKS)] for c in CASES.split(",")}
    jax_ref = dict(loss=np.concatenate([l1, l3]),
                   grad_norm=np.concatenate([g1, g3]),
                   params=_whole(s3.params), ema=_whole(s3.ema))
    return dict(tmp=tmp, ranks=ranks, one=one, jax=jax_ref, jcfg=jcfg,
                jt=jt, eval_one=eval_one)


# -- training on a 2 x 2 mesh -------------------------------------------------

def test_a_2x2_mesh_trains_as_one_process_and_as_jax_tp(tp):
    """Losses, gradient norms, params and EMA of the 2 x 2 ranks (gathered
    whole) against the one-process port and the JAX 4 x 2 ``Trainer``."""
    got = tp["ranks"]["train"][0]
    for ref in (tp["one"], tp["jax"]):
        np.testing.assert_allclose(got["loss"], ref["loss"], **LOSS)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   **LOSS)
    for g, jg in (("p", "params"), ("e", "ema")):
        for n, want in tp["jax"][jg].items():
            np.testing.assert_allclose(got[f"full/{g}/{n}"], want, **STATE,
                                       err_msg=n)
            np.testing.assert_allclose(got[f"full/{g}/{n}"],
                                       tp["one"][f"full/{g}/{n}"], **STATE,
                                       err_msg=n)


SHARDED = {"gru.layers.0.fwd.w_ih": 1, "gru.layers.0.fwd.w_hh": 1,
           "gru.layers.0.fwd.b_ih": 0, "gru.layers.0.fwd.b_hh": 0,
           "gru.layers.0.bwd.w_ih": 1, "gru.layers.0.bwd.w_hh": 1,
           "gru.layers.0.bwd.b_ih": 0, "gru.layers.0.bwd.b_hh": 0,
           "head.kernel": 0}


def test_each_rank_holds_only_its_blocks(tp):
    """The sharded leaves are exactly the reference's (BiGRU gates, fusion
    head kernel); each rank holds block ``model rank`` of 2 of each, and of
    its Adam moments and EMA shadow, equal to the slice of the one-process
    leaf."""
    runs = tp["ranks"]["train"]
    assert sorted(runs[0]["tp_dims"].tolist()) == sorted(SHARDED)
    for r, got in enumerate(runs):
        k = r % 2                              # the rank's model index
        for g in ("p", "e", "mu", "nu"):
            for n, dim in SHARDED.items():
                whole = tp["one"][f"full/{g}/{n}"]
                size = whole.shape[dim] // 2
                want = np.take(whole, range(k * size, (k + 1) * size),
                               axis=dim)
                blk = got[f"blk/{g}/{n}"]
                assert blk.shape == want.shape, (g, n, blk.shape)
                np.testing.assert_allclose(blk, want, **STATE,
                                           err_msg=f"rank {r} {g}/{n}")


def test_replicated_leaves_are_bit_equal_and_blocks_equal_down_a_column(tp):
    runs = tp["ranks"]["train"]
    for key in runs[0]:
        if not key.startswith("blk/"):
            continue
        name = key.split("/", 2)[2]
        if name in SHARDED:
            # ranks 0, 2 hold model block 0; ranks 1, 3 block 1
            for a, b in ((0, 2), (1, 3)):
                assert np.array_equal(runs[a][key], runs[b][key]), key
        else:
            for r in range(1, RANKS):
                assert np.array_equal(runs[0][key], runs[r][key]), (r, key)
    for r in range(1, RANKS):
        for k in ("loss", "grad_norm"):
            assert np.array_equal(runs[0][k], runs[r][k]), (r, k)


def test_the_eval_forward_on_a_1x4_mesh_equals_one_process(tp):
    for r in range(RANKS):
        np.testing.assert_allclose(tp["ranks"]["eval"][r]["pred"],
                                   tp["eval_one"], **EVAL)


# -- checkpoints ---------------------------------------------------------------

def test_a_2x2_file_has_the_layout_of_one_process_and_of_jax(tp):
    tmp = tp["tmp"]
    files = {name: _npz(Checkpointer(str(tmp / d)).latest_path())
             for name, d in (("2x2", "ck22"), ("1x1", "ck11"),
                             ("jax_tp", "ck_jax"))}
    shapes = {n: {k: v.shape for k, v in f.items()} for n, f in files.items()}
    assert shapes["2x2"] == shapes["1x1"] == shapes["jax_tp"]
    for d in ("ck22", "ck11"):
        assert load_meta(Checkpointer(str(tmp / d)).latest_path())[
            "opt_layout"] == "optax"


def test_a_2x2_checkpoint_resumes_at_world_size_1(tp):
    """The 2 x 2 file resumed by one process holds every array the ranks
    held, gathered whole, bit for bit; written again, the same file."""
    tmp = tp["tmp"]
    cfg = worker.tiny_cfg(tc, 1, 1)
    tr = Trainer(cfg, device="cpu")
    state = Checkpointer(str(tmp / "ck22"), cfg=cfg).maybe_restore(
        tr.init_state(), tr)
    assert state.step == worker.STEPS
    got = worker.dump_state(state)
    want = tp["ranks"]["train"][0]
    for k, v in got.items():
        if k.startswith("full/"):
            assert np.array_equal(v, want[k]), k
    Checkpointer(str(tmp / "ck22_at_1"), cfg=cfg).save(state)
    a = _npz(Checkpointer(str(tmp / "ck22")).latest_path())
    b = _npz(Checkpointer(str(tmp / "ck22_at_1")).latest_path())
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_a_jax_tp_checkpoint_resumes_on_a_2x2_mesh(tp):
    """The JAX 4 x 2 file resumed on 2 x 2: each rank holds its blocks of
    the file's arrays, and the file it writes back equals the JAX file,
    every array."""
    tmp = tp["tmp"]
    jfile = _npz(JCheckpointer(str(tmp / "ck_jax")).latest_path())
    back = _npz(Checkpointer(str(tmp / "ck22_from_jax")).latest_path())
    assert jfile.keys() == back.keys()
    for k in jfile:
        assert np.array_equal(np.asarray(jfile[k]), back[k]), k
    for r, got in enumerate(tp["ranks"]["resume_jax"]):
        assert int(got["step"]) == 1
        k = r % 2
        for n, dim in SHARDED.items():
            whole = got[f"full/p/{n}"]
            size = whole.shape[dim] // 2
            assert np.array_equal(
                got[f"blk/p/{n}"],
                np.take(whole, range(k * size, (k + 1) * size), axis=dim)), n


def test_jax_tp_resumes_a_2x2_checkpoint(tp):
    """The JAX ``Trainer`` at 4 x 2 resumes the port's 2 x 2 file: every
    array of its state equals the file's, the TP leaves sharded."""
    from jax.sharding import PartitionSpec as P
    tmp, jt = tp["tmp"], tp["jt"]
    path = Checkpointer(str(tmp / "ck22")).latest_path()
    state = JCheckpointer(str(tmp / "ck22"), cfg=tp["jcfg"]).maybe_restore(
        jt.init_state(), jt)
    assert int(state.step) == worker.STEPS
    w = state.params["gru"]["layers"][0]["fwd"]["w_ih"]
    assert w.sharding.spec == P(None, "model")
    want = _npz(path)
    got = _flatten_with_paths(jax.device_get(state))[0]
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert np.array_equal(v, want[k]), k


# -- the command line and the mesh ---------------------------------------------

def test_the_cli_trains_with_num_model_2(tp):
    """``main train`` with ``train.mesh.num_model=2`` ran to its end on the
    four ranks, wrote the checkpoints of its cadence, and one process
    resumes them."""
    for got in tp["ranks"]["cli"]:
        assert int(got["rc"]) == 0
    ck = Checkpointer(str(tp["tmp"] / "cli_ckpt"))
    assert ck.all_steps() == [1, 2]
    from m3f_torch.main import build_config
    cfg = build_config("audio_only", [
        "model.audio.channels=[4,8]", "model.audio.feature_dim=8",
        "model.gru.hidden_size=8", "train.batch_size=4"])
    tr = Trainer(cfg, device="cpu")
    state = ck.maybe_restore(tr.init_state(), tr)
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.params.values())


def test_create_mesh_over_four_ranks(tp):
    """Rows are model groups and columns data groups: rank r at (r // m,
    r % m); with interleaved nodes every row lies on one node and the
    columns keep the data axis' order in ``gather_rows``; a world of
    another shape is refused in the reference's words."""
    for r, got in enumerate(tp["ranks"]["mesh"]):
        # [data size, data rank, model size, model rank, data ranks..., model ranks...]
        assert got["2x2"].tolist() == [2, r // 2, 2, r % 2,
                                       r % 2, r % 2 + 2,
                                       r // 2 * 2, r // 2 * 2 + 1]
        assert got["-1x2"].tolist() == got["2x2"].tolist()
        assert got["1x4"].tolist() == [1, 0, 4, r, r, 0, 1, 2, 3]
        assert got["4x1"].tolist() == [4, r, 1, 0, 0, 1, 2, 3, r]
        # nodes [1, 0, 1, 0]: node 0 holds ranks 1, 3, node 1 ranks 0, 2
        assert got["nodes_layout"].tolist() == [[1, 3], [0, 2]]
        col = [1, 0] if r in (1, 0) else [3, 2]
        assert got["nodes_axes"].tolist() == [
            col.index(r), [1, 3, 0, 2].index(r) % 2] + col + (
                [1, 3] if r in (1, 3) else [0, 2])
        assert got["nodes_gather_rows"].tolist() == col
        refusals = got["refusals"].tolist()
        assert re.search(r"mesh 3x2 needs 6 devices, have 4", refusals[0])
        assert re.search(r"mesh 1x2 leaves 2 of the 4", refusals[1])
        assert re.search(r"mesh -1x3 needs a multiple of 3", refusals[2])
        assert re.search(r"mesh 2x4 needs 8 devices, have 4", refusals[3])


# -- which leaves are sharded ---------------------------------------------------

def _keys(path) -> list:
    return [str(getattr(e, "key", getattr(e, "name", getattr(e, "idx", None))))
            for e in path]


def _port_name(keys, ndim) -> str:
    if keys[-1] == "kernel" and ndim >= 4:
        keys = keys[:-1] + ["weight"]
    return ".".join(keys)


def _hidden(mod, n_data, n_model, hidden):
    cfg = worker.tiny_cfg(mod, n_data, n_model)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, gru=mod.GRUConfig(hidden_size=hidden)))


def _distributed_train(mod):
    cfg = mod.distributed_train()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, ema_decay=0.999,
        mesh=mod.MeshConfig(num_data=4, num_model=2)))


SPEC_CASES = {
    "tiny_tp2": (lambda m: worker.tiny_cfg(m, 4, 2), 2),
    "tiny_tp4": (lambda m: worker.tiny_cfg(m, 2, 4), 4),
    # 3H = 15: the gates stay whole, the head's 10 rows split
    "hidden5_tp2": (lambda m: _hidden(m, 4, 2, 5), 2),
    # 3H = 18 does not divide over 4; the head's 12 rows do
    "hidden6_tp4": (lambda m: _hidden(m, 2, 4, 6), 4),
    "distributed_train": (_distributed_train, 2),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_tp_spec_matches_the_reference_on_every_leaf(case):
    """Every leaf of the JAX state's params, optimizer state and EMA
    (shapes only) against ``tp_spec`` of the port's leaf of the same
    parameter: the same partition; leaves outside a parameter's subtree
    (counts) are replicated on both sides."""
    make, n = SPEC_CASES[case]
    jt = JTrainer(make(jc))

    def init(key):
        params, _ = jt.model.init(key)
        return {"params": params, "opt_state": jt.tx.init(params),
                "ema": params}
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    port = {n_: tuple(p.shape) for n_, p in M3F(
        make(tc).model, device="cpu").named_parameters()}
    seen = sharded = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = _keys(path)
        want = tuple(_tp_spec(path[1:], leaf, n))
        group = next((i for i, k in enumerate(keys)
                      if k in ("params", "ema", "mu", "nu", "trace")), None)
        if group is None:
            assert want == (), keys
            continue
        name = _port_name(keys[group + 1:], len(leaf.shape))
        assert name in port, (keys, name)
        assert tp_spec(name, port[name], n) == want, (keys, want)
        seen += 1
        sharded += want != ()
    assert seen >= 3 * len(port) and sharded >= 1


# -- the node-major rank layout -------------------------------------------------

def _layouts(slice_ids, num_data, num_model):
    """(the reference's device ids, or its error; the port's ranks, or
    its error) for devices 0..n-1 on ``slice_ids``."""
    def run(fn):
        try:
            return np.asarray(fn(), dtype=np.int64).tolist()
        except ValueError as e:
            return str(e)
    want = run(lambda: order_devices_for_mesh(
        list(range(len(slice_ids))), num_data, num_model, slice_ids))
    got = run(lambda: order_ranks_for_mesh(slice_ids, num_data, num_model))
    return want, got


# the reference's refusals and the port's: the same words for the same
# numbers (a slice is a node, devices are ranks, DCN are inter-node links)
REFUSALS = [r"mesh (\d+)x(\d+) needs (\d+) devices, have (\d+)",
            r"mesh (\d+)x(\d+) needs (\d+) rows, \w+ provide (\d+)",
            r"\w+ (\d+) has (\d+) \w+, not a multiple of num_model=(\d+) — a "
            r"tensor-parallel group would cross"]


def _same(want, got):
    if isinstance(want, list):
        assert got == want
        return
    assert isinstance(got, str), (want, got)
    for pat in REFUSALS:
        w, g = re.search(pat, want), re.search(pat, got)
        if w or g:
            assert w and g and w.groups() == g.groups(), (want, got)
            return
    raise AssertionError(f"unmatched refusal {want!r} / {got!r}")


@pytest.mark.parametrize("slice_ids,num_data,num_model", [
    ([0] * 8, 4, 2),                 # one slice: the plain reshape
    ([0, 1] * 4, 4, 2),              # interleaved: regrouped, slice-major
    ([0] * 3 + [1] * 5, 4, 2),       # a row would cross slices
    ([0] * 2 + [1] * 2, 4, 2),       # too few rows
    ([0] * 4, 4, 2)])                # too few devices
def test_order_ranks_for_mesh_as_the_reference(slice_ids, num_data,
                                               num_model):
    _same(*_layouts(slice_ids, num_data, num_model))


def test_order_ranks_for_mesh_on_random_layouts():
    rng = np.random.RandomState(11)
    for _ in range(40):
        n_nodes = rng.randint(1, 4)
        num_model = int(rng.choice([1, 2, 4]))
        per = rng.randint(1, 3, size=n_nodes) * num_model
        if rng.rand() < 0.2:
            per[0] += 1                               # a row across nodes
        ids = np.repeat(np.arange(n_nodes), per)
        rng.shuffle(ids)
        num_data = rng.randint(1, len(ids) // num_model + 2)
        _same(*_layouts(ids.tolist(), num_data, num_model))
