"""The sequence-parallel BiGRU of the port (``m3f_torch/parallel/seqpar.py``
``gru_seq_parallel`` / ``bigru_seq_parallel``) and the GRU recurrence's
carried state (``m3f_torch/ops/gru.py``: ``h0``, the final carry,
``gru_bptt``'s ``dh0``), beside the JAX package's
(tests/test_seqpar.py; 8 fake CPU devices, tests/conftest.py).

Four gloo ranks (``tests/torch_tp_worker.py``, launched once by a module
fixture) split tests/test_seqpar.py's sequences over their data axis, each
scanning its chunk once from the fp32 carry the rank before it sends:

- ``gru_seq_parallel`` forward and reverse against the JAX
  ``gru_seq_parallel`` on a 4-device mesh and the JAX ``GRU`` (1e-5, the
  reference's tolerance) and against the port's unsharded scan;
- ``bigru_seq_parallel`` in fp32 against the JAX ``bigru_seq_parallel``
  and the port's ``BiGRU`` (rtol 1e-4 / atol 1e-5), and in bf16 bit-equal
  to the port's ``BiGRU`` (atol 0, as the reference holds its own);
- its gradients (the input's and every weight's) against ``jax.grad`` of
  the JAX ``bigru_seq_parallel`` and against the port's ``BiGRU``.

In this process: the plain recurrence with ``h0`` (zeros give today's
bits; a lane split into two chunks chained by the fp32 carry gives one
scan's bits, and so does its gradient through ``gru_bptt``'s ``dh0``).
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker as worker
from m3f.pytorch_tpu.models.gru import GRU as JGRU
from m3f.pytorch_tpu.models.gru import BiGRU as JBiGRU
from m3f.pytorch_tpu.parallel.mesh import create_mesh as jmesh
from m3f.pytorch_tpu.parallel.seqpar import (bigru_seq_parallel as
                                             jbigru_seq_parallel,
                                             gru_seq_parallel as
                                             jgru_seq_parallel)
from m3f_torch.ops.gru import gru_bptt, gru_scan, gru_scan_reference
from m3f_torch.parallel.mesh import DataAxis
from m3f_torch.parallel.seqpar import gru_seq_parallel

REPO = Path(__file__).resolve().parents[1]
RANKS = 4
# gradients of the fp32 BiGRU over four ranks, to each leaf's largest
# element: measured 2.2e-7 at most against jax.grad of the reference's
# bigru_seq_parallel, 3.0e-7 against autograd through the port's BiGRU
GRAD_REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), tree)


def _inputs():
    """tests/test_seqpar.py's inputs: a GRU (D 6, H 5) on [2, 24, 6], a
    BiGRU (6, 4) on [2, 16, 6] with a cotangent, a bf16 BiGRU (12, 8) on
    [2, 32, 12]."""
    rng = np.random.RandomState(0)
    gru = JGRU(worker.SEQ_D, worker.SEQ_H).init(jax.random.PRNGKey(1))
    gru_x = rng.randn(worker.SEQ_B, 24, worker.SEQ_D).astype(np.float32)
    rng = np.random.RandomState(0)
    bigru = JBiGRU(worker.BI_D, worker.BI_H).init(jax.random.PRNGKey(2))
    bigru_x = rng.randn(2, 16, worker.BI_D).astype(np.float32)
    bigru_g = rng.randn(2, 16, 2 * worker.BI_H).astype(np.float32)
    rng = np.random.RandomState(3)
    bf = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.bfloat16),
        JBiGRU(worker.BF_D, worker.BF_H).init(jax.random.PRNGKey(0)))
    bf_x = jnp.asarray(rng.randn(2, 32, worker.BF_D), jnp.bfloat16)
    return {"gru": _np(gru), "gru_x": gru_x, "bigru": _np(bigru),
            "bigru_x": bigru_x, "bigru_g": bigru_g, "bigru_bf16": _np(bf),
            "bigru_bf16_x": np.asarray(bf_x, np.float32)}, (bf, bf_x)


def _jax_refs(inp, bf):
    """The reference's sharded results (and its unsharded layers') on a
    4-device mesh, each under ``jax.jit`` (op by op, the gradient of the
    wavefront takes minutes to dispatch)."""
    mesh = jmesh(4, 1)
    out = {}
    for rev in (False, True):
        x = jnp.asarray(inp["gru_x"])
        out[f"gru_rev{int(rev)}"] = np.asarray(jax.jit(
            lambda p, v: jgru_seq_parallel(p, v, mesh, reverse=rev))(
                inp["gru"], x))
        out[f"gru_rev{int(rev)}_layer"] = np.asarray(
            JGRU(worker.SEQ_D, worker.SEQ_H).apply(inp["gru"], x,
                                                   reverse=rev))
    x, g = jnp.asarray(inp["bigru_x"]), jnp.asarray(inp["bigru_g"])
    with jax.default_matmul_precision("highest"):
        out["bigru"] = np.asarray(jax.jit(
            lambda p, v: jbigru_seq_parallel(p, v, mesh))(inp["bigru"], x))
        grads = jax.jit(jax.grad(lambda p, v: (jbigru_seq_parallel(p, v, mesh)
                                               * g).sum(), argnums=(0, 1)))(
            inp["bigru"], x)
    out["bigru_dx"] = np.asarray(grads[1])
    for li, layer in enumerate(grads[0]["layers"]):
        for d in ("fwd", "bwd"):
            for k, v in layer[d].items():
                out[f"bigru_d/layers.{li}.{d}.{k}"] = np.asarray(v)
    params, x = bf
    out["bigru_bf16"] = np.asarray(jax.jit(
        lambda p, v: jbigru_seq_parallel(p, v, mesh))(params, x), np.float32)
    return out


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seqpar")
    inp, bf = _inputs()
    with open(tmp / "seq_inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_tp_worker.py"),
         str(r), str(RANKS), str(port), str(tmp), "seqpar"], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    try:
        jax_ref = _jax_refs(inp, bf)           # while the ranks run
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    ranks = [dict(np.load(tmp / f"seqpar.rank{r}.npz")) for r in range(RANKS)]
    # the ranks' chunks in rank order; the weights' gradients are whole on
    # every rank (summed over the ranks)
    got = {}
    for k in ranks[0]:
        if k.startswith("bigru_d/"):
            for r in range(1, RANKS):
                assert np.array_equal(ranks[r][k], ranks[0][k]), k
            got[k] = ranks[0][k]
        else:
            got[k] = np.concatenate([r[k] for r in ranks], axis=1)
    return dict(inp=inp, got=got, jax=jax_ref)


def _port_bigru(inp, key, d, h):
    return worker._bigru(inp[key], d, h)


# -- over four ranks ---------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
def test_gru_seq_parallel_exact(seq, reverse):
    got = seq["got"][f"gru_rev{int(reverse)}"]
    for want in (seq["jax"][f"gru_rev{int(reverse)}"],
                 seq["jax"][f"gru_rev{int(reverse)}_layer"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    cell = worker._cell(seq["inp"]["gru"])
    with torch.no_grad():
        one = gru_seq_parallel(cell, torch.from_numpy(seq["inp"]["gru_x"]),
                               DataAxis(), reverse=reverse).numpy()
    # each chunk scanned once from the exact carry: the unsharded bits
    np.testing.assert_array_equal(got, one)


def test_bigru_seq_parallel_matches_bigru(seq):
    got = seq["got"]["bigru"]
    np.testing.assert_allclose(got, seq["jax"]["bigru"], rtol=1e-4,
                               atol=1e-5)
    m = _port_bigru(seq["inp"], "bigru", worker.BI_D, worker.BI_H)
    with torch.no_grad():
        one = m(torch.from_numpy(seq["inp"]["bigru_x"])).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-5)


def test_bigru_seq_parallel_bf16_is_bit_equal_to_the_unsharded_layer(seq):
    """The fp32 carry crosses the ranks, not the bf16 output: the chunks
    give the unsharded BiGRU's bits. Against the reference's bf16 result
    the two packages' bf16 products may round apart: held within one bf16
    ulp of the output's scale."""
    got = seq["got"]["bigru_bf16"]
    assert np.abs(got).max() < 1.0
    m = _port_bigru(seq["inp"], "bigru_bf16", worker.BF_D, worker.BF_H)
    with torch.no_grad():
        one = m(torch.from_numpy(seq["inp"]["bigru_bf16_x"]).bfloat16()
                ).float().numpy()
    np.testing.assert_array_equal(got, one)
    # measured: one bf16 ulp of an output in [0.5, 1) at most
    np.testing.assert_allclose(got, seq["jax"]["bigru_bf16"], rtol=0,
                               atol=2 ** -8)


def test_bigru_seq_parallel_gradients(seq):
    """The input's gradient (each rank its chunk's) and every weight's
    (summed over the ranks) against ``jax.grad`` of the reference's
    ``bigru_seq_parallel`` and against autograd through the port's
    ``BiGRU``, to GRAD_REL of each leaf's largest element."""
    got, want = seq["got"], seq["jax"]
    inp = seq["inp"]
    m = _port_bigru(inp, "bigru", worker.BI_D, worker.BI_H)
    x = torch.from_numpy(inp["bigru_x"]).requires_grad_()
    grads = torch.autograd.grad((m(x) * torch.from_numpy(inp["bigru_g"])
                                 ).sum(), [x] + list(m.parameters()))
    one = {"bigru_dx": grads[0].numpy()}
    one.update({f"bigru_d/{n}": g.numpy()
                for (n, _), g in zip(m.named_parameters(), grads[1:])})
    keys = [k for k in got if k.startswith("bigru_d")]
    assert len(keys) == 1 + 8
    for k in keys:
        for ref in (want[k], one[k]):
            err = np.abs(got[k] - ref).max() / np.abs(ref).max()
            assert err <= GRAD_REL, (k, err)


# -- the carried state, in one process -----------------------------------------

def _rec(dtype, d=2, b=3, t=10, h=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(b, t, d, 3 * h, generator=g).to(dtype)
    w = (torch.randn(d, h, 3 * h, generator=g) / 3).to(dtype)
    bias = torch.randn(d, 3 * h, generator=g) * 0.1
    return xp, w, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_zero_h0_gives_todays_bits(dtype):
    xp, w, b = _rec(dtype)
    want = gru_scan_reference(xp, w, b, carries=True)
    got = gru_scan_reference(xp, w, b, carries=True,
                             h0=torch.zeros(3, 2, 6), last=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the final carry is each lane's last step's
    assert torch.equal(got[2][:, 0], want[1][:, -1, 0])
    assert torch.equal(got[2][:, 1], want[1][:, 0, 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lane", [0, 1])
def test_two_chunks_chained_by_the_carry_give_one_scans_bits(dtype, lane):
    """One lane (the backward one read reversed) in two chunks, the second
    from the first's fp32 carry: the output, the carries and the final
    carry of one scan, bit for bit."""
    xp, w, b = _rec(dtype, d=2)
    x1 = xp[:, :, lane:lane + 1]
    if lane == 1:
        x1 = x1.flip(1)
    x1 = x1.contiguous()
    w1, b1 = w[lane:lane + 1], b[lane:lane + 1]
    out, hs, hl = gru_scan_reference(x1, w1, b1, carries=True, last=True)
    o1, s1, h1 = gru_scan_reference(x1[:, :4], w1, b1, carries=True,
                                    last=True)
    o2, s2, h2 = gru_scan_reference(x1[:, 4:], w1, b1, carries=True,
                                    h0=h1, last=True)
    assert torch.equal(torch.cat([o1, o2], 1), out)
    assert torch.equal(torch.cat([s1, s2], 1), hs)
    assert torch.equal(h2, hl)


def test_the_chained_gradient_equals_one_scans():
    """``gru_bptt`` of the second chunk hands ``dh0`` to the first as its
    final carry's cotangent: dxp, dW_hh and db_hh of one scan (the weights'
    summed over the chunks; fp32 sums of two parts, 1e-6)."""
    xp, w, b = _rec(torch.float32, d=1, t=12)
    g = torch.randn(3, 12, 1, 6, generator=torch.Generator().manual_seed(4))
    _, hs = gru_scan_reference(xp, w, b, carries=True)
    dxp, dw, db, dh0 = gru_bptt(g, xp, w, b, hs)
    _, s1, h1 = gru_scan_reference(xp[:, :5], w, b, carries=True, last=True)
    _, s2 = gru_scan_reference(xp[:, 5:], w, b, carries=True, h0=h1)
    d2 = gru_bptt(g[:, 5:], xp[:, 5:], w, b, s2, h0=h1)
    d1 = gru_bptt(g[:, :5], xp[:, :5], w, b, s1, dh_last=d2[3])
    assert torch.equal(torch.cat([d1[0], d2[0]], 1), dxp)
    torch.testing.assert_close(d1[1] + d2[1], dw, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(d1[2] + d2[2], db, rtol=1e-6, atol=1e-6)
    assert torch.equal(d1[3], dh0)


def test_gru_scan_is_differentiable_in_h0_and_the_final_carry():
    """Autograd through ``gru_scan`` with a carried state against autograd
    through the plain loop."""
    xp, w, b = _rec(torch.float32, d=2, t=7)
    h0 = torch.randn(3, 2, 6, generator=torch.Generator().manual_seed(5))
    leaves = [v.clone().requires_grad_() for v in (xp, w, b, h0)]
    out, hl = gru_scan(*leaves[:3], h0=leaves[3], last=True)
    got = torch.autograd.grad(out.sum() + 2 * hl.sum(), leaves)
    ref_leaves = [v.clone().requires_grad_() for v in (xp, w, b, h0)]
    o, _, l = gru_scan_reference(*ref_leaves[:3], carries=True,
                                 h0=ref_leaves[3], last=True)
    want = torch.autograd.grad(o.sum() + 2 * l.sum(), ref_leaves)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
