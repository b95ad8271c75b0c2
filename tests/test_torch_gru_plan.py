"""The GRU cluster walk's planner and route (``m3f_torch.ops.gru.gru_plan``
/ ``gru_route``) and its walk, on the CPU: at the serving recurrence (16
sequences of 128 steps, H=256, two directions), the train step's (8 of 64)
and the edge shapes ``chip_smoke.py`` holds the kernel at, in bf16 and fp32
W. Every (direction, sequence, unit) is owned by exactly one lane of one
block of one cluster, U is a multiple of 8, the K parts cover K, the shared
memory fits a block, and a shape that fits no cluster takes the stream
route. A numpy run of the cluster walk (per-block column-slice products of
the rounded h, ``round_w``, gates, the exchange into the next h buffer of
every block) is held against ``gru_scan_reference`` and, at a small size,
against the JAX package's ``_gru_scan`` (bf16 W) and ``gru_scan_pallas`` in
interpret mode (fp32 W)."""

from collections import Counter

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import m3f.pytorch_tpu.ops.pallas.gru_pallas as gp
from m3f.pytorch_tpu.models.gru import _gru_scan
from m3f_torch.ops import gru

F32_TOL = 1e-5        # tests/test_torch_gru.py
BF16_TOL = 2 ** -6
SMEM = 232_448        # shared memory a block can use on an H100

# (B, T, H, D)
FULL = [(16, 128, 256, 2), (8, 64, 256, 2)]
EDGE = [(b, t, h, d) for b, t, h in ((5, 9, 72), (17, 3, 64), (1, 2, 8))
        for d in (1, 2)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("w_bf16", [True, False], ids=["bf16_w", "fp32_w"])
@pytest.mark.parametrize("shape", FULL + EDGE, ids=_ids(FULL + EDGE))
def test_plan_owns_every_unit_once(shape, w_bf16):
    b, t, h, d = shape
    plan = gru.gru_plan(b, t, h, d, w_bf16)
    assert plan.fits and gru.gru_route(b, h, d, w_bf16) == "cluster"
    assert plan.units % 8 == 0 and plan.cluster <= 8
    assert plan.smem <= SMEM
    assert plan.threads == plan.units // 8 * 32 * plan.ksplit <= 512
    assert plan.batch_tiles == -(-b // 16) and plan.clusters == d * plan.batch_tiles
    # the blocks' unit ranges tile [0, H), none empty
    units = [j for r in range(plan.cluster) for j in plan.units_of(r)]
    assert units == list(range(h))
    assert all(len(plan.units_of(r)) > 0 for r in range(plan.cluster))
    # the K parts tile the padded K
    ks = [k for p in range(plan.ksplit) for k in plan.k_range(p)]
    assert ks == list(range(plan.k_pad)) and plan.k_pad >= h
    assert all(len(plan.k_range(p)) % 32 == 0 for p in range(plan.ksplit))
    owners = Counter()
    for c in range(plan.clusters):
        for r in range(plan.cluster):
            lanes = plan.lanes(c, r)
            assert [tid for tid, _ in lanes] == list(range(plan.threads))
            for _, owned in lanes:
                assert all(j in plan.units_of(r) for _, _, j in owned)
                owners.update(owned)
    want = {(dd, bb, j) for dd in range(d) for bb in range(b) for j in range(h)}
    assert set(owners) == want
    assert set(owners.values()) == {1}


@pytest.mark.parametrize("w_bf16,want", [(True, 73_728), (False, 143_872)],
                         ids=["bf16_w", "fp32_w"])
def test_smem_at_the_default_width(w_bf16, want):
    """H=256 on 8 blocks of 32 units: W slice 96 x (256 + 8) bf16 or 256 x
    96 fp32, two h buffers 16 x (256 + 16 bytes), the xp ring 2 x 16 x 96."""
    plan = gru.gru_plan(16, 128, 256, 2, w_bf16)
    assert (plan.cluster, plan.units) == (8, 32)
    ws = 2 if w_bf16 else 4
    w_slice = 96 * 264 * 2 if w_bf16 else 256 * 96 * 4
    h_bufs = 2 * 16 * (256 + 16 // ws) * ws
    ring = 2 * 16 * 96 * (2 if w_bf16 else 4)
    partials = (plan.ksplit - 1) * 4 * 32 * 12 * 4
    assert plan.smem == w_slice + h_bufs + ring + partials
    assert w_slice + h_bufs + ring == want


@pytest.mark.parametrize("h,w_bf16,route,cluster", [
    (512, True, "cluster", 16),     # 8 blocks of 64 units do not fit
    (512, False, "stream", None),   # fp32 W: no cluster of 16 fits either
    (1024, True, "stream", None),
    (9, False, "stream", None),     # odd H: a lane's two units are one word
], ids=["bf16_512", "fp32_512", "bf16_1024", "odd_9"])
def test_route_where_no_cluster_fits(h, w_bf16, route, cluster):
    plan = gru.gru_plan(4, 6, h, 2, w_bf16)
    assert gru.gru_route(4, h, 2, w_bf16) == route
    assert plan.fits == (route == "cluster")
    if cluster:
        assert plan.cluster == cluster and plan.smem <= SMEM
    else:
        assert plan.smem > SMEM or h % 2


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round fp32 values to bf16 (nearest, ties to even), kept as fp32."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + (((u >> 16) & 1) + 0x7FFF)) & 0xFFFF0000
    return u.view(np.float32)


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def cluster_walk(xp, w, bias, plan, w_bf16):
    """numpy run of the cluster walk. xp [B, T, D, 3H] and w [D, H, 3H]
    hold their dtype's values as fp32, bias [D, 3H] fp32. Each block keeps
    its own pair of h buffers (in W's dtype) and its units' fp32 carry; each
    step it multiplies its buffer by its W column slice (K in the plan's
    parts, summed in order), rounds, adds the bias, runs the gates and
    stores h' into the next buffer of every block of its cluster. Returns
    the fp32 carries [B, T, D, H]; the output is them in x's dtype."""
    b, t, d_, h3 = xp.shape
    h = h3 // 3
    bm, u, c_ = plan.bm, plan.units, plan.cluster
    rnd = _bf16 if w_bf16 else (lambda a: a)
    hs = np.zeros((b, t, d_, h), np.float32)
    for c in range(plan.clusters):
        d, tile = divmod(c, plan.batch_tiles)
        rows = np.arange(tile * bm, min(b, (tile + 1) * bm))
        x = np.zeros((t, bm, h3), np.float32)
        x[:, :len(rows)] = xp[rows, :, d].transpose(1, 0, 2)
        bufs = np.zeros((c_, 2, bm, plan.k_pad), np.float32)
        carry = np.zeros((c_, bm, u), np.float32)
        slices = []
        for r in range(c_):
            j = np.arange(r * u, (r + 1) * u)
            ok = j < h
            ws = np.zeros((plan.k_pad, 3 * u), np.float32)
            for g in range(3):
                ws[:h, g * u + np.flatnonzero(ok)] = w[d][:, g * h + j[ok]]
            bb = np.zeros(3 * u, np.float32)
            for g in range(3):
                bb[g * u + np.flatnonzero(ok)] = bias[d][g * h + j[ok]]
            slices.append((j, ok, ws, bb))
        for step in range(t):
            ti = t - 1 - step if d == 1 else step
            cur = step % 2
            for r, (j, ok, ws, bb) in enumerate(slices):
                a = bufs[r, cur]
                parts = [a[:, k.start:k.stop] @ ws[k.start:k.stop]
                         for k in map(plan.k_range, range(plan.ksplit))
                         if len(k)]
                acc = parts[0]
                for p in parts[1:]:
                    acc = (acc + p).astype(np.float32)
                hp = rnd(acc) + bb
                xr, xz, xn = (x[ti][:, g * h + np.minimum(j, h - 1)] for g in range(3))
                rr = _sigmoid(xr + hp[:, :u])
                z = _sigmoid(xz + hp[:, u:2 * u])
                n = np.tanh(xn + rr * hp[:, 2 * u:])
                new = ((1 - z) * n + z * carry[r]).astype(np.float32)
                carry[r] = new
                for q in range(c_):                 # the exchange
                    bufs[q, 1 - cur][:, j[ok]] = rnd(new[:, ok])
                hs[rows, ti, d, j[ok][0]:j[ok][-1] + 1] = new[:len(rows), ok]
    return hs


def _inputs(seed, b, t, h, d, x_bf16, w_bf16):
    rng = np.random.RandomState(seed)
    xp = rng.randn(b, t, d, 3 * h).astype(np.float32)
    w = (rng.randn(d, h, 3 * h) / np.sqrt(h)).astype(np.float32)
    bias = (rng.randn(d, 3 * h) * 0.1).astype(np.float32)
    return (_bf16(xp) if x_bf16 else xp), (_bf16(w) if w_bf16 else w), bias


WALK = [pytest.param(s, dt, id=f"{'x'.join(map(str, s))}-{dt}")
        for s, dt in [((16, 128, 256, 2), "bf16"), ((16, 128, 256, 2), "fp32"),
                      ((8, 64, 256, 2), "fp32_w"), ((5, 9, 72, 2), "bf16"),
                      ((5, 9, 72, 1), "fp32"), ((17, 3, 64, 2), "fp32_w"),
                      ((17, 3, 64, 1), "bf16"), ((1, 2, 8, 2), "fp32")]]
DTYPES = {"bf16": (torch.bfloat16, torch.bfloat16),
          "fp32_w": (torch.bfloat16, torch.float32),
          "fp32": (torch.float32, torch.float32)}


@pytest.mark.parametrize("shape,dt", WALK)
def test_walk_matches_reference(shape, dt):
    b, t, h, d = shape
    x_dt, w_dt = DTYPES[dt]
    w_bf16 = w_dt == torch.bfloat16
    xp, w, bias = _inputs(sum(shape), b, t, h, d, x_dt == torch.bfloat16,
                          w_bf16)
    plan = gru.gru_plan(b, t, h, d, w_bf16)
    got = cluster_walk(xp, w, bias, plan, w_bf16)
    out, hs = gru.gru_scan_reference(
        torch.from_numpy(xp).to(x_dt), torch.from_numpy(w).to(w_dt),
        torch.from_numpy(bias), carries=True)
    if x_dt == torch.bfloat16:
        # the output is h rounded to bf16: one ulp of a flipped product
        np.testing.assert_allclose(_bf16(got), out.float().numpy(),
                                   rtol=0, atol=BF16_TOL)
    else:
        np.testing.assert_allclose(got, hs.numpy(), rtol=0, atol=F32_TOL)
        np.testing.assert_allclose(got, out.numpy(), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("d", [1, 2])
def test_walk_matches_xla_scan_bf16(d):
    """bf16 x and W: the JAX package's lax.scan step (its XLA backend),
    direction 1 run on the reversed sequence."""
    b, t, h = 5, 9, 72
    xp, w, bias = _inputs(40 + d, b, t, h, d, True, True)
    got = _bf16(cluster_walk(xp, w, bias, gru.gru_plan(b, t, h, d, True), True))
    for di in range(d):
        x = xp[:, :, di].transpose(1, 0, 2)
        x = x[::-1] if di == 1 else x
        want = np.asarray(_gru_scan(
            jnp.asarray(np.ascontiguousarray(x), jnp.bfloat16),
            jnp.zeros((b, h), jnp.float32), jnp.asarray(w[di], jnp.bfloat16),
            jnp.asarray(bias[di])).astype(jnp.float32))
        want = want[::-1] if di == 1 else want
        np.testing.assert_allclose(got[:, :, di], want.transpose(1, 0, 2),
                                   rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("d", [1, 2])
def test_walk_matches_pallas_kernel_interpret(d):
    """fp32 x and W: the JAX package's Pallas kernel in interpret mode."""
    b, t, h = 17, 6, 64
    xp, w, bias = _inputs(50 + d, b, t, h, d, False, False)
    got = cluster_walk(xp, w, bias, gru.gru_plan(b, t, h, d, False), False)
    with jax.default_matmul_precision("highest"):
        for di in range(d):
            x = xp[:, :, di].transpose(1, 0, 2)
            x = x[::-1] if di == 1 else x
            want = np.asarray(gp.gru_scan_pallas(
                jnp.asarray(np.ascontiguousarray(x)), jnp.asarray(w[di]),
                jnp.asarray(bias[di]), interpret=True))
            want = want[::-1] if di == 1 else want
            np.testing.assert_allclose(got[:, :, di], want.transpose(1, 0, 2),
                                       rtol=0, atol=F32_TOL)
