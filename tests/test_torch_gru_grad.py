"""The port's GRU gradient (m3f_torch/ops/gru.py: fp32 carries from the
forward, backpropagation through time in PyTorch ops) against ``jax.grad``
through the JAX package's ``BiGRU`` (its XLA ``lax.scan`` path, which the
reference's trainer differentiates). Weights cross with
``from_jax_params``; inputs and the loss weights come from numpy seeds.

Tolerances: fp32 at 2e-5 relative to each gradient's largest element (both
sides accumulate in fp32; only the summation order differs). bf16 at 5e-2
of the largest element: both round the recurrent product and its cotangent
to bf16 at every step, one-ulp differences of h carry through the 64-step
chain, and the input bias's gradient is a bf16 sum over B·T = 192 rows
(measured: 7 ulps apart in one element of 48)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from m3f.pytorch_tpu.models.gru import BiGRU as JBiGRU
from m3f_torch.models.gru import BiGRU
from m3f_torch.ops.gru import gru_bptt, gru_scan, gru_scan_reference
from m3f_torch.train.checkpoint import from_jax_params

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _to(a, dtype):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,bidirectional", [(1, True), (2, True), (1, False)])
def test_bigru_gradients_match_jax_grad(dtype, layers, bidirectional):
    D, H, B, T = 12, 16, 3, 64
    jg = JBiGRU(D, H, layers, bidirectional=bidirectional)
    params = jg.init(jax.random.PRNGKey(4))
    rng = np.random.RandomState(5)
    x = rng.randn(B, T, D).astype(np.float32)
    k = rng.randn(B, T, (2 if bidirectional else 1) * H).astype(np.float32)

    def loss(p, xx):
        y = jg.apply(p, xx.astype(jnp.dtype(dtype)))
        return jnp.sum(y.astype(jnp.float32) * k)

    with jax.default_matmul_precision("highest"):
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    port = BiGRU(D, H, torch.Generator().manual_seed(0), layers,
                 bidirectional=bidirectional)
    port.load_state_dict(from_jax_params(jax.device_get(params), {}))
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt.to(getattr(torch, dtype)))
    (y.float() * torch.from_numpy(k)).sum().backward()
    want = from_jax_params(jax.device_get(gp), {})
    tol = TOL[dtype]
    for n, p in port.named_parameters():
        r = want[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=n)
    gx = np.asarray(gx)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0,
                               atol=tol * np.abs(gx).max())


def test_bptt_equals_autograd_through_the_plain_loop():
    """The hand-written BPTT and autograd through the plain recurrence
    (fp32 weights, both directions) give the same gradients, and the plain
    loop returns the carries the backward reads."""
    rng = np.random.RandomState(6)
    B, T, D, H = 2, 9, 2, 5
    xp = torch.from_numpy(rng.randn(B, T, D, 3 * H).astype(np.float32))
    w = torch.from_numpy((rng.randn(D, H, 3 * H) / 3).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(D, 3 * H)).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, T, D, H).astype(np.float32))
    out, hs = gru_scan_reference(xp, w, b, carries=True)
    assert torch.equal(out, hs)          # fp32 output is the carry
    dxp, dw, db, _ = gru_bptt(g, xp, w, b, hs)
    leaves = [v.clone().requires_grad_() for v in (xp, w, b)]
    with torch.enable_grad():
        ref = torch.autograd.grad((gru_scan_reference(*leaves) * g).sum(), leaves)
    for got, r in zip((dxp, dw, db), ref):
        np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=1e-5, atol=1e-5)


def test_gru_scan_keeps_dw_in_fp32_with_bf16_products():
    """With a bf16 recurrent product the fp32 weights still get an fp32
    gradient (per-step products rounded, the sum over steps in fp32)."""
    rng = np.random.RandomState(7)
    xp = torch.from_numpy(rng.randn(2, 5, 2, 12).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.randn(2, 4, 12) / 2).astype(np.float32)).requires_grad_()
    b = torch.zeros(2, 12, requires_grad=True)
    y = gru_scan(xp, w, b, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32 and torch.isfinite(w.grad).all()
    with torch.no_grad():
        assert torch.equal(gru_scan(xp, w, b, torch.bfloat16),
                           gru_scan_reference(xp, w.bfloat16(), b))
