"""The port's GRU recurrence and BiGRU (m3f_torch/ops/gru.py,
m3f_torch/models/gru.py) against the JAX package: ``_gru_scan``,
``gru_scan_pallas`` in interpret mode and ``BiGRU.apply`` (bidirectional,
two layers, unidirectional, both backends). Weights come from the JAX init
through ``from_jax_params``; inputs are numpy from a seed."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import m3f.pytorch_tpu.ops.pallas.gru_pallas as gp
from m3f.pytorch_tpu.models.gru import BiGRU as JBiGRU, _gru_scan
from m3f_torch.models.gru import BiGRU
from m3f_torch.ops.gru import gru_scan
from m3f_torch.train.checkpoint import from_jax_params

F32_TOL = 1e-5        # tests/test_gru_pallas.py:21-22
BF16_TOL = 2 ** -6    # bf16 outputs; one-ulp flips of the bf16 h@W_hh


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scan_inputs(seed, T=12, B=3, H=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, B, 3 * H).astype(np.float32),
            (rng.randn(H, 3 * H) * 0.1).astype(np.float32),
            (rng.randn(3 * H) * 0.1).astype(np.float32))


def _port_scan(xp, w, b):
    """[T, B, 3H] reference layout → the port's [B, T, D=1, 3H]."""
    out = gru_scan(torch.from_numpy(xp).permute(1, 0, 2)[:, :, None],
                   torch.from_numpy(w)[None], torch.from_numpy(b)[None])
    return out[:, :, 0].permute(1, 0, 2).numpy()


def test_scan_matches_xla_scan():
    xp, w, b = _scan_inputs(0)
    got = _port_scan(xp, w, b)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_gru_scan(jnp.asarray(xp), jnp.zeros((3, 16)),
                                    jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_scan_matches_pallas_kernel_interpret():
    xp, w, b = _scan_inputs(1, T=20)
    got = _port_scan(xp, w, b)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(gp.gru_scan_pallas(jnp.asarray(xp), jnp.asarray(w),
                                             jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_two_directions_in_one_call_read_reversed_time():
    """Lane 1 of a D=2 call is the reversed-time recurrence of its inputs."""
    xp, w, b = _scan_inputs(2)
    x2 = np.stack([xp, xp[::-1]], axis=2).transpose(1, 0, 2, 3)  # [B,T,2,3H]
    out = gru_scan(torch.from_numpy(np.ascontiguousarray(x2)),
                   torch.from_numpy(np.stack([w, w])),
                   torch.from_numpy(np.stack([b, b]))).numpy()
    np.testing.assert_allclose(out[:, :, 1], out[:, ::-1, 0], rtol=0, atol=1e-6)


CASES = [
    pytest.param(dict(num_layers=1), "float32", "xla", id="bidir-f32"),
    pytest.param(dict(num_layers=2), "float32", "xla", id="bidir-2layer-f32"),
    pytest.param(dict(num_layers=2, bidirectional=False), "float32", "xla",
                 id="unidir-2layer-f32"),
    pytest.param(dict(num_layers=1), "bfloat16", "xla", id="bidir-bf16"),
    pytest.param(dict(num_layers=1), "bfloat16", "pallas", id="bidir-bf16-pallas"),
]


@pytest.mark.parametrize("kw,dtype,backend", CASES)
def test_bigru_matches_jax(kw, dtype, backend, monkeypatch):
    B, T, D, H = 2, 6, 8, 8
    x = np.random.RandomState(3).randn(B, T, D).astype(np.float32)
    params = JBiGRU(D, H, **kw).init(jax.random.PRNGKey(0))
    port = BiGRU(D, H, torch.Generator().manual_seed(0), backend=backend, **kw)
    port.load_state_dict(from_jax_params(jax.device_get(params), {}))
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(tdt)).float().numpy()
    orig = gp.gru_scan_pallas
    monkeypatch.setattr(gp, "gru_scan_pallas",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JBiGRU(D, H, backend=backend, **kw).apply(
            params, jnp.asarray(x, dtype)).astype(jnp.float32))
    assert got.shape == want.shape
    # bf16 with fp32 W_hh (the Pallas numerics) agrees exactly; the bf16 dot
    # of the XLA path can round one ulp apart between the two frameworks
    tol = {"float32": F32_TOL, "bfloat16": BF16_TOL}[dtype] \
        if backend == "xla" else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("backend,bidirectional,want", [
    ("xla", True, torch.bfloat16), ("pallas", True, torch.float32),
    ("pallas", False, torch.bfloat16)])
def test_bigru_passes_w_hh_in_the_backends_dtype(backend, bidirectional, want,
                                                  monkeypatch):
    """gru.backend picks the recurrent product's dtype (the reference's XLA
    scan: compute dtype; its Pallas kernel: fp32; unidirectional: the XLA
    scan whatever the backend). BiGRU passes the fp32 weights with that
    dtype, so their gradient accumulates in fp32."""
    import m3f_torch.models.gru as mg
    seen = []
    real = mg.gru_scan

    def spy(xp, w, b, w_dtype):
        assert w.dtype == torch.float32
        seen.append(w_dtype)
        return real(xp, w, b, w_dtype)
    monkeypatch.setattr(mg, "gru_scan", spy)
    port = BiGRU(8, 8, torch.Generator().manual_seed(0), backend=backend,
                 bidirectional=bidirectional)
    with torch.no_grad():
        port(torch.zeros(1, 3, 8, dtype=torch.bfloat16))
    assert seen == [want]
