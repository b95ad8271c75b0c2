"""The port's CCC module (m3f_torch/ops/ccc.py) against the JAX package's:
metric, losses and their gradients, in both moment orders, on masked,
all-masked and constant inputs, and the host-side pooled statistics.
Inputs come from numpy seeds; everything is fp32 on both sides, held to
1e-5 (summation order), and the fp64 host statistics to 1e-12."""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from m3f_torch.ops import ccc as tccc

# the module (the JAX package's ops/__init__ re-exports a function `ccc`)
jccc = importlib.import_module("m3f.pytorch_tpu.ops.ccc")

TOL = 1e-5


def _inputs(case, seed=0):
    rng = np.random.RandomState(seed)
    pred = np.tanh(rng.randn(3, 4, 16, 2)).astype(np.float32)
    target = rng.uniform(-1, 1, (3, 4, 16, 2)).astype(np.float32)
    mask = rng.rand(3, 4, 16) > 0.2
    if case == "all_masked":
        mask[:] = False
    elif case == "constant":
        pred[:] = 0.25
        target[..., 1] = -0.5
    elif case == "unmasked":
        mask = None
    return pred, target, mask


CASES = ["masked", "unmasked", "all_masked", "constant"]


@pytest.mark.parametrize("one_pass", [False, True], ids=["two_pass", "one_pass"])
@pytest.mark.parametrize("case", CASES)
def test_ccc_loss_and_gradient(case, one_pass):
    pred, target, mask = _inputs(case)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    def jloss(p):
        return jccc.ccc_loss(p, jnp.asarray(target), jm, one_pass=one_pass)

    want, gwant = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tccc.ccc_loss(p, torch.from_numpy(target), tm, one_pass=one_pass)
    got.backward()
    assert np.isfinite(got.item()) and torch.isfinite(p.grad).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gwant), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("one_pass", [False, True], ids=["two_pass", "one_pass"])
@pytest.mark.parametrize("axis", [None, (0,), (0, 1, 2)])
def test_ccc_metric_axes(axis, one_pass):
    pred, target, mask = _inputs("masked", 1)
    want = jccc.ccc(jnp.asarray(pred), jnp.asarray(target),
                    jnp.asarray(mask)[..., None], axis=axis, one_pass=one_pass)
    got = tccc.ccc(torch.from_numpy(pred), torch.from_numpy(target),
                   torch.from_numpy(mask)[..., None], axis=axis,
                   one_pass=one_pass)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_one_pass_clamps_near_constant_inputs():
    """Near-constant inputs: E[x²]−μ² cancels in fp32, so the value is
    noise on either side (not compared), but the clamps hold it in [-1, 1]
    and the stopped bound keeps the gradient finite, as in the reference."""
    rng = np.random.RandomState(2)
    pred = (0.7 + 1e-4 * rng.randn(64, 2)).astype(np.float32)
    target = (0.7 + 1e-4 * rng.randn(64, 2)).astype(np.float32)
    want = jccc.ccc(jnp.asarray(pred), jnp.asarray(target), axis=(0,),
                    one_pass=True)
    p = torch.from_numpy(pred).requires_grad_()
    got = tccc.ccc(p, torch.from_numpy(target), axis=(0,), one_pass=True)
    got.sum().backward()
    for v in (got.detach().numpy(), np.asarray(want)):
        assert (np.abs(v) <= 1.0 + 1e-6).all()
    assert torch.isfinite(p.grad).all()


@pytest.mark.parametrize("kind", ["ccc", "mse", "ccc+mse"])
@pytest.mark.parametrize("stats", ["two_pass", "one_pass"])
def test_make_loss(kind, stats):
    pred, target, mask = _inputs("masked", 3)
    want = jccc.make_loss(kind, 0.5, stats)(jnp.asarray(pred), jnp.asarray(target),
                                            jnp.asarray(mask))
    got = tccc.make_loss(kind, 0.5, stats)(torch.from_numpy(pred),
                                           torch.from_numpy(target),
                                           torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)


def test_make_loss_refuses_unknown_kinds():
    with pytest.raises(ValueError):
        tccc.make_loss("l1")
    with pytest.raises(ValueError):
        tccc.make_loss("ccc", ccc_stats="three_pass")


@pytest.mark.parametrize("case", ["masked", "all_masked", "constant"])
def test_pooled_sufficient_statistics(case):
    pred, target, mask = _inputs(case, 4)
    p, t, v = pred.reshape(-1, 2), target.reshape(-1, 2), mask.reshape(-1)
    got = tccc.ccc_sufficient_stats(p, t, v)
    want = jccc.ccc_sufficient_stats(p, t, v)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    both = got + tccc.ccc_sufficient_stats(p[::-1], t, v)
    np.testing.assert_allclose(tccc.ccc_from_stats(both),
                               jccc.ccc_from_stats(both), rtol=1e-12, atol=1e-12)
    assert np.isfinite(tccc.ccc_from_stats(got)).all()


def test_masked_mean_with_no_valid_element_is_zero():
    x = torch.ones(4, 2)
    m = torch.zeros(4, 2, dtype=torch.bool)
    assert torch.equal(tccc.masked_mean(x, m, axis=0), torch.zeros(2))
