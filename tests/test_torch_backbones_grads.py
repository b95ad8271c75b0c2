"""One training step of every visual backbone of the JAX package in the
port (the variants of tests/test_torch_backbones.py, whose helpers this
file shares): the train-mode loss and the gradient of every parameter
against the JAX package's, fp32 and bf16, the 2plus1d variants also
against JAX's ``pallas_fused`` backend in interpret mode.

Tolerances: the loss within F32_TOL / BF16_TOL (tests/test_torch_models.py)
of its magnitude; fp32 gradients within F32_TOL of each leaf's largest
element; bf16 gradients per leaf in L2 (see the test's docstring)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from test_torch_backbones import (BF16_TOL, F32_TOL, TOL, _cases, _clips,
                                  _close, _jax_init, _port, _vis, jc, jr)
from m3f_torch.train.checkpoint import from_jax_params


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_grads(variant, backend, dtype, k):
    params, state = _jax_init(variant)
    model = jr.R2Plus1D(_vis(jc, variant, conv_backend=backend))
    x, _ = _clips(dtype, seed=3)

    def loss(p):
        y, _ = model.apply(p, state, jnp.asarray(x, dtype), train=True,
                           per_frame=True)
        return jnp.sum(y.astype(jnp.float32) * k)

    with jax.default_matmul_precision("highest"), \
            pltpu.force_tpu_interpret_mode():
        value, grads = jax.value_and_grad(loss)(params)
    return float(value), from_jax_params(jax.device_get(grads), {})


@pytest.mark.parametrize("variant,dtype,backend", _cases())
def test_train_step_loss_and_grads_match_jax(variant, dtype, backend):
    """loss = sum(per-frame features * k) in train mode, and its gradient
    for every parameter. fp32: each gradient within F32_TOL of its largest
    element. bf16: on batch statistics the reference's own bf16 rounding
    moves its BatchNorm gradients by 10-25% of their size at this width
    (against its fp32 run), so each gradient is held in L2 within BF16_TOL
    of its norm plus twice that move (two roundings, the port's and the
    reference's, each of about that size)."""
    port = _port(variant).train()
    _, xt = _clips(dtype, seed=3)
    tprime = 8 if variant == "mc3" else 4
    k = np.random.RandomState(4).randn(2, tprime, 16).astype(np.float32)
    want_loss, want_g = _jax_grads(variant, backend, dtype, k)
    got_loss = (port(xt, per_frame=True, train=True).float()
                * torch.from_numpy(k)).sum()
    got_loss.backward()
    _close(got_loss.item(), want_loss, TOL[dtype], "loss")
    named = dict(port.named_parameters())
    assert named.keys() == want_g.keys()
    if dtype == "float32":
        for name, p in named.items():
            _close(p.grad.numpy(), want_g[name].numpy(), F32_TOL, name)
        return
    _, f32_g = _jax_grads(variant, backend, "float32", k)
    for name, p in named.items():
        g, w = p.grad.numpy(), want_g[name].numpy()
        move = np.linalg.norm(w - f32_g[name].numpy())
        lim = BF16_TOL * np.linalg.norm(w) + 2 * move
        assert np.linalg.norm(g - w) <= lim, (name, np.linalg.norm(g - w), lim)
