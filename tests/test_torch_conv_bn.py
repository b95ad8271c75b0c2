"""The port's fused conv+BN forward unit (m3f_torch/ops/conv_bn.py) against
the JAX package's ``conv_unit_reference`` and its Pallas unit under
``pltpu.force_tpu_interpret_mode()`` (as tests/test_conv_bn_fused.py:39),
with and without the BN prologue, in fp32 and bf16. Inputs are numpy from a
seed."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import m3f.pytorch_tpu.ops.pallas.conv_bn as cb
from m3f_torch.ops import conv_bn, cuda_lib

CASES = [
    ("spatial", (2, 3, 8, 8, 16), (3, 3, 16, 24)),
    ("temporal", (2, 6, 8, 8, 24), (3, 24, 16)),
]
# fp32: tests/test_conv_bn_fused.py:41-46
Y_TOL, S_RTOL, S_ATOL = 2e-5, 1e-4, 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(xshape, wshape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*xshape).astype(np.float32),
            (0.1 * rng.randn(*wshape)).astype(np.float32),
            (rng.rand(xshape[-1]) + 0.5).astype(np.float32),
            (0.1 * rng.randn(xshape[-1])).astype(np.float32))


def _port(x, w, inv, shift, kind, affine, dtype=torch.float32):
    a = (torch.from_numpy(inv), torch.from_numpy(shift)) if affine else (None, None)
    y, s1, s2 = conv_bn.conv_unit_fwd(torch.from_numpy(x).to(dtype),
                                      torch.from_numpy(w), *a, kind=kind)
    return y.float().numpy(), s1.numpy(), s2.numpy()


@pytest.mark.parametrize("kind,xshape,wshape", CASES)
@pytest.mark.parametrize("affine", [False, True])
def test_matches_reference_and_pallas_unit(kind, xshape, wshape, affine):
    x, w, inv, shift = _data(xshape, wshape)
    got = _port(x, w, inv, shift, kind, affine)
    j = [jnp.asarray(v) for v in (x, w, inv, shift)]
    a = (j[2], j[3]) if affine else (None, None)
    ref = cb.conv_unit_reference(j[0], j[1], *a, kind=kind)
    with pltpu.force_tpu_interpret_mode():
        pal = cb.conv_unit(j[0], j[1], *a, kind=kind)
    for want in (ref, pal):
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=Y_TOL, atol=Y_TOL)
        for g, s in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, np.asarray(s), rtol=S_RTOL, atol=S_ATOL)


@pytest.mark.parametrize("kind,xshape,wshape", CASES)
def test_bf16_prologue_rounding_matches_reference(kind, xshape, wshape):
    """bf16 activations: the prologue rounds after the product and after the
    sum like the reference; y is the rounded conv output (both fp32
    accumulation, so at most one bf16 ulp apart) and the sums are over the
    rounded y."""
    x, w, inv, shift = _data(xshape, wshape, seed=1)
    got = _port(x, w, inv, shift, kind, True, torch.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    y, s1, s2 = cb.conv_unit_reference(xb, jnp.asarray(w), jnp.asarray(inv),
                                       jnp.asarray(shift), kind=kind)
    want_y = np.asarray(y.astype(jnp.float32))
    np.testing.assert_allclose(got[0], want_y, rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(got[1], np.asarray(s1), rtol=S_RTOL, atol=S_ATOL)
    np.testing.assert_allclose(got[2], np.asarray(s2), rtol=S_RTOL, atol=S_ATOL)


def test_cpu_tensor_takes_plain_version():
    x, w, inv, shift = _data(*CASES[0][1:])
    before = dict(cuda_lib.launches)
    y, s1, s2 = conv_bn.conv_unit_fwd(torch.from_numpy(x), torch.from_numpy(w),
                                      kind="spatial")
    y0, s10, s20 = conv_bn.conv_unit_reference(torch.from_numpy(x),
                                               torch.from_numpy(w), kind="spatial")
    assert torch.equal(y, y0) and torch.equal(s1, s10) and torch.equal(s2, s20)
    assert cuda_lib.launches == before
    with pytest.raises(ValueError):
        conv_bn.conv_unit_fwd(torch.from_numpy(x), torch.from_numpy(w), kind="3d")


def test_kernel_tile_choice_covers_model_widths():
    """The temporal forward's output-channel tiles divide every fused
    temporal unit's width at full size (128 clips served, 32 trained): no
    masked columns, and a layout the kernel is built for."""
    for clips in (128, 32):
        for c, t, s in ((64, 16, 56), (128, 8, 28), (256, 4, 14), (512, 2, 7)):
            mid = (27 * c * c) // (12 * c)
            plan = conv_bn.temporal_fwd_plan(clips, t, s, s, mid, c, 132)
            assert c % plan.n_tile == 0
            assert (plan.strip, plan.n_tile) in conv_bn._TW_BUILT
