"""The port's conv-unit backward (m3f_torch/ops/conv_bn.py) against the JAX
package: the plain backward vs the reference's Pallas backward
(``_spatial_bwd`` / ``_temporal_bwd`` in interpret mode), and the autograd
``conv_unit`` vs ``jax.grad`` of ``conv_unit_reference``, at the shapes of
``tests/test_conv_bn_fused.py``. Inputs come from numpy seeds.

Tolerances: fp32 at 2e-4, as the reference's own grad test holds its two
backward implementations (summation order of the convs). bf16: dx within one
bf16 ulp of dx^ (the fp32 accumulator rounded once; with the prologue that
ulp carried through |inv|, plus the rounding of dxa*inv), dw per element
within 1e-5 of sum |x^|*|ge| (fp32, no rounding), dinv / dshift per channel
within the carried dx^ differences plus 1e-5 of sum |x * dxa|. The
reference's hybrid (XLA) backward rounds dw to bf16 before its fp32 cast;
the port returns dw in fp32 straight from the accumulator, as its Pallas
backward does, so bf16 is compared with the Pallas backward only."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import m3f.pytorch_tpu.ops.pallas.conv_bn as jcb
from m3f_torch.ops import conv_bn

CASES = [
    ("spatial", (2, 3, 8, 8, 16), (3, 3, 16, 24)),
    ("temporal", (2, 6, 8, 8, 24), (3, 24, 16)),
]
# the spatial shapes off the filter-gradient kernel's tiling that
# chip_smoke.py holds the kernel at against the plain version (H = 1, W = 1,
# 1x1 images, W = 7 and 9, C_in 40 and 152, C_out 24 and 40, one image, fewer
# pixels than one k-step, many tiny images per slice, images of several
# steps)
SPATIAL_EDGE_CASES = [
    ("spatial", (3, 5, 7, 9, 24), (3, 3, 24, 40)),
    ("spatial", (2, 3, 1, 11, 40), (3, 3, 40, 24)),
    ("spatial", (2, 2, 6, 1, 24), (3, 3, 24, 16)),
    ("spatial", (3, 4, 1, 1, 16), (3, 3, 16, 8)),
    ("spatial", (2, 3, 5, 7, 152), (3, 3, 152, 40)),
    ("spatial", (1, 1, 9, 13, 48), (3, 3, 48, 40)),
    ("spatial", (1, 2, 2, 3, 16), (3, 3, 16, 24)),
    ("spatial", (3, 200, 3, 5, 16), (3, 3, 16, 8)),
    ("spatial", (1, 2, 70, 11, 24), (3, 3, 24, 40)),
]
F32_TOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(xshape, wshape, seed, dtype):
    rng = np.random.RandomState(seed)
    co = wshape[-1]
    x = rng.randn(*xshape).astype(np.float32)
    w = (0.1 * rng.randn(*wshape)).astype(np.float32)
    inv = (rng.rand(xshape[-1]) + 0.5).astype(np.float32)
    shift = (0.1 * rng.randn(xshape[-1])).astype(np.float32)
    gy = rng.randn(*xshape[:-1], co).astype(np.float32)
    gs1 = rng.randn(co).astype(np.float32)
    gs2 = (0.01 * rng.randn(co)).astype(np.float32)
    jd = jnp.dtype(dtype)
    x, w, gy = (jnp.asarray(v).astype(jd) for v in (x, w, gy))
    return x, w, jnp.asarray(inv), jnp.asarray(shift), gy, jnp.asarray(gs1), \
        jnp.asarray(gs2)


def _t(a):
    """jax → torch, keeping bf16."""
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _ulp(v):
    a = np.maximum(np.abs(v.astype(np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


BWD_CASES = [
    pytest.param(kind, xs, ws, affine, dtype,
                 id=f"{kind}-{'affine' if affine else 'plain'}-{dtype}")
    for dtype in ("float32", "bfloat16")
    for affine in (True, False)
    for kind, xs, ws in CASES
] + [
    pytest.param(kind, xs, ws, affine, "bfloat16",
                 id=f"edge-{'x'.join(map(str, xs))}-{'affine' if affine else 'plain'}")
    for affine in (True, False)
    for kind, xs, ws in SPATIAL_EDGE_CASES
]


@pytest.mark.parametrize("kind,xshape,wshape,affine,dtype", BWD_CASES)
def test_plain_backward_matches_pallas_backward(kind, xshape, wshape, affine,
                                                dtype):
    x, w, inv, shift, gy, gs1, gs2 = _data(xshape, wshape, 1, dtype)
    a = (inv, shift) if affine else (None, None)
    y, _, _ = jcb.conv_unit_reference(x, w, *a, kind=kind)
    bwd = jcb._spatial_bwd if kind == "spatial" else jcb._temporal_bwd
    want = bwd(x, w, *a, y, gy, gs1, gs2, interpret=True)
    got = conv_bn.conv_unit_bwd_reference(
        _t(x), _t(w), _t(a[0]), _t(a[1]), _t(y), _t(gy), _t(gs1), _t(gs2),
        kind=kind)
    names = ("dx", "dw", "dinv", "dshift")
    if dtype == "float32":
        for name, g, r in zip(names, got, want):
            if r is None:
                assert g is None
                continue
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=f"{kind}:{name}")
        return
    dx, dw, dinv, dshift = (None if g is None else g.float().numpy() for g in got)
    dx_r = np.asarray(want[0].astype(jnp.float32))
    # the masked dx^ before the scale by inv (the reference's dx without the
    # prologue)
    dxa_r = np.asarray(bwd(x, w, None, None, y, gy, gs1, gs2,
                           interpret=True)[0].astype(jnp.float32))
    lim = _ulp(dx_r) + 1e-5 * np.abs(dx_r).max()
    if affine:
        inv_b = np.asarray(inv.astype(jnp.bfloat16).astype(jnp.float32))
        mask = np.asarray((x * inv.astype(x.dtype) + shift.astype(x.dtype))
                          .astype(jnp.float32)) > 0
        dxa_r = dxa_r * mask
        lim = lim + _ulp(dx_r) + np.abs(inv_b) * _ulp(dxa_r)
    assert (np.abs(dx - dx_r) <= lim).all(), np.abs(dx - dx_r).max()
    xh = np.asarray(jnp.maximum(x * inv.astype(x.dtype) + shift.astype(x.dtype), 0)
                    if affine else x).astype(np.float32)
    ge = np.asarray(jcb._gy_eff(gy, y, gs1, gs2)).astype(np.float32)
    absw = conv_bn.conv_unit_bwd_filter_reference(
        torch.from_numpy(np.abs(xh)), None, None,
        torch.zeros(ge.shape), torch.from_numpy(np.abs(ge)),
        torch.zeros(ge.shape[-1]), torch.zeros(ge.shape[-1]), kind=kind).numpy()
    dw_r = np.asarray(want[1])
    assert (np.abs(dw - dw_r) <= 1e-5 * absw + 1e-6 * absw.max()).all()
    if affine:
        xf = np.asarray(x.astype(jnp.float32))
        # the port's masked dx^ is recovered the same way from its own dx^
        dxa = conv_bn.conv_unit_bwd_reference(
            _t(x), _t(w), None, None, _t(y), _t(gy), _t(gs1), _t(gs2),
            kind=kind)[0].float().numpy() * mask
        axes = tuple(range(xf.ndim - 1))
        lim_i = (np.abs(xf) * np.abs(dxa - dxa_r)).sum(axes) \
            + 1e-5 * np.abs(xf * dxa_r).sum(axes) + 1e-6
        lim_s = np.abs(dxa - dxa_r).sum(axes) + 1e-5 * np.abs(dxa_r).sum(axes) + 1e-6
        assert (np.abs(dinv - np.asarray(want[2])) <= lim_i).all()
        assert (np.abs(dshift - np.asarray(want[3])) <= lim_s).all()
    else:
        assert dinv is None and dshift is None


GRAD_CASES = [pytest.param(kind, xs, ws, affine, id=f"{kind}-{affine}")
              for affine in (True, False) for kind, xs, ws in CASES]


@pytest.mark.parametrize("kind,xshape,wshape,affine", GRAD_CASES)
def test_autograd_conv_unit_matches_jax_grad(kind, xshape, wshape, affine):
    """The loss of the reference's grad test (y·ky + s1·k1 + s2·k2), fp32:
    the port's autograd unit (plain versions on the CPU) vs ``jax.grad`` of
    the reference's plain composition."""
    x, w, inv, shift, _, _, _ = _data(xshape, wshape, 1, "float32")
    co = wshape[-1]
    rng = np.random.RandomState(2)
    ky = rng.randn(*xshape[:-1], co).astype(np.float32)
    k1 = rng.randn(co).astype(np.float32)
    k2 = (0.01 * rng.randn(co)).astype(np.float32)

    def loss_j(*args):
        y, s1, s2 = jcb.conv_unit_reference(*args, kind=kind)
        return jnp.sum(y * ky) + jnp.sum(s1 * k1) + jnp.sum(s2 * k2)

    args = (x, w, inv, shift) if affine else (x, w)
    want = jax.grad(loss_j, argnums=tuple(range(len(args))))(*args)
    targs = [_t(a).requires_grad_() for a in args]
    y, s1, s2 = conv_bn.conv_unit(*targs, kind=kind)
    loss = (y * torch.from_numpy(ky)).sum() + (s1 * torch.from_numpy(k1)).sum() \
        + (s2 * torch.from_numpy(k2)).sum()
    got = torch.autograd.grad(loss, targs)
    for name, g, r in zip(("dx", "dw", "dinv", "dshift"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"{kind}:{name}")


def test_conv_unit_without_autograd_is_the_forward():
    """Under no_grad (eval, serving) the unit is ``conv_unit_fwd`` exactly,
    with w cast to x's dtype."""
    x, w, inv, shift, _, _, _ = _data(*CASES[0][1:], 3, "float32")
    x, w, inv, shift = (_t(v) for v in (x, w, inv, shift))
    w.requires_grad_()
    with torch.no_grad():
        got = conv_bn.conv_unit(x.bfloat16(), w, inv, shift, kind="spatial")
    want = conv_bn.conv_unit_fwd(x.bfloat16(), w.detach().bfloat16(), inv,
                                 shift, kind="spatial")
    for g, r in zip(got, want):
        assert torch.equal(g, r)
