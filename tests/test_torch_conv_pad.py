"""Fused conv units whose channel counts are not multiples of 8
(m3f_torch/ops/conv_bn.py ``pad_channels`` / ``cut_channels``, the pair the
three wrappers use on the card to zero-pad C_in and C_out up to multiples
of 8 and cut the outputs back). On the CPU the pair runs around the plain
versions: forward and both gradients of the padded unit, cut back, against
the unpadded plain versions, at C_in 12 / 108 and C_out 20 / 48, both
kinds, with and without the prologue. fp32 inputs; the zero channels add
exact zeros, so only the summation order may differ: 1e-5 of each output's
largest magnitude. Inputs are numpy from a seed."""

import numpy as np
import pytest
import torch

from m3f_torch.ops import conv_bn

REL = 1e-5
WIDTHS = [(12, 20), (108, 48)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _unit(kind, ci, co, affine, seed=0):
    rng = np.random.RandomState(seed)
    xs = (2, 3, 4, 5, ci)
    ws = (3, 3, ci, co) if kind == "spatial" else (3, ci, co)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    x = t(rng.randn(*xs))
    w = t(rng.randn(*ws) / np.sqrt(np.prod(ws[:-1])))
    inv = t(rng.rand(ci) + 0.5) if affine else None
    shift = t(0.3 * rng.randn(ci)) if affine else None
    gy = t(rng.randn(*xs[:-1], co))
    gs1, gs2 = t(0.1 * rng.randn(co)), t(0.01 * rng.randn(co))
    return x, w, inv, shift, gy, gs1, gs2


def _close(got, want):
    for g, v in zip(got, want):
        if v is None:
            assert g is None
            continue
        assert g.shape == v.shape
        np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=REL,
                                   atol=REL * float(v.abs().max()))


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
@pytest.mark.parametrize("ci,co", WIDTHS, ids=["12to20", "108to48"])
@pytest.mark.parametrize("affine", [False, True])
def test_padded_unit_matches_unpadded(kind, ci, co, affine):
    x, w, inv, shift, gy, gs1, gs2 = _unit(kind, ci, co, affine)
    padded = conv_bn.pad_channels(x, w, inv, shift)
    assert padded[0].shape[-1] % 8 == 0 and padded[1].shape[-1] % 8 == 0
    cut = conv_bn.cut_channels
    y, s1, s2 = conv_bn.conv_unit_reference(x, w, inv, shift, kind=kind)
    _close([cut(v, co) for v in conv_bn.conv_unit_reference(*padded, kind=kind)],
           (y, s1, s2))
    # the data gradient: every tensor of the unit padded, dx / dinv / dshift
    # cut back along C_in
    args = (x, w, inv, shift, y, gy, gs1, gs2)
    _close([cut(v, ci) for v in conv_bn.conv_unit_bwd_data_reference(
        *conv_bn.pad_channels(*args), kind=kind)],
        conv_bn.conv_unit_bwd_data_reference(*args, kind=kind))
    # the filter gradient takes no w: dw cut back along both axes
    xp, wp, invp, shiftp, *rest = conv_bn.pad_channels(x, None, inv, shift, y,
                                                       gy, gs1, gs2)
    assert wp is None
    _close([cut(conv_bn.conv_unit_bwd_filter_reference(
        xp, invp, shiftp, *rest, kind=kind), ci, co)],
        [conv_bn.conv_unit_bwd_filter_reference(x, inv, shift, y, gy, gs1, gs2,
                                                kind=kind)])


def test_padding_is_zero_and_widths_of_8_pass_through():
    """The pad is zeros (inv and shift too: x̂ = relu(0·0 + 0) = 0 on the
    padded input channels); tensors already at a multiple of 8 are returned
    as they are."""
    x, w, inv, shift, gy, gs1, gs2 = _unit("temporal", 12, 20, True)
    xp, wp, invp, shiftp, gyp, gs1p = conv_bn.pad_channels(x, w, inv, shift,
                                                           gy, gs1)
    assert xp.shape[-1] == invp.shape[0] == 16 and wp.shape[-2:] == (16, 24)
    assert gyp.shape[-1] == gs1p.shape[0] == 24
    for p, n in ((xp[..., 12:], 0), (wp[:, 12:], 0), (wp[..., 20:], 0),
                 (invp[12:], 0), (shiftp[12:], 0), (gyp[..., 20:], 0),
                 (gs1p[20:], 0)):
        assert p.numel() and bool((p == n).all())
    x8, w8, _, _ = conv_bn.pad_channels(x[..., :8], w[:, :8, :16], None, None)
    assert x8.data_ptr() == x[..., :8].data_ptr() and w8.shape == (3, 8, 16)


def test_cpu_wrappers_take_any_width():
    """On the CPU the wrappers run the plain versions, which take any width
    (the padding is only on the card's path)."""
    x, w, inv, shift, gy, gs1, gs2 = _unit("spatial", 12, 20, True)
    y, s1, s2 = conv_bn.conv_unit_fwd(x, w, inv, shift, kind="spatial")
    assert y.shape[-1] == 20 and s1.shape == (20,)
    dx, dinv, _ = conv_bn.conv_unit_bwd_data(x, w, inv, shift, y, gy, gs1, gs2,
                                             kind="spatial")
    assert dx.shape == x.shape and dinv.shape == (12,)
