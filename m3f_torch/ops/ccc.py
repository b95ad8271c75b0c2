"""Concordance correlation coefficient: metric and loss, with invalid-frame
masking.

Counterpart of ``m3f/pytorch_tpu/ops/ccc.py``:

    CCC(x, y) = 2·cov(x, y) / (σx² + σy² + (μx − μy)²)

with population (1/N) moments accumulated in fp32; the loss is
``1 − mean(CCC_V, CCC_A)`` over valid frames. ``one_pass`` computes the
moments from sufficient statistics, with the reference's clamps: variances
at 0 and the covariance clipped to the Cauchy–Schwarz bound, whose gradient
is stopped (``detach``). The host-side pooled statistics are numpy fp64.

Within a data-parallel train step (``parallel/mesh.py`` ``data_parallel``)
a reduction over the batch axis sums over the ranks, so the loss is the
one-device loss of the global batch on every rank: the statistics pass
their gradient through (``replicated_sum``), and the two-pass means, used
on each rank's own rows, sum theirs (``spread``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from m3f_torch.parallel.mesh import (active_axis, data_size, replicated_sum,
                                     spread)

Axis = Union[None, int, Sequence[int]]


def _norm_axes(axis: Axis, ndim: int):
    if axis is None:
        return tuple(range(ndim))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(a % ndim for a in axes)


def _global(axes) -> bool:
    """Whether a reduction over ``axes`` spans the batch of a data-parallel
    step (axis 0 under an active data axis), and so sums over the ranks."""
    return 0 in axes and active_axis() is not None


def _count(shape, axes) -> float:
    """The element count of a reduction over ``axes`` (over every rank's
    rows when it is global)."""
    n = float(np.prod([shape[a] for a in axes]))
    return n * data_size() if _global(axes) else n


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], axis: Axis,
                eps: float = 1e-12) -> torch.Tensor:
    """Mean of ``x`` over ``axis`` counting only elements where ``mask`` is
    true (``mask`` broadcasts against ``x``); 0 with no valid element.
    Within a data-parallel step, a mean over the batch covers every rank's
    rows (``replicated_sum``: every rank computes the loss alike)."""
    x = x.float()
    axes = _norm_axes(axis, x.dim())
    if mask is None:
        if not _global(axes):
            return x.mean(dim=axes)
        return replicated_sum(x.sum(dim=axes))[0] / _count(x.shape, axes)
    m = torch.broadcast_to(mask.float(), x.shape)
    num, den = (x * m).sum(dim=axes), m.sum(dim=axes)
    if _global(axes):
        num, den = replicated_sum(num, den)
    return num / torch.clamp_min(den, eps)


def ccc(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None, axis: Axis = None,
        eps: float = 1e-8, one_pass: bool = False) -> torch.Tensor:
    """Concordance correlation coefficient reduced over ``axis`` (default
    all), fp32; ``one_pass`` as in the module doc."""
    pred, target = pred.float(), target.float()
    axes = _norm_axes(axis, pred.dim())
    if one_pass:
        if mask is None:
            cnt = torch.tensor(_count(pred.shape, axes), device=pred.device)

            def sum_(v):
                return v.sum(dim=axes)
        else:
            m = torch.broadcast_to(mask.float(), pred.shape)

            def sum_(v):
                return (v * m).sum(dim=axes)
        sums = (sum_(pred), sum_(target), sum_(pred * target),
                sum_(pred * pred), sum_(target * target))
        if mask is not None:
            sums += (m.sum(dim=axes),)
        if _global(axes):
            sums = replicated_sum(*sums)
        if mask is not None:
            cnt = torch.clamp_min(sums[5], 1e-12)
        mu_p = sums[0] / cnt
        mu_t = sums[1] / cnt
        cov = sums[2] / cnt - mu_p * mu_t
        var_p = torch.clamp_min(sums[3] / cnt - mu_p * mu_p, 0.0)
        var_t = torch.clamp_min(sums[4] / cnt - mu_t * mu_t, 0.0)
        # the bound's gradient is stopped: sqrt has infinite slope at zero
        # variance, exactly where the clamp is needed
        cs = torch.sqrt(var_p * var_t).detach()
        cov = torch.minimum(torch.maximum(cov, -cs), cs)
        return 2.0 * cov / (var_p + var_t + (mu_p - mu_t) ** 2 + eps)
    mu_p = masked_mean(pred, mask, axes)
    mu_t = masked_mean(target, mask, axes)
    shape = list(pred.shape)
    for a in axes:
        shape[a] = 1
    # the means are replicated: where they meet this rank's rows their
    # gradient sums over the ranks, where they enter the CCC it does not
    lp, lt = (spread(mu_p), spread(mu_t)) if _global(axes) else (mu_p, mu_t)
    dp = pred - lp.reshape(shape)
    dt = target - lt.reshape(shape)
    cov = masked_mean(dp * dt, mask, axes)
    var_p = masked_mean(dp * dp, mask, axes)
    var_t = masked_mean(dt * dt, mask, axes)
    return 2.0 * cov / (var_p + var_t + (mu_p - mu_t) ** 2 + eps)


def ccc_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None, eps: float = 1e-8,
             one_pass: bool = False) -> torch.Tensor:
    """``1 − mean_over_outputs(CCC)``, statistics pooled over every leading
    axis (batch-level CCC); ``pred``/``target`` [..., num_outputs]."""
    sample_axes = tuple(range(pred.dim() - 1))
    if mask is not None and mask.dim() == pred.dim() - 1:
        mask = mask[..., None]
    per_output = ccc(pred, target, mask=mask, axis=sample_axes, eps=eps,
                     one_pass=one_pass)
    return 1.0 - per_output.mean()


def ccc_sufficient_stats(pred: np.ndarray, target: np.ndarray,
                         valid: np.ndarray) -> np.ndarray:
    """Per-channel masked sufficient statistics, host fp64: ``[C, 6]`` rows
    ``(n, Σx, Σy, Σx², Σy², Σxy)`` over valid frames. Rows of different
    videos add; ``ccc_from_stats`` of the sum is the pooled CCC."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    m = np.asarray(valid, np.float64).reshape(-1, 1)
    x = pred * m
    y = target * m
    n = np.broadcast_to(m.sum(axis=0), (pred.shape[-1],))
    return np.stack([n, x.sum(0), y.sum(0),
                     (x * x).sum(0), (y * y).sum(0), (x * y).sum(0)],
                    axis=-1)


def ccc_from_stats(stats: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """CCC per channel from summed ``ccc_sufficient_stats`` rows (fp64
    one-pass moments, degenerate inputs finite with CCC → 0)."""
    n, sx, sy, sxx, syy, sxy = np.moveaxis(np.asarray(stats, np.float64),
                                           -1, 0)
    n = np.maximum(n, 1e-12)
    mu_x, mu_y = sx / n, sy / n
    cov = sxy / n - mu_x * mu_y
    var_x = np.maximum(sxx / n - mu_x * mu_x, 0.0)
    var_y = np.maximum(syy / n - mu_y * mu_y, 0.0)
    return 2.0 * cov / (var_x + var_y + (mu_x - mu_y) ** 2 + eps)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean-squared error over valid frames (fp32)."""
    if mask is not None and mask.dim() == pred.dim() - 1:
        mask = mask[..., None]
    err = (pred.float() - target.float()) ** 2
    return masked_mean(err, mask, axis=None)


def make_loss(kind: str, mse_weight: float = 1.0, ccc_stats: str = "two_pass"):
    """Loss for ``train.loss``: "ccc" | "mse" | "ccc+mse"; ``ccc_stats``
    "two_pass" | "one_pass"."""
    if ccc_stats not in ("two_pass", "one_pass"):
        raise ValueError(f"unknown ccc_stats '{ccc_stats}'")
    one = ccc_stats == "one_pass"
    if kind == "ccc":
        return lambda pred, target, mask=None: ccc_loss(
            pred, target, mask, one_pass=one)
    if kind == "mse":
        return mse_loss
    if kind == "ccc+mse":
        def combined(pred, target, mask=None):
            return (ccc_loss(pred, target, mask, one_pass=one)
                    + mse_weight * mse_loss(pred, target, mask))
        return combined
    raise ValueError(f"unknown loss '{kind}' (ccc | mse | ccc+mse)")
