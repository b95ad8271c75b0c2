"""Train steps of the plain reference: the masked CCC loss, its gradient
by autograd through ``model.Net`` (BatchNorm on batch statistics), the
global-norm clip and Adam (optax's defaults), float32.

The loss is ``1 - mean over outputs of CCC``, each output's CCC pooled over
every valid frame of the batch: ``2 cov / (var_p + var_t + (mu_p - mu_t)^2
+ 1e-8)`` with the moments about the means (two-pass). Gradients whose
global norm is not below ``clip`` are scaled to it. Adam: ``mu = b1 mu +
(1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, ``p -= lr (mu / (1 - b1^k)) /
(sqrt(nu / (1 - b2^k)) + eps)``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference.model import Net, Ops, is_buffer

B1, B2, EPS = 0.9, 0.999, 1e-8


def ccc_loss(pred: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    m = mask[..., None].float().expand_as(pred)
    axes = tuple(range(pred.dim() - 1))
    cnt = m.sum(axes).clamp_min(1e-12)
    mu_p = (pred * m).sum(axes) / cnt
    mu_t = (labels * m).sum(axes) / cnt
    dp, dt = pred - mu_p, labels - mu_t
    cov = (dp * dt * m).sum(axes) / cnt
    var_p = (dp * dp * m).sum(axes) / cnt
    var_t = (dt * dt * m).sum(axes) / cnt
    ccc = 2.0 * cov / (var_p + var_t + (mu_p - mu_t) ** 2 + eps)
    return 1.0 - ccc.mean()


def train(w0: Dict[str, torch.Tensor], model: dict, batches: List[dict], *,
          lr: float, clip: float, device, ops: Ops = None,
          rows: slice = slice(None)):
    """``len(batches)`` steps from the weights ``w0``. ``rows`` keeps only
    those rows of each batch (a planted fault: the loss's mean over the
    rest). Returns (losses, {leaf: norm of the first clipped gradient},
    {leaf: norm of the change of the leaf over the steps})."""
    names = list(w0)
    params = {n: w0[n].detach().clone().requires_grad_(True)
              for n in names if not is_buffer(n, names)}
    buffers = {n: w0[n] for n in names if is_buffer(n, names)}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    for k, b in enumerate(batches, start=1):
        t = {key: torch.as_tensor(v)[rows].to(device) for key, v in b.items()}
        net = Net({**params, **buffers}, model, ops=ops, train=True, ckpt=True)
        loss = ccc_loss(net.forward(t["video"], t["wav"]), t["labels"],
                        t["mask"])
        grads = torch.autograd.grad(loss, list(params.values()))
        gn = torch.sqrt(sum((g * g).sum() for g in grads))
        if not bool(gn < clip):
            grads = [g / gn * clip for g in grads]
        if first is None:
            first = {n: float(g.norm()) for n, g in zip(params, grads)}
        c1, c2 = 1.0 - B1 ** k, 1.0 - B2 ** k
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                mu[n].mul_(B1).add_((1.0 - B1) * g)
                nu[n].mul_(B2).add_((1.0 - B2) * g * g)
                p -= lr * (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + EPS)
        losses.append(float(loss.detach()))
    change = {n: float((p.detach() - w0[n]).norm()) for n, p in params.items()}
    return losses, first, change


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap between two sets of per-leaf norms: |got - want| over
    the larger of the reference's norm of that leaf and of its median
    leaf; ``keep`` names the leaves compared (default all)."""
    names = [n for n in want if keep is None or n in keep]
    med = sorted(want[n] for n in names)[len(names) // 2]
    return {n: (abs(got[n] - want[n]) / max(want[n], med, 1e-30)
                if math.isfinite(got[n]) else math.inf) for n in names}
