"""Sequence parallelism over the data axis: the sharded whole-video eval,
and the BiGRU over a time axis split over the ranks.

Counterpart of ``m3f/pytorch_tpu/parallel/seqpar.py``:

- ``make_sharded_eval_forward`` / ``pad_to_multiple``: the JAX package
  shards the sequence batch over ``data`` and GSPMD gathers the small
  prediction tensor back; here each rank runs its contiguous share of the
  sequences, padded to a multiple of the world size by repeating the last
  sequence, and an all-gather returns every rank the whole [b, W, L, 2]
  (the stitch then runs on every rank alike). Each sequence starts its GRU
  afresh, so a share gives what the whole batch gives for its rows. Eval
  BatchNorm reads the running statistics, so no other collective is
  needed.
- ``gru_seq_parallel`` / ``bigru_seq_parallel``: x [B, T, D] with T split
  contiguously over the data axis, each rank holding its chunk [B, T/d,
  D]. Each rank projects its own chunk, then scans it once on the GRU
  kernel (``ops/gru.py``, row 2) from the exact fp32 carry of the rank
  before it in the lane's order (forward lane: rank r-1; backward lane:
  r+1; the sequence-edge rank from zeros) and passes its final fp32 carry
  on: a pipeline. The reference's ``ppermute`` wavefront re-scans every
  chunk d times to the same result; one scan each from the exact carry
  gives the bits of the unsharded scan (the walk keeps no time tile). The
  carry crosses ranks point to point: NCCL sends device tensors, gloo's
  send / recv take host tensors, so on gloo ranks the carry is staged
  through the host (the group's backend decides; a failed send raises).
  Both are differentiable: the backward runs each lane's pipeline the
  other way (``gru_bptt`` from the carry's cotangent of the rank after),
  and the weights' gradients are summed over the ranks, as ``jax.grad``
  of the reference's gives them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from m3f_torch.ops.gru import _gru_forward, gru_bptt
from m3f_torch.parallel.mesh import DataAxis, gather_rows, spread


def pad_to_multiple(x: np.ndarray, multiple: int,
                    axis: int = 0) -> Tuple[np.ndarray, int]:
    """``x`` padded along ``axis`` to a multiple of ``multiple`` by
    repeating its last element, and the number of elements added."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x, 0
    last = np.take(x, [-1], axis=axis)
    return np.concatenate([x, np.repeat(last, pad, axis=axis)], axis=axis), pad


def shard_sequences(axis: DataAxis, arrays: Sequence[np.ndarray]
                    ) -> List[np.ndarray]:
    """This rank's share of host arrays whose leading axis counts sequences
    (equal counts), after ``pad_to_multiple`` to the world size."""
    lens = {len(a) for a in arrays}
    if len(lens) != 1:
        raise ValueError(f"sequence arrays disagree on their leading dim: "
                         f"{sorted(lens)}")
    out = []
    for a in arrays:
        padded, _ = pad_to_multiple(np.asarray(a), axis.size)
        out.append(padded[axis.rows(len(padded) // axis.size)])
    return out


def make_sharded_eval_forward(axis: DataAxis,
                              apply_fn: Callable[[Dict[str, np.ndarray]],
                                                 torch.Tensor]
                              ) -> Callable[[Dict[str, np.ndarray]],
                                            torch.Tensor]:
    """Eval forward with the sequence batch split over ``axis``:
    ``apply_fn(feed) -> preds`` on a host feed whose arrays lead with the
    sequence axis (``Trainer._windowed_forward`` passes its window starts;
    ``Trainer.make_eval_forward()`` takes the sequences themselves). The
    returned callable takes the whole host feed on every rank and returns
    every sequence's predictions, the same on every rank, on ``apply_fn``'s
    device. Without a group it is ``apply_fn`` on the whole feed."""
    def run(host_batch: Dict[str, np.ndarray]) -> torch.Tensor:
        keys = list(host_batch)
        n = len(np.asarray(host_batch[keys[0]]))
        shares = shard_sequences(axis, [host_batch[k] for k in keys])
        preds = apply_fn(dict(zip(keys, shares)))
        # every rank's share in rank order, the padding cut
        return gather_rows(preds, axis)[:n]
    return run


# -- the BiGRU over a time axis split over the ranks -----------------------------

def _neighbours(axis: DataAxis, reverse: bool
                ) -> Tuple[Optional[int], Optional[int]]:
    """(global rank before, global rank after) this rank in a lane's order
    over ``axis`` (the backward lane runs from the last rank to the first);
    None at the sequence's edges and without a group."""
    if axis.group is None:
        return None, None
    order = list(axis.ranks[::-1] if reverse else axis.ranks)
    i = order.index(axis.ranks[axis.rank])
    return (order[i - 1] if i > 0 else None,
            order[i + 1] if i + 1 < len(order) else None)


def _host_staged(axis: DataAxis) -> bool:
    """Whether the group's point-to-point transport takes host tensors
    only (gloo), so a device carry is staged through the host."""
    return dist.get_backend(axis.group) == "gloo"


def _send(t: torch.Tensor, dst: int, axis: DataAxis) -> None:
    t = t.detach().float().contiguous()
    dist.send(t.cpu() if _host_staged(axis) else t, dst, group=axis.group)


def _recv(shape, device, src: int, axis: DataAxis) -> torch.Tensor:
    buf = torch.empty(shape, dtype=torch.float32,
                      device="cpu" if _host_staged(axis) else device)
    dist.recv(buf, src, group=axis.group)
    return buf.to(device)


def _lane_scan(xp, w, b_hh, axis, reverse, carries: bool):
    """This rank's stage of a lane's pipeline: the carry from the rank
    before (zeros at the sequence's edge), one scan of the chunk, the final
    carry to the rank after → (out, fp32 carries or None, starting carry
    or None)."""
    prev, nxt = _neighbours(axis, reverse)
    b, _, _, h3 = xp.shape
    h0 = None if prev is None else _recv((b, 1, h3 // 3), xp.device, prev,
                                         axis)
    res = _gru_forward(xp, w, b_hh, carries=carries, h0=h0, last=True)
    if nxt is not None:
        _send(res[-1], nxt, axis)
    return res[0], (res[1] if carries else None), h0


class _Lane(torch.autograd.Function):
    """``_lane_scan`` with its gradient: the backward receives the final
    carry's cotangent from the rank after, runs ``gru_bptt`` from the
    starting carry and sends that carry's cotangent to the rank before."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh, axis, reverse, w_dtype):
        w = w_hh.to(w_dtype)
        out, hs, h0 = _lane_scan(xp, w, b_hh, axis, reverse, carries=True)
        ctx.save_for_backward(xp, w, b_hh, hs, h0)
        ctx.axis, ctx.reverse, ctx.w_hh_dtype = axis, reverse, w_hh.dtype
        return out

    @staticmethod
    def backward(ctx, gout):
        xp, w, b_hh, hs, h0 = ctx.saved_tensors
        prev, nxt = _neighbours(ctx.axis, ctx.reverse)
        dh_last = None if nxt is None else _recv(
            tuple(hs[:, 0].shape), xp.device, nxt, ctx.axis)
        dxp, dw, db, dh0 = gru_bptt(gout, xp, w, b_hh, hs, h0, dh_last)
        if prev is not None:
            _send(dh0, prev, ctx.axis)
        return dxp, dw.to(ctx.w_hh_dtype), db, None, None, None


def _lane(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
          axis: DataAxis, reverse: bool, w_dtype: torch.dtype
          ) -> torch.Tensor:
    """This rank's chunk of one direction: xp [B, Tl, 3H] (time order) →
    [B, Tl, H]; ``w_hh`` [H, 3H] (the product in ``w_dtype``, its gradient
    accumulated in fp32 as ``ops.gru.gru_scan``'s), ``b_hh`` fp32."""
    xp = (xp.flip(1) if reverse else xp)[:, :, None]
    w, b = w_hh[None], b_hh[None]
    if torch.is_grad_enabled() and any(v.requires_grad for v in (xp, w, b)):
        out = _Lane.apply(xp, w, b, axis, reverse, w_dtype)
    else:
        out = _lane_scan(xp, w.to(w_dtype), b, axis, reverse, False)[0]
    out = out[:, :, 0]
    return out.flip(1) if reverse else out


def gru_seq_parallel(cell, x: torch.Tensor, axis: DataAxis,
                     reverse: bool = False) -> torch.Tensor:
    """One direction of a GRU (``cell``: a ``models.gru.GRUCell``) over a
    sequence whose time axis is split contiguously over ``axis``: x [B, Tl,
    D] is this rank's chunk → its chunk of the output, [B, Tl, H] in x's
    dtype. The recurrent product runs in x's dtype (the reference's XLA
    scan); ``reverse`` runs the lane from the last time step of the last
    rank. Without a group, the unsharded layer."""
    dtype = x.dtype
    w_ih, b_ih, w_hh, b_hh = (spread(p, axis) for p in
                              (cell.w_ih, cell.b_ih, cell.w_hh, cell.b_hh))
    xp = x @ w_ih.to(dtype) + b_ih.to(dtype)
    return _lane(xp, w_hh, b_hh.float(), axis, reverse, dtype)


def bigru_seq_parallel(bigru, x: torch.Tensor,
                       axis: DataAxis) -> torch.Tensor:
    """A ``models.gru.BiGRU`` over a sequence whose time axis is split
    contiguously over ``axis``: x [B, Tl, D] this rank's chunk → [B, Tl,
    2H] (or [B, Tl, H] unidirectional), what the unsharded layer gives for
    these steps. Per layer, the directions' input projection is one
    product (as ``BiGRU.forward``'s), then the forward lane and the
    backward lane run their pipelines in turn."""
    h = x
    for layer in bigru.layers:
        cells = bigru.cells(layer)
        weight = lambda p: spread(p, axis)
        xp = bigru.project(cells, h, weight)
        w_hh, b_hh = bigru.recurrent(cells, weight)
        w_dtype = bigru.w_dtype(h.dtype)
        h = torch.cat([_lane(xp[:, :, i], w_hh[i], b_hh[i], axis, i == 1,
                             w_dtype) for i in range(len(cells))], dim=-1)
    return h
