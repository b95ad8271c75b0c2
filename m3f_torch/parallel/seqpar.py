"""Sharded whole-video eval: a video's W-window sequences split over the
ranks of the data axis.

Counterpart of ``make_sharded_eval_forward`` and ``pad_to_multiple`` in
``m3f/pytorch_tpu/parallel/seqpar.py``. The JAX package shards the
sequence batch over ``data`` and GSPMD gathers the small prediction tensor
back; here each rank runs its contiguous share of the sequences, padded to
a multiple of the world size by repeating the last sequence, and an
all-gather returns every rank the whole [b, W, L, 2] (the stitch then runs
on every rank alike). Each sequence starts its GRU afresh, so a share gives
what the whole batch gives for its rows. Eval BatchNorm reads the running
statistics, so no other collective is needed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from m3f_torch.parallel.mesh import DataAxis, gather_rows


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
