"""Sliding-window enumeration and overlap stitching onto the frame timeline.

Counterpart of ``m3f/pytorch_tpu/ops/stitch.py``. The framewise stitch is a
scatter-add (``index_add_``) of the W·L per-frame window predictions and
their coverage counts; ``stitch_overlap_average`` (one prediction per
window) scatter-adds in float64; host-side postprocess helpers are numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def window_starts(num_frames: int, window: int, stride: int) -> np.ndarray:
    """Start indices covering every frame: [0, s, 2s, …] plus a clamped
    tail window; one window at 0 when ``num_frames <= window``."""
    if stride > window:
        raise ValueError(
            f"eval stride {stride} > window {window} leaves uncovered frames")
    if num_frames <= window:
        return np.zeros(1, dtype=np.int32)
    starts = list(range(0, num_frames - window + 1, stride))
    if starts[-1] != num_frames - window:
        starts.append(num_frames - window)
    return np.asarray(starts, dtype=np.int32)


def coverage_matrix(starts: torch.Tensor, num_frames: int,
                    window: int) -> torch.Tensor:
    """[N, W] fp32 0/1 matrix: frame f is covered by window w."""
    f = torch.arange(num_frames, device=starts.device)[:, None]
    s = starts[None, :]
    return ((f >= s) & (f < s + window)).float()


def stitch_overlap_average(window_preds: torch.Tensor, starts: torch.Tensor,
                           num_frames: int, window: int) -> torch.Tensor:
    """Overlap-average one prediction per window [W, C] onto the frame
    timeline → [num_frames, C] fp32; each window covers ``window`` frames
    from its start. The sums are float64 scatter-adds over the coverage,
    so no TF32 setting can change them (the reference pins its product to
    full fp32 precision)."""
    w, c = window_preds.shape
    dev = window_preds.device
    idx = (starts.long()[:, None]
           + torch.arange(window, device=dev)[None, :]).reshape(-1)
    # frames past the end add zeros (to the last frame): no host sync
    keep = (idx < num_frames).double()[:, None]
    idx = idx.clamp_max(num_frames - 1)
    vals = window_preds.double()[:, None, :].expand(w, window, c)
    num = torch.zeros(num_frames, c, dtype=torch.float64, device=dev)
    den = torch.zeros(num_frames, 1, dtype=torch.float64, device=dev)
    num.index_add_(0, idx, vals.reshape(-1, c) * keep)
    den.index_add_(0, idx, keep)
    return (num / torch.clamp_min(den, 1.0)).float()


def stitch_framewise_sums(window_preds: torch.Tensor, starts: torch.Tensor,
                          num_frames: int,
                          win_valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ preds [num_frames, C], coverage count [num_frames]) of per-frame
    window predictions [W, L, C]; indices past ``num_frames`` are dropped."""
    w, l, c = window_preds.shape
    idx = (starts.long()[:, None]
           + torch.arange(l, device=starts.device)[None, :]).reshape(-1)
    vals = window_preds.float()
    ones = torch.ones(w, l, device=window_preds.device)
    if win_valid is not None:
        wv = win_valid.float()[:, None]
        vals = vals * wv[..., None]
        ones = ones * wv
    keep = idx < num_frames
    num = torch.zeros(num_frames, c, device=window_preds.device)
    den = torch.zeros(num_frames, device=window_preds.device)
    num.index_add_(0, idx[keep], vals.reshape(-1, c)[keep])
    den.index_add_(0, idx[keep], ones.reshape(-1)[keep])
    return num, den


def stitch_framewise(window_preds: torch.Tensor, starts: torch.Tensor,
                     num_frames: int,
                     win_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Overlap-average per-frame window predictions [W, L, C] →
    [num_frames, C]; ``win_valid`` drops padding windows."""
    num, den = stitch_framewise_sums(window_preds, starts, num_frames,
                                     win_valid)
    return num / torch.clamp_min(den[:, None], 1.0)


def smooth_moving_average(preds: torch.Tensor, window: int) -> torch.Tensor:
    """Centred moving average over frames, [T, C] → [T, C], fp32, edge-padded
    (``infer.submission.smooth_predictions`` on the device)."""
    if window <= 1:
        return preds
    t = preds.shape[0]
    pad = window // 2
    x = preds.float()
    xp = torch.cat([x[:1].expand(pad, -1), x, x[-1:].expand(pad, -1)])
    out = xp[0:t]
    for i in range(1, window):
        out = out + xp[i:i + t]
    return out / window


def interpolate_gaps(preds: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Linearly interpolate rows where ``valid`` is False; edge gaps take
    the nearest valid value; all-invalid gives zeros."""
    preds = np.array(preds, dtype=np.float32, copy=True)
    valid = np.asarray(valid, dtype=bool)
    if valid.all():
        return preds
    if not valid.any():
        return np.zeros_like(preds)
    idx = np.arange(len(preds))
    for c in range(preds.shape[1]):
        preds[~valid, c] = np.interp(idx[~valid], idx[valid], preds[valid, c])
    return preds


def clip_predictions(preds: np.ndarray) -> np.ndarray:
    """Clip to the valid label range [-1, 1]."""
    return np.clip(preds, -1.0, 1.0)
