"""Whole-video predictions of the plain reference.

A video of n frames is read as windows of L frames every ``stride`` frames
(and one last window ending at frame n), each with the wav samples from
``round(start / fps · sr)`` on, ``spw`` of them, zero past the wav's end.
Consecutive windows form sequences of W; the last sequence is filled up by
repeating the last window. Each frame's prediction is the mean over the
real windows that cover it, clipped to [-1, 1].
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.model import Net


def window_starts(n: int, L: int, stride: int) -> np.ndarray:
    if n <= L:
        return np.zeros(1, np.int64)
    starts = list(range(0, n - L + 1, stride))
    if starts[-1] != n - L:
        starts.append(n - L)
    return np.asarray(starts, np.int64)


def window_predictions(net: Net, frames: np.ndarray, wav: np.ndarray,
                       starts: np.ndarray, *, fps: float, sr: int, W: int,
                       L: int, spw: int, device, chunk: int = 32
                       ) -> torch.Tensor:
    """Per-frame predictions [len(starts), L, 2] of the windows at
    ``starts`` (whole sequences of W) of frames [n, S, S, 3] uint8 and wav
    [samples]."""
    s0 = np.round(starts / fps * sr).astype(np.int64)
    fr = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    need = int(s0.max()) + spw
    wv = torch.zeros(max(need, len(wav)), dtype=torch.float32, device=device)
    wv[:len(wav)] = torch.from_numpy(np.asarray(wav, np.float32)).to(device)
    lt = torch.arange(L, device=device)
    st = torch.arange(spw, device=device)
    feats = []
    with torch.no_grad():
        for i in range(0, len(starts), chunk):
            idx = torch.as_tensor(starts[i:i + chunk], device=device)
            sidx = torch.as_tensor(s0[i:i + chunk], device=device)
            clips = fr[idx[:, None] + lt[None, :]]
            feats.append(net.window_features(clips, wv[sidx[:, None] + st]))
        preds = net.sequences(torch.cat(feats), W)
    return preds.reshape(len(starts), L, -1)


def stitch(preds: torch.Tensor, starts: np.ndarray, n: int) -> np.ndarray:
    """Each of the first ``n`` frames' mean over the windows (``preds``
    [len(starts), L, 2]) covering it, clipped to [-1, 1] → [n, 2]."""
    dev = preds.device
    L, c = preds.shape[1], preds.shape[2]
    fidx = (torch.as_tensor(starts, device=dev)[:, None]
            + torch.arange(L, device=dev)[None, :]).reshape(-1)
    keep = fidx < n
    num = torch.zeros(n, c, dtype=torch.float64, device=dev)
    den = torch.zeros(n, dtype=torch.float64, device=dev)
    num.index_add_(0, fidx[keep], preds.double().reshape(-1, c)[keep])
    den.index_add_(0, fidx[keep],
                   torch.ones_like(fidx[keep], dtype=torch.float64))
    out = num / den.clamp_min(1.0)[:, None]
    return out.clamp(-1.0, 1.0).float().cpu().numpy()


def predict_video(net: Net, frames: np.ndarray, wav: np.ndarray, *,
                  stride: int, W: int, L: int, **kw) -> np.ndarray:
    """frames [n, S, S, 3] uint8, wav [samples] → [n, 2] float32."""
    n = len(frames)
    starts = window_starts(n, L, stride)
    n_win = len(starts)
    n_pad = -(-n_win // W) * W
    padded = np.concatenate([starts, np.repeat(starts[-1:], n_pad - n_win)])
    preds = window_predictions(net, frames, wav, padded, W=W, L=L, **kw)
    return stitch(preds[:n_win], starts, n)

