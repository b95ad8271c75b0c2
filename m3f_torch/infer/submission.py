"""Prediction postprocess: smoothing → gap interpolation → clip.

Counterpart of the postprocess half of
``m3f/pytorch_tpu/infer/submission.py`` (numpy only); the ABAW submission
writer comes with the CLI.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from m3f_torch.ops.stitch import clip_predictions, interpolate_gaps


def smooth_predictions(preds: np.ndarray, window: int = 1) -> np.ndarray:
    """Centred moving average over the frame axis (window=1 → identity)."""
    if window <= 1:
        return preds
    k = np.ones(window, np.float32) / window
    pad = window // 2
    out = np.empty_like(preds, dtype=np.float32)
    for c in range(preds.shape[1]):
        x = np.pad(preds[:, c], pad, mode="edge")
        out[:, c] = np.convolve(x, k, mode="valid")[: len(preds)]
    return out


def postprocess(preds: np.ndarray, valid: Optional[np.ndarray] = None,
                smooth_window: int = 1) -> np.ndarray:
    """Full postprocess: smooth → interpolate gaps → clip."""
    preds = np.asarray(preds, np.float32)
    preds = smooth_predictions(preds, smooth_window)
    if valid is not None:
        preds = interpolate_gaps(preds, valid)
    return clip_predictions(preds)
