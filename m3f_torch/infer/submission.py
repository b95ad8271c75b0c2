"""Prediction postprocess and the ABAW challenge submission writer.

Counterpart of ``m3f/pytorch_tpu/infer/submission.py`` (numpy only):
stitched per-frame predictions → optional moving-average smoothing →
linear interpolation of frames with no valid prediction → clip to [-1, 1]
→ one ``<video_id>.txt`` per video in a flat directory: the header
``valence,arousal``, then one ``v,a`` row per frame, each value ``:.6f``,
``\n`` line endings. The files are byte for byte the reference's for the
same predictions (the reference's module lists its assumptions about the
server's format).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

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


def write_video_txt(path: str, preds: np.ndarray) -> None:
    """One submission file: the ``valence,arousal`` header and a row per
    frame."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("valence,arousal\n")
        for v, a in preds:
            f.write(f"{v:.6f},{a:.6f}\n")


def write_submission(out_dir: str, per_video_preds: Dict[str, np.ndarray],
                     per_video_valid: Optional[Dict[str, np.ndarray]] = None,
                     smooth_window: int = 1) -> None:
    """``<video_id>.txt`` in ``out_dir`` for each video, its predictions
    through ``postprocess`` (with the video's ``valid`` frames, if given)."""
    for vid, preds in per_video_preds.items():
        valid = per_video_valid.get(vid) if per_video_valid else None
        write_video_txt(os.path.join(out_dir, vid + ".txt"),
                        postprocess(preds, valid, smooth_window))
