"""Serving API: per-frame valence/arousal for raw videos, on the GPU.

Counterpart of ``Predictor`` in ``m3f/pytorch_tpu/infer/predictor.py``:

    p = Predictor(checkpoint="run/ckpt_00001000.npz")   # a JAX checkpoint
    out = p.predict_video(frames=jpegs_uint8, waveform=wav16k)
    out["pred"]   # [N, 2] float32 in [-1, 1], one (valence, arousal) per frame

The model runs on ``device`` ("cuda" unless the caller asks for the CPU,
as the tests do; without a GPU a CUDA Predictor raises). Client input is
validated here, so a wrong dtype or shape is a ValueError, not an error
deep in the model. Streaming sessions and the HTTP server come later.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from m3f_torch.config import FPS_BAND, PRESETS, ExperimentConfig, apply_overrides
from m3f_torch.infer.submission import postprocess
from m3f_torch.train.checkpoint import load_model_checkpoint
from m3f_torch.train.loop import Trainer


def _check_frames(frames: np.ndarray, image_size: int) -> np.ndarray:
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        raise ValueError(
            f"frames must be uint8 face crops, got dtype {frames.dtype}")
    if frames.ndim != 4 or frames.shape[1:] != (image_size, image_size, 3):
        raise ValueError(
            f"frames must be [N, {image_size}, {image_size}, 3], "
            f"got shape {frames.shape}")
    return np.ascontiguousarray(frames)


def _check_fps(fps) -> Optional[float]:
    if fps is None:
        return None
    try:
        fps = float(fps)
    except (TypeError, ValueError):
        raise ValueError(f"fps must be a number, got {fps!r}") from None
    if not FPS_BAND[0] <= fps <= FPS_BAND[1]:
        raise ValueError(f"fps {fps} outside the plausible band "
                         f"[{FPS_BAND[0]:g}, {FPS_BAND[1]:g}]")
    return fps


def _check_waveform(waveform: np.ndarray) -> np.ndarray:
    waveform = np.asarray(waveform)
    if waveform.ndim != 1:
        raise ValueError(
            f"waveform must be 1-D mono samples, got shape {waveform.shape}")
    if not np.issubdtype(waveform.dtype, np.floating) and \
            not np.issubdtype(waveform.dtype, np.integer):
        raise ValueError(f"waveform must be numeric, got {waveform.dtype}")
    return waveform.astype(np.float32, copy=False)


class Predictor:
    def __init__(self, cfg: Optional[ExperimentConfig] = None,
                 checkpoint: str = "", preset: str = "longseq_eval",
                 overrides: Optional[dict] = None, device="cuda"):
        """``cfg`` or ``preset`` (+ ``overrides``) picks the model; without a
        ``checkpoint`` the weights are the seeded random init."""
        if cfg is None:
            cfg = PRESETS[preset]()
            if overrides:
                cfg = apply_overrides(cfg, overrides)
        self.cfg = cfg
        self.trainer = Trainer(cfg, device=device)
        self.checkpoint_path = ""
        self.reload_count = 0
        if checkpoint:
            self._load(checkpoint)

    @property
    def model(self):
        return self.trainer.model

    def _prepare(self, checkpoint: str):
        """Read ``checkpoint``, check every key and shape against the model
        and upload the tensors to its device, WITHOUT touching the model:
        the expensive part of a reload, safe while the old weights serve.
        Returns (state dict on the device, step)."""
        sd, step = load_model_checkpoint(checkpoint)
        have = self.model.state_dict()
        want = {k: tuple(v.shape) for k, v in have.items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if want != got:
            missing = sorted(want.keys() - got.keys())[:5]
            extra = sorted(got.keys() - want.keys())[:5]
            shape = sorted(k for k in want.keys() & got.keys()
                           if want[k] != got[k])[:5]
            raise ValueError(f"checkpoint {checkpoint} does not fit the model: "
                             f"missing={missing} extra={extra} shape={shape}")
        return {k: v.to(device=have[k].device, dtype=have[k].dtype)
                for k, v in sd.items()}, step

    def _load(self, checkpoint: str) -> int:
        """Load ``checkpoint`` into the model; a mismatching file raises
        before anything is swapped, so the old weights keep serving."""
        sd, step = self._prepare(checkpoint)
        self.model.load_state_dict(sd)
        self.checkpoint_path = checkpoint
        return step

    def reload(self, checkpoint: str, lock=None) -> dict:
        """Swap in the weights of ``checkpoint`` (same architecture).

        The read, the checks and the upload run first, with serving
        untouched; only the swap into the module (a copy on the device)
        takes ``lock`` (any context manager; a server passes the lock its
        forwards hold, and must not hold it itself around this call). On a
        missing file or a mismatch the old weights keep serving. Returns
        {"checkpoint", "step", "reloads"} for the operator."""
        sd, step = self._prepare(checkpoint)
        with lock if lock is not None else contextlib.nullcontext():
            self.model.load_state_dict(sd)
            self.checkpoint_path = checkpoint
            self.reload_count += 1
        return {"checkpoint": checkpoint, "step": step,
                "reloads": self.reload_count}

    def _check_smooth(self, smooth_window: int):
        if self.cfg.window.eval_smooth > 1 and smooth_window > 1:
            raise ValueError(
                "window.eval_smooth and smooth_window are both set; "
                "predictions would be smoothed twice — pick one")

    def _video_dict(self, frames: Optional[np.ndarray],
                    waveform: Optional[np.ndarray],
                    fps: Optional[float] = None) -> Dict[str, np.ndarray]:
        mcfg = self.cfg.model
        fps = _check_fps(fps)
        fps_eff = fps or self.cfg.data.fps
        if frames is not None:
            frames = _check_frames(frames, self.cfg.data.image_size)
        if waveform is not None:
            waveform = _check_waveform(waveform)
        if mcfg.use_video:
            if frames is None:
                raise ValueError("model uses video; pass frames [N,S,S,3] uint8")
            n = len(frames)
        else:
            if waveform is None:
                raise ValueError("audio-only model; pass waveform")
            n = max(int(round(len(waveform) / mcfg.mel.sample_rate * fps_eff)), 1)
        if mcfg.use_audio and waveform is None:
            raise ValueError("model uses audio; pass a 16 kHz waveform")
        # no labels at inference: all invalid, they only give the frame count
        video = {"labels": np.full((n, 2), -5.0, np.float32),
                 "valid": np.zeros(n, bool)}
        if frames is not None:
            video["frames"] = frames
        if waveform is not None:
            video["waveform"] = waveform
        if fps is not None:
            video["fps"] = fps
        return video

    def predict_video(self, frames: Optional[np.ndarray] = None,
                      waveform: Optional[np.ndarray] = None,
                      smooth_window: int = 0,
                      fps: Optional[float] = None) -> Dict[str, np.ndarray]:
        """Per-frame predictions for one video.

        frames: [N, S, S, 3] uint8 face crops (S = cfg.data.image_size);
        waveform: mono float32 at cfg.model.mel.sample_rate;
        fps: the video's true frame rate when it differs from the configured
        default. Returns {"pred": [N, 2] float32 in [-1, 1]}.
        """
        self._check_smooth(smooth_window)
        out = self.trainer.evaluate_video(
            None, self._video_dict(frames, waveform, fps))
        return {"pred": postprocess(out["pred"], smooth_window=smooth_window)}

    def predict_many(self, videos: Iterable[Tuple[str, Dict[str, np.ndarray]]],
                     smooth_window: int = 0, pipeline: int = 2
                     ) -> Iterator[Tuple[str, np.ndarray]]:
        """(video_id, preds [N, 2]) for each (video_id, {frames, waveform,
        fps}) pair, in input order, with ``pipeline`` videos in flight
        (``Trainer.evaluate_stream``): the next video is prepared, uploaded
        and enqueued before the current one is read back."""
        self._check_smooth(smooth_window)
        prepared = ((vid, self._video_dict(v.get("frames"), v.get("waveform"),
                                           v.get("fps")))
                    for vid, v in videos)
        for vid, r in self.trainer.evaluate_stream(None, prepared,
                                                   pipeline=pipeline):
            yield vid, postprocess(r["pred"], smooth_window=smooth_window)
