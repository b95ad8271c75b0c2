"""Whole-video sliding-window evaluation (the eval side of the Trainer).

Counterpart of the eval half of ``m3f/pytorch_tpu/train/loop.py``
(``eval_buckets``, ``_windowed_forward``, the fused whole-video eval and the
chunked eval). A video's overlapping windows are gathered on the device from
start indices, grouped into W-window sequences, run through the model, and
overlap-averaged onto the frame timeline. The padding is the reference's, so
each window reads the same frames and wav samples:

- frames padded to ``ceil(n/256)·256 + L``, windows to a multiple of
  ``W·8`` by repeating the last start (masked out of the stitch);
- wav padded or cut to the bucketed length, sample offsets
  ``round(start/fps·sr)``, and the per-video hop from ``hop_plan``;
- videos with more than ``window.eval_max_windows`` windows go in chunks of
  that many windows whose partial sums accumulate on the host.

The training side (train step, optimizer, CCC, checkpoints written) comes
with the training slice; EMA weights are chosen at load
(``train.checkpoint.load_model_checkpoint`` prefers them).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from m3f_torch.config import ExperimentConfig
from m3f_torch.infer.submission import smooth_predictions
from m3f_torch.models.m3f import M3F
from m3f_torch.nn import resolve_device
from m3f_torch.ops.stitch import (coverage_matrix, smooth_moving_average,
                                  stitch_framewise, stitch_framewise_sums,
                                  window_starts)

# window-count granularity of a dispatch, in W-window sequences: the
# reference's 8·n_data/gcd(8, n_data) with one data device
_SEQ_BUCKET = 8


class Trainer:
    """Eval-only trainer: owns the model and evaluates whole videos."""

    def __init__(self, cfg: ExperimentConfig, device="cuda"):
        if cfg.model.per_frame \
                and cfg.model.frames_per_window != cfg.window.window_frames:
            raise ValueError(
                f"window.window_frames={cfg.window.window_frames} but "
                f"model.frames_per_window={cfg.model.frames_per_window} — "
                "these must match")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = M3F(cfg.model, device=self.device,
                         generator=torch.Generator().manual_seed(cfg.train.seed))

    def _win_bucket(self) -> int:
        return self.cfg.window.windows_per_clip * _SEQ_BUCKET

    def eval_buckets(self, n_frames: int) -> Optional[Tuple[int, int]]:
        """(n_frames_pad, n_win_pad) of the fused eval for an ``n_frames``
        video, or None when it goes through the chunked eval."""
        wcfg = self.cfg.window
        L = wcfg.window_frames
        n_win = len(window_starts(n_frames, L, wcfg.eval_stride))
        if wcfg.eval_max_windows and n_win > wcfg.eval_max_windows:
            return None
        wb = self._win_bucket()
        n_win_pad = -(-max(n_win, 1) // wb) * wb
        n_frames_pad = -(-n_frames // 256) * 256 + L
        return n_frames_pad, n_win_pad

    def _windowed_forward(self, starts: np.ndarray, sample_starts: np.ndarray,
                          frames: Optional[torch.Tensor],
                          wav: Optional[torch.Tensor], spw: int,
                          hop: Optional[int]) -> torch.Tensor:
        """Gather each window's frames / samples on the device, group them
        into W-window sequences and run the model → [Nw/W, W, L, 2]."""
        L = self.cfg.window.window_frames
        W = self.cfg.window.windows_per_clip
        n_win = len(starts)
        dev = self.device
        feed = {}
        if frames is not None:
            idx = torch.as_tensor(starts, device=dev).long()[:, None] \
                + torch.arange(L, device=dev)[None, :]
            win = frames[idx]                                 # [Nw, L, S, S, 3]
            feed["video"] = win.reshape((n_win // W, W) + win.shape[1:])
        if wav is not None:
            sidx = torch.as_tensor(sample_starts, device=dev).long()[:, None] \
                + torch.arange(spw, device=dev)[None, :]
            feed["wav"] = wav[sidx].reshape(n_win // W, W, spw)
        return self.model(video=feed.get("video"), wav=feed.get("wav"), hop=hop)

    def _plan(self, video: Dict[str, np.ndarray]):
        mcfg = self.cfg.model
        fps = float(video.get("fps") or self.cfg.data.fps)
        hop_e, dyn, _, spw = mcfg.hop_plan(fps, self.cfg.data.fps)
        return fps, (hop_e if dyn else None), spw

    def _wav_need(self, n_frames: int, fps: float, spw: int) -> int:
        sr = self.cfg.model.mel.sample_rate
        need = int(round(n_frames / fps * sr)) + spw
        if fps != self.cfg.data.fps:
            need = -(-need // sr) * sr + spw
        return need

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @torch.no_grad()
    def evaluate_video(self, video: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Sliding-window eval of one video (``labels`` gives the frame
        count; ``frames``, ``waveform``, ``fps`` as the model needs) →
        {"pred": [n, 2] stitched, smoothed (``window.eval_smooth``) and
        clipped}."""
        wcfg = self.cfg.window
        n = len(video["labels"])
        starts = window_starts(n, wcfg.window_frames, wcfg.eval_stride)
        if wcfg.eval_max_windows and len(starts) > wcfg.eval_max_windows:
            return {"pred": self._evaluate_chunked(video, starts)}
        return {"pred": self._evaluate_fused(video, starts)}

    def _evaluate_fused(self, video, starts: np.ndarray) -> np.ndarray:
        wcfg, mcfg = self.cfg.window, self.cfg.model
        L = wcfg.window_frames
        sr = mcfg.mel.sample_rate
        n = len(video["labels"])
        n_win = len(starts)
        n_frames_pad, n_win_pad = self.eval_buckets(n)
        starts_p = np.concatenate([starts,
                                   np.repeat(starts[-1:], n_win_pad - n_win)])
        fps, hop, spw = self._plan(video)
        frames = wav = None
        if mcfg.use_video:
            f = video["frames"]
            frames = self._to_device(
                np.pad(f, [(0, n_frames_pad - len(f))] + [(0, 0)] * 3))
        if mcfg.use_audio:
            need = self._wav_need(n_frames_pad, fps, spw)
            w = video["waveform"]
            wav = self._to_device(
                np.pad(w, (0, max(0, need - len(w))))[:need].astype(np.float32))
        sample_starts = np.round(starts_p / fps * sr).astype(np.int32)
        preds = self._windowed_forward(starts_p, sample_starts, frames, wav,
                                       spw, hop)
        st = self._to_device(starts_p)
        win_valid = torch.arange(n_win_pad, device=self.device) < n_win
        if mcfg.per_frame:
            stitched = stitch_framewise(preds.reshape(n_win_pad, L, -1), st,
                                        n_frames_pad, win_valid)
        else:
            m = coverage_matrix(st, n_frames_pad, L) * win_valid[None, :].float()
            num = m @ preds.reshape(n_win_pad, -1).float()
            stitched = num / torch.clamp_min(m.sum(1, keepdim=True), 1.0)
        if wcfg.eval_smooth > 1:
            # edge-extend the last real frame over the bucket padding so the
            # smoother sees the host smoother's edge padding, not zeros
            fidx = torch.arange(n_frames_pad, device=self.device)
            last = stitched[max(n - 1, 0)]
            stitched = smooth_moving_average(
                torch.where((fidx < n)[:, None], stitched, last[None, :]),
                wcfg.eval_smooth)
        return torch.clamp(stitched, -1.0, 1.0)[:n].cpu().numpy()

    def _evaluate_chunked(self, video, starts: np.ndarray) -> np.ndarray:
        """Bounded window chunks with fixed geometry; partial stitch sums
        accumulate on the host (summation is associative where per-chunk
        averages are not)."""
        wcfg, mcfg = self.cfg.window, self.cfg.model
        L = wcfg.window_frames
        sr = mcfg.mel.sample_rate
        fps, hop, spw = self._plan(video)
        n = len(video["labels"])
        wb = self._win_bucket()
        M = -(-wcfg.eval_max_windows // wb) * wb
        span = (M - 1) * wcfg.eval_stride + L
        local_nf = -(-span // 256) * 256 + L
        need_wav = self._wav_need(local_nf, fps, spw)
        frames = video.get("frames") if mcfg.use_video else None
        wav = video.get("waveform") if mcfg.use_audio else None
        num = np.zeros((n + local_nf, 2), np.float32)
        den = np.zeros((n + local_nf,), np.float32)
        for i0 in range(0, len(starts), M):
            sub = starts[i0:i0 + M]
            f0 = int(sub[0])
            sub_p = np.concatenate([sub, np.repeat(sub[-1:], M - len(sub))])
            fr = wv = None
            if frames is not None:
                seg = frames[f0:f0 + local_nf]
                fr = self._to_device(
                    np.pad(seg, [(0, local_nf - len(seg))] + [(0, 0)] * 3))
            w0 = 0
            if wav is not None:
                w0 = int(np.round(f0 / fps * sr))
                seg = wav[w0:w0 + need_wav]
                wv = self._to_device(
                    np.pad(seg, (0, need_wav - len(seg))).astype(np.float32))
            sstarts = (np.round(sub_p / fps * sr) - w0).astype(np.int32)
            local = (sub_p - f0).astype(np.int32)
            preds = self._windowed_forward(local, sstarts, fr, wv, spw, hop)
            valid = torch.arange(M, device=self.device) < len(sub)
            st = self._to_device(local)
            if mcfg.per_frame:
                pn, pd = stitch_framewise_sums(preds.reshape(M, L, -1), st,
                                               local_nf, valid)
            else:
                m = coverage_matrix(st, local_nf, L) * valid[None, :].float()
                pn, pd = m @ preds.reshape(M, -1).float(), m.sum(1)
            num[f0:f0 + local_nf] += pn.cpu().numpy()
            den[f0:f0 + local_nf] += pd.cpu().numpy()
        stitched = num[:n] / np.maximum(den[:n, None], 1.0)
        if wcfg.eval_smooth > 1:
            stitched = smooth_predictions(stitched, wcfg.eval_smooth)
        return np.clip(stitched, -1.0, 1.0)
