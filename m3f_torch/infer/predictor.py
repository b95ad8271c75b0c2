"""Serving API: per-frame valence/arousal for raw videos, on the GPU.

Counterpart of ``m3f/pytorch_tpu/infer/predictor.py``:

    p = Predictor(checkpoint="run/ckpt_00001000.npz")   # a JAX checkpoint
    out = p.predict_video(frames=jpegs_uint8, waveform=wav16k)
    out["pred"]   # [N, 2] float32 in [-1, 1], one (valence, arousal) per frame

    sess = p.stream()                     # a live capture, pushed as it comes
    start, preds = sess.push(frames=chunk, waveform=audio_chunk)

    group = SessionGroup(p)               # many live captures, one forward
    outs = group.push_many({s0: {...}, s1: {...}})

The model runs on ``device`` ("cuda" unless the caller asks for the CPU,
as the tests do; without a GPU a CUDA Predictor raises). Client input is
validated here, so a wrong dtype or shape is a ValueError, not an error
deep in the model. The HTTP server is ``infer/server.py``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from m3f_torch.config import FPS_BAND, PRESETS, ExperimentConfig, apply_overrides
from m3f_torch.infer.submission import postprocess
from m3f_torch.ops.stitch import window_starts
from m3f_torch.train.checkpoint import read_model_checkpoint
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
        self._fwd = None                  # the streams' group forward
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
        sd, step = read_model_checkpoint(checkpoint)
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

    def _eval_forward(self):
        if self._fwd is None:
            self._fwd = self.trainer.make_eval_forward()
        return self._fwd

    def stream(self, fps: Optional[float] = None) -> "StreamingSession":
        """Open an online session: push frames / audio as they arrive and
        receive per-frame (valence, arousal) with bounded latency. ``fps``:
        the capture's true frame rate when it differs from the configured
        default. See StreamingSession."""
        if self.cfg.window.eval_smooth > 1:
            # a centred smoother needs future frames; skipping it would
            # break the session's equality with the offline path
            raise ValueError(
                "window.eval_smooth > 1 cannot apply to streaming sessions "
                "(centered smoothing needs future frames) — smooth the "
                "emitted stream downstream, or use eval_smooth=1")
        return StreamingSession(self, fps=_check_fps(fps))

    def warmup(self, max_frames: int = 1024,
               rates: Tuple[float, ...] = ()) -> None:
        """Run every input shape a live request up to ``max_frames`` frames
        can bring once, before serving: on the card the first call of a
        kernel builds it (``nvcc``, seconds) and the first call of a shape
        sets up cuDNN's and the allocator's state for it, so no live request
        pays for either.

        The whole-video eval pads a video to a (frame bucket, window bucket)
        signature (``Trainer.eval_buckets``); both buckets do not move in
        lockstep, so every real signature up to ``max_frames`` is run, plus
        one video past ``window.eval_max_windows`` for the chunked eval,
        whose shapes do not depend on the length. ``rates``: other frame
        rates clients send (``?fps=R``); each is run over the same videos
        (its wav is sized by its own clock, and an off-rate video takes the
        dynamic-hop mel route). Last, one stream's group forward, and one
        off-rate stream's when a rate takes the dynamic hop (every off-rate
        session shares its shapes). SessionGroup.warmup runs the batched
        group forwards."""
        sr, fps = self.cfg.model.mel.sample_rate, self.cfg.data.fps
        seen = set()
        reps = []
        chunked_rep = 0
        L = self.cfg.window.window_frames
        for n in range(L, max_frames + 1):
            sig = self.trainer.eval_buckets(n)
            if sig is None:
                chunked_rep = chunked_rep or n
            elif sig not in seen:
                seen.add(sig)
                reps.append(n)
        if chunked_rep:
            reps.append(chunked_rep)
        if not self.cfg.model.use_audio:
            rates = ()   # only the audio side varies with the rate
        for r in (None,) + tuple(rates):
            r_eff = r or fps
            for n in reps:
                kw = {}
                if self.cfg.model.use_video:
                    S = self.cfg.data.image_size
                    kw["frames"] = np.zeros((n, S, S, 3), np.uint8)
                if self.cfg.model.use_audio:
                    # exactly n frames' worth: an audio-only model counts
                    # its frames from the waveform's length
                    kw["waveform"] = np.zeros(
                        int(round(n / r_eff * sr)), np.float32)
                self.predict_video(fps=r, **kw)
        if self.cfg.model.per_frame and self.cfg.window.eval_smooth <= 1:
            stream_rates = [None]
            dyn = [r for r in rates if self.cfg.model.hop_plan(r, fps)[1]]
            if dyn:
                stream_rates.append(dyn[0])
            for r in stream_rates:
                sess = self.stream(fps=r)
                n = (sess.W - 1) * sess.stride + sess.L
                if self.cfg.model.use_video:
                    S = self.cfg.data.image_size
                    sess.push(frames=np.zeros((n, S, S, 3), np.uint8))
                if self.cfg.model.use_audio:
                    sess.push(waveform=np.zeros(
                        sess._sample_start(n) + sess.spw, np.float32))
                sess.flush()

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


class StreamingSession:
    """Online per-frame inference over a growing stream (live serving).

    Frames and audio are pushed as they arrive; each frame's (valence,
    arousal) is emitted as soon as no later window can still cover it, at
    most ``latency_frames`` = (W−1)·stride + L frames behind the stream.
    The semantics are the offline path's: the same window grid, the same
    W-window GRU sequences, the same overlap averaging and clip. Each
    complete group of W windows runs through ``Trainer.make_eval_forward``
    as a batch of one sequence; the stitch runs on the host, since a group
    touches a handful of frames.

        sess = predictor.stream()
        for frames_chunk, audio_chunk in capture():
            start, preds = sess.push(frames=frames_chunk, waveform=audio_chunk)
            emit(start, preds)                  # [k, 2], possibly empty
        start, preds = sess.flush()             # tail windows, final frames

    Weights: the forwards use the model's own parameters, which
    ``Predictor.reload(checkpoint, lock)`` swaps in place under ``lock``. A
    caller that reloads while sessions push runs each ``push`` / ``flush``
    (and each ``SessionGroup.push_many`` tick) under that same lock, so all
    forwards of one push see one set of weights; the HTTP server does.
    Buffers are trimmed as windows are consumed, so a session runs for
    hours in memory bounded by its latency.
    """

    def __init__(self, predictor: Predictor, fps: Optional[float] = None):
        cfg = predictor.cfg
        if not cfg.model.per_frame:
            raise ValueError("streaming needs per-frame predictions "
                             "(model.per_frame)")
        self.p = predictor
        self.use_video = cfg.model.use_video
        self.use_audio = cfg.model.use_audio
        self.W = cfg.window.windows_per_clip
        self.L = cfg.window.window_frames
        self.stride = cfg.window.eval_stride
        self.S = cfg.data.image_size
        # the capture's true rate: a session at the nominal rate feeds
        # [1, W, spw] wav with the fixed hop; an off-rate one its own mel
        # hop over a max-hop-sized buffer (spw_buf), shared by every rate
        self.fps = float(fps or cfg.data.fps)
        self.sr = cfg.model.mel.sample_rate
        self.hop, self.dynamic_hop, self.spw, self.spw_buf = \
            cfg.model.hop_plan(self.fps, cfg.data.fps)
        self._fwd = predictor._eval_forward()
        # _f0 / _s0 / _a0: absolute frame / sample / frame index of the
        # start of the frame buffer, the wav buffer and the accumulators
        self._frames: Optional[np.ndarray] = (
            np.zeros((0, self.S, self.S, 3), np.uint8) if self.use_video
            else None)
        self._f0 = 0
        self._wav = np.zeros((0,), np.float32)
        self._s0 = 0
        self._nwin = 0                      # grid windows processed so far
        self._num = np.zeros((0, 2), np.float32)   # stitch accumulators
        self._den = np.zeros((0,), np.float32)
        self._a0 = 0
        self._emitted = 0
        self._flushed = False

    @property
    def latency_frames(self) -> int:
        return (self.W - 1) * self.stride + self.L

    def _n_frames(self) -> int:
        if self.use_video:
            return self._f0 + len(self._frames)
        return int(round((self._s0 + len(self._wav)) / self.sr * self.fps))

    def _sample_start(self, start: int) -> int:
        return int(round(start / self.fps * self.sr))

    def _window_ready(self, k: int) -> bool:
        start = k * self.stride
        if start + self.L > self._n_frames():
            return False
        if self.use_audio and \
                self._sample_start(start) + self.spw > self._s0 + len(self._wav):
            return False
        return True

    def _group_feed(self, starts: np.ndarray,
                    frames: Optional[np.ndarray], f_base: int,
                    wav: np.ndarray, s_base: int) -> Dict[str, np.ndarray]:
        """One W-window group's model inputs (shape [W, ...]); ``starts``
        are absolute frame indices, ``frames`` / ``wav`` start at absolute
        frame ``f_base`` / sample ``s_base``."""
        feed = {}
        if self.use_video:
            idx = (starts[:, None] - f_base) + np.arange(self.L)[None, :]
            feed["video"] = frames[idx]                    # [W, L, S, S, 3]
        if self.use_audio:
            sidx = (np.asarray([self._sample_start(s) - s_base
                                for s in starts])[:, None]
                    + np.arange(self.spw)[None, :])
            sw = wav[sidx].astype(np.float32)              # [W, spw]
            if self.spw_buf > self.spw:
                sw = np.pad(sw, ((0, 0), (0, self.spw_buf - self.spw)))
            feed["wav"] = sw
            if self.dynamic_hop:
                # 0-d: lifted to [1] for one session, stacked to [b] by
                # SessionGroup
                feed["hop"] = np.full((), self.hop, np.int32)
        return feed

    def _forward(self, feed: Dict[str, np.ndarray]) -> np.ndarray:
        """One group through the model, a batch of one → [W, L, 2]."""
        return self._fwd({k: v[None] for k, v in feed.items()}) \
            .float().cpu().numpy()[0]

    def _apply_group(self, preds: np.ndarray, starts: np.ndarray,
                     win_valid: np.ndarray) -> None:
        """Scatter one group's [W, L, 2] predictions into the accumulators."""
        hi = int(starts.max()) + self.L - self._a0
        if hi > len(self._num):
            grow = hi - len(self._num)
            self._num = np.concatenate(
                [self._num, np.zeros((grow, 2), np.float32)])
            self._den = np.concatenate(
                [self._den, np.zeros((grow,), np.float32)])
        for w in range(self.W):
            if not win_valid[w]:
                continue
            f0 = int(starts[w]) - self._a0     # >= 0: windows never reach
            self._num[f0:f0 + self.L] += preds[w]   # back into emitted rows
            self._den[f0:f0 + self.L] += 1.0

    def _emit(self, hi: int) -> Tuple[int, np.ndarray]:
        lo = self._emitted
        hi = max(hi, lo)
        out = self._num[lo - self._a0:hi - self._a0] / \
            np.maximum(self._den[lo - self._a0:hi - self._a0, None], 1.0)
        self._emitted = hi
        # emitted rows are never written again
        self._num = self._num[hi - self._a0:]
        self._den = self._den[hi - self._a0:]
        self._a0 = hi
        return lo, np.clip(out, -1.0, 1.0)

    def _trim_inputs(self) -> None:
        """Drop the frames and samples no later window (the grid from
        ``_nwin`` on, or flush's clamped tail ≥ n − L) can read."""
        keep_f = max(self._f0, min(self._nwin * self.stride,
                                   self._n_frames() - self.L))
        if self.use_video and keep_f > self._f0:
            self._frames = self._frames[keep_f - self._f0:]
            self._f0 = keep_f
        if self.use_audio:
            keep_s = max(self._s0, self._sample_start(keep_f))
            if keep_s > self._s0:
                self._wav = self._wav[keep_s - self._s0:]
                self._s0 = keep_s

    def _append(self, frames: Optional[np.ndarray],
                waveform: Optional[np.ndarray]) -> None:
        # atomic: every input is checked before any buffer changes, so a
        # refused push leaves the session as it was (SessionGroup's
        # per-session isolation relies on it)
        if self._flushed:
            raise ValueError("session already flushed")
        if frames is not None:
            if not self.use_video:
                raise ValueError("audio-only model: push waveform only")
            frames = _check_frames(frames, self.S)
        if waveform is not None:
            # a video-only model never trims the wav buffer, so buffering
            # audio there would grow without bound
            if not self.use_audio:
                raise ValueError("video-only model: push frames only")
            waveform = _check_waveform(waveform)
        if frames is not None:
            self._frames = np.concatenate([self._frames, frames])
        if waveform is not None:
            self._wav = np.concatenate([self._wav, waveform])

    def _collect_ready(self) -> List[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
        """Advance the grid over every complete ready W-window group and
        return [(starts, feed)] with the inputs gathered (shape [W, ...]);
        the buffers are trimmed afterwards. Shared by ``push`` and
        SessionGroup's batched forward."""
        out = []
        while all(self._window_ready(self._nwin + i) for i in range(self.W)):
            starts = ((self._nwin + np.arange(self.W))
                      * self.stride).astype(np.int64)
            out.append((starts, self._group_feed(
                starts, self._frames, self._f0, self._wav, self._s0)))
            self._nwin += self.W
        self._trim_inputs()
        return out

    def _emit_final(self) -> Tuple[int, np.ndarray]:
        if self._nwin == 0:
            return self._emitted, np.zeros((0, 2), np.float32)
        # every later window (grid or flush's clamped tail) starts after
        # (nwin-1)*stride, so the frames up to there are final
        return self._emit((self._nwin - 1) * self.stride + 1)

    def push(self, frames: Optional[np.ndarray] = None,
             waveform: Optional[np.ndarray] = None) -> Tuple[int, np.ndarray]:
        """Append stream data; returns (first_frame_index, preds [k, 2])
        for the frames this push finalized (k may be 0)."""
        self._append(frames, waveform)
        for starts, feed in self._collect_ready():
            self._apply_group(self._forward(feed), starts,
                              np.ones(self.W, bool))
        return self._emit_final()

    def flush(self) -> Tuple[int, np.ndarray]:
        """End of stream: run the remaining windows (with the clamped tail
        the offline grid uses) and return every remaining frame."""
        if self._flushed:
            raise ValueError("session already flushed")
        self._flushed = True
        n = self._n_frames()
        if n == 0 and not self.use_video and len(self._wav) > 0:
            n = 1   # as offline: a sub-frame waveform is one frame
        if n == 0:
            return self._emitted, np.zeros((0, 2), np.float32)
        if self.use_audio and len(self._wav) == 0:
            raise ValueError("model uses audio but no waveform was pushed")
        starts_full = window_starts(n, self.L, self.stride).astype(np.int64)
        rem = starts_full[self._nwin:]
        if len(rem):
            # pad the last partial group as the offline path does: the
            # last start repeated with win_valid False (padding windows sit
            # inside the same GRU sequence, so they must be present)
            n_pad = -(-len(rem) // self.W) * self.W
            win_valid = np.arange(n_pad) < len(rem)
            rem = np.concatenate([rem, np.repeat(rem[-1:], n_pad - len(rem))])
            # _trim_inputs kept everything from min(grid, n−L) on, so the
            # buffers cover every remaining window; zero-pad their tails
            hi_frame = int(rem.max()) + self.L
            frames = self._frames
            if self.use_video and hi_frame - self._f0 > len(frames):
                frames = np.concatenate([frames, np.zeros(
                    (hi_frame - self._f0 - len(frames), self.S, self.S, 3),
                    np.uint8)])
            wav = self._wav
            if self.use_audio:
                need = self._sample_start(int(rem.max())) + self.spw - self._s0
                if need > len(wav):
                    wav = np.concatenate(
                        [wav, np.zeros(need - len(wav), np.float32)])
            for g in range(0, len(rem), self.W):
                starts = rem[g:g + self.W]
                feed = self._group_feed(starts, frames, self._f0, wav,
                                        self._s0)
                self._apply_group(self._forward(feed), starts,
                                  win_valid[g:g + self.W])
        return self._emit(n)


class SessionGroup:
    """Batched serving of many concurrent streaming sessions.

    A server holding many live streams pushes each tick's arrivals through
    ``push_many``: every session's ready W-window groups are gathered and
    run as one [k, W, ...] forward (k padded up to a power of two, so a few
    shapes cover any concurrency), then scattered back to their sessions.
    Each session's result is the inline path's up to the batch's effect on
    the summation order of the convolutions and matmuls.

        group = SessionGroup(predictor)
        sessions = [group.open() for _ in streams]
        # each capture tick:
        outs = group.push_many({s0: dict(frames=f0, waveform=w0),
                                s1: dict(frames=f1, waveform=w1)})
        # outs[s0] == (first_frame_index, preds [k, 2])

    Per-session latency is unchanged (same window grid, same bounded
    buffers); ``flush(session)`` ends one stream on its own. Weights: as
    StreamingSession's, a concurrent reload takes the lock each tick runs
    under.
    """

    def __init__(self, predictor: Predictor, max_batch: int = 16):
        self.p = predictor
        self.max_batch = max_batch
        self._fwd = predictor._eval_forward()

    def open(self, fps: Optional[float] = None) -> StreamingSession:
        return self.p.stream(fps=fps)

    @staticmethod
    def _bucket(k: int) -> int:
        b = 1
        while b < k:
            b *= 2
        return b

    def warmup(self, rates: Tuple[float, ...] = ()) -> None:
        """Run every power-of-two batch ([b, W, ...], b up to
        ``_bucket(max_batch)``, which ``push_many`` pads to) once before
        serving, so a tick that first reaches a batch size does not set up
        its shapes while every waiting stream holds. ``rates``: expected
        off-nominal session rates; their sessions feed the dynamic-hop
        schema (max-hop wav buffer and a per-entry hop), one schema for all
        of them, so one more pass over the buckets covers them."""
        cfg = self.p.cfg
        if not cfg.model.per_frame or cfg.window.eval_smooth > 1:
            return                      # stream() would refuse to open
        probes = [self.p.stream()]      # geometry only; never pushed
        dyn = [r for r in rates if cfg.model.hop_plan(r, cfg.data.fps)[1]]
        if dyn:
            probes.append(self.p.stream(fps=dyn[0]))
        for probe in probes:
            W, L, S = probe.W, probe.L, probe.S
            b, top = 1, self._bucket(self.max_batch)
            while b <= top:
                feed = {}
                if cfg.model.use_video:
                    feed["video"] = np.zeros((b, W, L, S, S, 3), np.uint8)
                if cfg.model.use_audio:
                    feed["wav"] = np.zeros((b, W, probe.spw_buf), np.float32)
                    if probe.dynamic_hop:
                        feed["hop"] = np.full((b,), probe.hop, np.int32)
                self._fwd(feed).cpu()
                b *= 2

    def push_many(self, pushes: Dict[StreamingSession, Dict[str, np.ndarray]],
                  errors: Optional[Dict[StreamingSession, Exception]] = None
                  ) -> Dict[StreamingSession, Tuple[int, np.ndarray]]:
        """Push one tick of data for several sessions; returns each
        session's newly finalized (first_frame_index, preds [k, 2]).

        A session whose append fails (wrong modality, shape or dtype,
        already flushed) leaves the others alone and is left as it was
        (``_append`` is atomic). Every session whose groups were collected
        has them forwarded: ``_collect_ready`` advanced its grid and trimmed
        its buffers, so dropping them would lose its output for good. With
        ``errors`` given, failures are recorded there (session → exception)
        and those sessions are left out of the result; without it, the first
        failure is raised after the collected groups were forwarded."""
        pending = []                    # (session, starts, feed)
        failed: Dict[StreamingSession, Exception] = {}
        for sess, data in pushes.items():
            try:
                sess._append(data.get("frames"), data.get("waveform"))
                groups = sess._collect_ready()
            except ValueError as e:
                failed[sess] = e
                continue
            for starts, feed in groups:
                pending.append((sess, starts, feed))
        # fixed-hop and dynamic-hop sessions feed different schemas (wav
        # width spw against the max-hop buffer, plus the hop), so each runs
        # in its own batches; off-rate sessions at any rates share one
        for part in ([p for p in pending if "hop" not in p[2]],
                     [p for p in pending if "hop" in p[2]]):
            self._forward_chunks(part)
        if failed and errors is None:
            # raise before emitting: the healthy sessions keep their final
            # frames buffered (the next push or flush returns them)
            raise next(iter(failed.values()))
        outs = {sess: sess._emit_final()
                for sess in pushes if sess not in failed}
        if failed:
            errors.update(failed)
        return outs

    def _forward_chunks(self, pending) -> None:
        """Run one schema's pending groups in bucketed batches and scatter
        each group's predictions back to its session."""
        for i in range(0, len(pending), self.max_batch):
            chunk = pending[i:i + self.max_batch]
            k = len(chunk)
            b = self._bucket(k)
            feed = {key: np.stack([c[2][key] for c in chunk]
                                  + [chunk[0][2][key]] * (b - k))
                    for key in chunk[0][2]}
            preds = self._fwd(feed).float().cpu().numpy()
            for (sess, starts, _), pred in zip(chunk, preds[:k]):
                sess._apply_group(pred, starts, np.ones(sess.W, bool))

    def flush(self, sess: StreamingSession) -> Tuple[int, np.ndarray]:
        return sess.flush()
