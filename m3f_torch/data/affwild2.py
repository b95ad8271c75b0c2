"""Aff-Wild2 dataset indexing and loading.

Counterpart of ``m3f/pytorch_tpu/data/affwild2.py``, and held equal to it
(ids, frame counts, frame rates and every loaded array) by
``tests/test_torch_affwild2.py``. Expected on-disk layout (the ABAW
challenge distribution):

    <root>/cropped_aligned/<video_id>/00001.jpg …      112×112 face crops
    <root>/annotations/VA_Estimation_Challenge/
        Train_Set/<video_id>.txt                        header + "v,a" per frame
        Validation_Set/<video_id>.txt
    <root>/audio/<video_id>.wav                         16 kHz mono (ffmpeg-extracted)
    <root>/videos/<video_id>.{mp4,avi,mkv}              optional containers

The loader emits raw waveforms (the mel frontend runs on the card) and
uint8 RGB frames decoded on the host by the port's native loader
(``data/native_loader.py``). Frames with annotation value -5 (or with a
missing crop JPEG) are invalid: they stay in the window stream but are
masked out of the loss and the metrics.
"""

from __future__ import annotations

import os
import wave
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from m3f_torch.config import FPS_BAND, INVALID_LABEL, DataConfig, MelConfig


def read_wav_16k_mono(path: str,
                      expected_rate: Optional[int] = None) -> np.ndarray:
    """Minimal WAV reader (PCM16/PCM32) → float32 in [-1, 1].

    stdlib only (the ``wave`` module); ffmpeg extraction upstream produces
    standard PCM16.

    ``expected_rate``: when given, a mismatched sample rate raises instead
    of silently desynchronizing audio from the video frames (every window's
    sample offset is computed as frame/fps·sample_rate — a 44.1 kHz file
    would feed ~2.8× too-fast audio with no error anywhere downstream).
    """
    with wave.open(path, "rb") as w:
        assert w.getnchannels() == 1, f"{path}: expected mono"
        if expected_rate is not None and w.getframerate() != expected_rate:
            raise ValueError(
                f"{path}: sample rate {w.getframerate()} != expected "
                f"{expected_rate} (mel.sample_rate) — re-extract with "
                "scripts/extract_audio.py (ffmpeg -ar "
                f"{expected_rate} -ac 1)")
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sw == 2:
        return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    if sw == 4:
        return np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    raise ValueError(f"{path}: unsupported sample width {sw}")


def read_annotation_txt(path: str) -> np.ndarray:
    """ABAW VA annotation file → [N, 2] float32 (valence, arousal)."""
    rows: List[List[float]] = []
    with open(path) as f:
        header = f.readline()  # "valence,arousal"
        for line in f:
            line = line.strip()
            if line:
                v, a = line.split(",")
                rows.append([float(v), float(a)])
    return np.asarray(rows, dtype=np.float32)


@dataclass
class AffWild2Dataset:
    cfg: DataConfig
    mel: MelConfig
    split: str = "train"   # "train" | "val" | "test"

    def __post_init__(self):
        self.size = self.cfg.image_size
        ann_root = os.path.join(
            self.cfg.root, "annotations", "VA_Estimation_Challenge")
        self._ids: List[str] = []
        if self.split == "test":
            # ABAW test distribution: crop dirs WITHOUT annotation txts
            # (the server holds the labels). Everything under cropped_aligned
            # that has no Train/Validation annotation is a test video.
            self._ann_dir = None
            labeled = set()
            for s in ("Train_Set", "Validation_Set"):
                d = os.path.join(ann_root, s)
                if os.path.isdir(d):
                    labeled |= {os.path.splitext(f)[0] for f in os.listdir(d)
                                if f.endswith(".txt")}
            crops = os.path.join(self.cfg.root, "cropped_aligned")
            if os.path.isdir(crops):
                self._ids = sorted(d for d in os.listdir(crops)
                                   if os.path.isdir(os.path.join(crops, d))
                                   and d not in labeled)
        else:
            self._ann_dir = os.path.join(
                ann_root,
                "Train_Set" if self.split == "train" else "Validation_Set")
            if os.path.isdir(self._ann_dir):
                self._ids = sorted(
                    os.path.splitext(f)[0] for f in os.listdir(self._ann_dir)
                    if f.endswith(".txt"))

    def video_ids(self) -> List[str]:
        return self._ids

    def _crop_dir(self, video_id: str) -> str:
        return os.path.join(self.cfg.root, "cropped_aligned", video_id)

    def num_frames(self, video_id: str) -> int:
        """Frame count WITHOUT decoding any JPEG/audio — annotation row
        count (train/val) or crop-dir/container scan (test). Lets the
        exact-resume stream skip (data/windowing.py) fast-forward past a
        video for the cost of one small text read."""
        if self._ann_dir is None:
            return self._test_frame_count(video_id)
        with open(os.path.join(self._ann_dir, video_id + ".txt")) as f:
            f.readline()  # header
            return sum(1 for line in f if line.strip())

    def _test_frame_count(self, video_id: str) -> int:
        """Test-split timeline length: max crop stem (1-based 5-digit), or
        the raw container's frame count when present — crop dropout at the
        END of a video must not shorten the submission."""
        crop_dir = self._crop_dir(video_id)
        stems = [int(os.path.splitext(f)[0])
                 for f in os.listdir(crop_dir)
                 if f.endswith(".jpg") and os.path.splitext(f)[0].isdigit()]
        n = max(stems) if stems else 0
        for ext in (".mp4", ".avi", ".mkv"):
            vp = os.path.join(self.cfg.root, "videos", video_id + ext)
            if os.path.exists(vp):
                try:
                    import cv2
                    cap = cv2.VideoCapture(vp)
                    if cap.isOpened():
                        n = max(n, int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
                    cap.release()
                except Exception:
                    pass
                break
        return n

    # -- per-video frame rate ------------------------------------------------
    #
    # Aff-Wild2 is in-the-wild: videos are NOT uniformly 30 fps ("30 fps" is
    # the typical case, not an invariant). Every audio↔frame alignment
    # downstream derives sample offsets as frame / fps · sample_rate, so a
    # 25 fps video fed with the global 30 fps constant desynchronizes its
    # audio by 20% with no error anywhere. The true rate is derivable with zero
    # extra decode work: container metadata when videos/ exists, else
    # annotation rows / wav duration (both files are already read).

    FPS_BAND = FPS_BAND   # re-exported (definition lives in config.py so
                          # the serving validator shares it)

    def video_fps(self, video_id: str,
                  n_frames: Optional[int] = None) -> float:
        """True frame rate of one video, cached; falls back to cfg.fps.

        Priority: container probe (cv2, header only) → annotation-rows /
        wav-duration (wav HEADER only, no sample read) → ``cfg.fps``.
        Estimates outside FPS_BAND fall through to the next source.

        Each source gets its own snap-to-``cfg.fps`` rule, because their
        error models differ:

        - **container**: authoritative up to float fuzz — snap only when the
          end-of-video drift is under half a mel hop (then no window's
          sample offset can shift by even one hop and the video stays on
          the canonical warmup-compiled shape buckets); genuine 29.97 NTSC
          stays distinct wherever its ~0.1% skew accumulates past a hop.
        - **wav duration**: an ESTIMATE biased by however much the audio
          stream outlasts the video (AAC decoder padding alone adds tens of
          ms to every ffmpeg-extracted wav; a source whose audio runs past
          the last frame adds more). Without correction, EVERY true-30fps
          video with a real ffmpeg wav derived 29.9x and silently stretched
          its audio alignment. The tail error is a
          CONSTANT number of seconds while genuine rate skew grows linearly
          with video length, so the estimate is resolved against CANONICAL
          frame rates: each candidate rate r implies an audio tail
          ``wav_dur − n/r``; rates whose implied tail is plausible
          (−50 ms … ``cfg.fps_tail_tolerance_s``) compete, and the one
          explaining the duration with the SMALLEST tail wins. A rate no
          canonical explains (true oddball capture) keeps the raw derived
          value. Videos long enough separate 29.97 from 30 by more than a
          tail; short ones collapse into the hop-drift snap below, where
          the distinction is inaudible anyway.
        """
        cached = getattr(self, "_fps_cache", None)
        if cached is None:
            cached = self._fps_cache = {}
        if video_id in cached:
            return cached[video_id]
        fps = 0.0
        from_container = False
        for ext in (".mp4", ".avi", ".mkv"):
            vp = os.path.join(self.cfg.root, "videos", video_id + ext)
            if os.path.exists(vp):
                try:
                    import cv2
                    cap = cv2.VideoCapture(vp)
                    if cap.isOpened():
                        fps = float(cap.get(cv2.CAP_PROP_FPS))
                    cap.release()
                except Exception:
                    fps = 0.0
                from_container = self.FPS_BAND[0] <= fps <= self.FPS_BAND[1]
                break
        if not from_container:
            fps = 0.0
            wav_path = os.path.join(self.cfg.root, "audio", video_id + ".wav")
            if os.path.exists(wav_path):
                try:
                    with wave.open(wav_path, "rb") as w:
                        dur = w.getnframes() / float(w.getframerate())
                    if dur > 0:
                        n = self.num_frames(video_id) \
                            if n_frames is None else n_frames
                        fps = n / dur
                except Exception:
                    fps = 0.0
        if not self.FPS_BAND[0] <= fps <= self.FPS_BAND[1]:
            fps = float(self.cfg.fps)
        elif fps != self.cfg.fps:
            n = self.num_frames(video_id) if n_frames is None else n_frames
            if not from_container:
                fps = self._resolve_wav_fps(fps, n)
            if fps != self.cfg.fps:
                # bucket-stability snap (both sources): when the
                # end-of-video drift is under half a mel hop, no window's
                # sample offset can shift by even one hop — keep the video
                # on the canonical warmup-compiled shape buckets
                drift = abs(n / fps - n / self.cfg.fps) * self.mel.sample_rate
                if drift < self.mel.hop_length / 2:
                    fps = float(self.cfg.fps)
        cached[video_id] = fps
        return fps

    # canonical capture rates the wav-duration estimate is resolved against
    # (film/NTSC/PAL families + common webcam/screen rates); cfg.fps is
    # always added as a candidate
    CANONICAL_FPS = (12.0, 15.0, 24000.0 / 1001.0, 24.0, 25.0,
                     30000.0 / 1001.0, 30.0, 48.0, 50.0,
                     60000.0 / 1001.0, 60.0, 90.0, 120.0)
    WAV_TAIL_NEG_SLACK_S = 0.05   # wav may be marginally SHORTER (truncation)

    def _resolve_wav_fps(self, raw_fps: float, n: int) -> float:
        """Resolve a wav-duration-derived fps against canonical rates.

        ``raw_fps = n / wav_dur`` is biased low by any trailing audio. Each
        candidate rate r implies a tail ``wav_dur − n/r``, plausible when in
        −WAV_TAIL_NEG_SLACK_S … cfg.fps_tail_tolerance_s. Decision order:

        1. the CONFIGURED rate wins whenever its implied tail is plausible
           (it is the corpus's dominant rate; deviating needs the tail
           explanation to fail). This deliberately absorbs e.g. a genuine
           29.97 video shorter than ~tol/(1/29.97−1/30) ≈ 2.5 min into the
           30 fps clock — in that ambiguous zone "30 + ordinary ffmpeg
           tail" and "29.97 + exact wav" explain the same duration, the
           misalignment either way is bounded by the tolerance, and the
           common case (every real extracted wav carries a tail) must not
           silently stretch every true-30fps video);
        2. else the canonical rate with the smallest plausible |tail|;
        3. else (true oddball capture) the raw estimate stands.
        """
        dur = n / raw_fps
        lo, tol = -self.WAV_TAIL_NEG_SLACK_S, self.cfg.fps_tail_tolerance_s
        if lo <= dur - n / self.cfg.fps <= tol:
            return float(self.cfg.fps)
        best, best_tail = None, None
        for r in self.CANONICAL_FPS:
            tail = dur - n / r
            if lo <= tail <= tol and (best is None or
                                      abs(tail) < abs(best_tail)):
                best, best_tail = float(r), tail
        return raw_fps if best is None else best

    def load_video(self, video_id: str) -> Dict[str, np.ndarray]:
        """Same schema as SyntheticAVDataset.load_video, plus ``fps``
        (scalar float: this video's true frame rate — see video_fps).

        Frame decode goes through the native C++ thread-pool loader
        (data/native_loader.py) when built, else cv2 — identical output.
        """
        from m3f_torch.data.native_loader import decode_jpeg_batch

        if self._ann_dir is None:
            # test split: no labels — frame count comes from the crop dir
            # (frames with missing crops in the middle still get timeline
            # slots and the submission writer interpolates them)
            n = self._test_frame_count(video_id)
            labels = np.full((n, 2), INVALID_LABEL, dtype=np.float32)
            valid = np.ones(n, dtype=bool)
        else:
            labels = read_annotation_txt(
                os.path.join(self._ann_dir, video_id + ".txt"))
            n = len(labels)
            valid = (labels != INVALID_LABEL).all(axis=1)

        crop_dir = self._crop_dir(video_id)
        # ABAW frame numbering is 1-based, zero-padded to 5 digits
        paths = [os.path.join(crop_dir, f"{i + 1:05d}.jpg") for i in range(n)]
        frames, ok = decode_jpeg_batch(paths, self.size)
        valid &= ok

        fps = self.video_fps(video_id, n_frames=n)
        wav_path = os.path.join(self.cfg.root, "audio", video_id + ".wav")
        expected = int(round(n / fps * self.mel.sample_rate))
        if os.path.exists(wav_path):
            wav = read_wav_16k_mono(wav_path,
                                    expected_rate=self.mel.sample_rate)
            wav = np.pad(wav, (0, max(0, expected - len(wav))))[:expected]
        else:
            wav = np.zeros(expected, dtype=np.float32)

        labels = np.where(valid[:, None], labels, INVALID_LABEL).astype(np.float32)
        return {"frames": frames, "waveform": wav, "labels": labels,
                "valid": valid, "fps": fps}
