"""Synthetic audio-visual dataset with learnable V/A structure.

The port's own numpy copy of ``m3f/pytorch_tpu/data/synthetic.py`` (the port
imports nothing of the JAX package); ``tests/test_torch_data.py`` holds the
two equal, video for video. It stands in for Aff-Wild2 (whose videos cannot
ship with the repo) in tests and on-card runs. The signal is constructed so
both branches carry learnable information:

- **valence** drives global frame brightness (visual branch can regress it),
- **arousal** drives the frequency of an audio tone (audio branch can regress
  it via the log-mel frontend),

so a correctly-wired model trains to CCC > 0 on either modality in a few
hundred steps — the "loss must decrease" integration gate of SURVEY §4.

Same item schema as AffWild2Dataset: per-video frames, waveform, per-frame
labels [-1, 1], validity mask (a random span is marked invalid to exercise
masking).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from m3f_torch.config import INVALID_LABEL, DataConfig, MelConfig


@dataclass
class SyntheticAVDataset:
    cfg: DataConfig
    mel: MelConfig
    seed: int = 0
    image_size: int = 0   # 0 → cfg.image_size
    cache: bool = True    # memoize generated videos (see __post_init__)

    def __post_init__(self):
        self.size = self.image_size or self.cfg.image_size
        self.num_videos = self.cfg.synthetic_num_videos
        self.frames_per_video = self.cfg.synthetic_video_frames
        # Generation is deterministic per video id, so memoizing is exact.
        # Without it the train stream regenerates every video once per epoch
        # (~113 ms per 600×112² video ≈ ALL of the measured 108 ms/batch
        # host-pipeline cost in the e2e bench). Memory is bounded by the
        # synthetic set's total size (num_videos × frames × S² × 3 bytes;
        # the bench config's 8×600×112² ≈ 180 MB) — synthetic sets are small
        # by construction. Real datasets keep per-epoch decode semantics
        # (see example_stream's cache_videos knob).
        self._cache: Dict[str, Dict[str, np.ndarray]] = {} if self.cache else None

    def video_ids(self):
        return [f"synth_{i:04d}" for i in range(self.num_videos)]

    def num_frames(self, video_id: str) -> int:
        """Cheap frame count (exact-resume stream skip, windowing.py)."""
        return self.frames_per_video

    def load_video(self, video_id: str) -> Dict[str, np.ndarray]:
        """Returns frames uint8 [N,S,S,3], waveform f32 [T], labels f32 [N,2],
        valid bool [N]."""
        if self._cache is not None and video_id in self._cache:
            # fresh dict, shared (treated-as-immutable) arrays — callers that
            # add keys (e.g. a per-request fps) must not corrupt the cache
            return dict(self._cache[video_id])
        idx = int(video_id.split("_")[-1])
        rng = np.random.RandomState(self.seed * 10_007 + idx)
        n = self.frames_per_video
        fps = self.cfg.fps
        t_frame = np.arange(n) / fps

        # slow random-phase sinusoid labels in [-0.9, 0.9]
        fv, fa = rng.uniform(0.05, 0.2, 2)
        pv, pa = rng.uniform(0, 2 * np.pi, 2)
        valence = 0.9 * np.sin(2 * np.pi * fv * t_frame + pv)
        arousal = 0.9 * np.sin(2 * np.pi * fa * t_frame + pa)

        # frames: noise + brightness tied to valence. No clip needed — base
        # ∈ [0,63] and brightness ∈ [8,152] (valence ∈ [-0.9,0.9]), so the
        # sum is provably in [8,215]; the old np.clip(…,0,255) was a no-op
        # that cost 0.85 s/video on the 1-core VM (85% of load_video, and
        # the stream's shuffle-buffer fill makes O(buffer) loads at startup).
        # The add runs entirely in uint8: base is integer, so
        # floor(base + b) == base + floor(b) and the result is BITWISE
        # identical to the former float32 round-trip, which alone cost
        # 238 ms/video at 600×112² (measured; uint8 path: 4.8 ms).
        base = rng.randint(0, 64, (n, self.size, self.size, 3), dtype=np.uint8)
        brightness = ((valence + 1.0) * 0.5 * 160.0)[:, None, None, None]
        frames = base + np.floor(brightness).astype(np.uint8)

        # audio: tone whose frequency follows arousal (200..2000 Hz)
        sr = self.mel.sample_rate
        num_samples = int(round(n / fps * sr))
        t_audio = np.arange(num_samples) / sr
        arousal_audio = 0.9 * np.sin(2 * np.pi * fa * t_audio + pa)
        freq = 1100.0 + 900.0 * arousal_audio
        phase = 2 * np.pi * np.cumsum(freq) / sr
        wav = (0.3 * np.sin(phase) + 0.01 * rng.randn(num_samples)).astype(np.float32)

        labels = np.stack([valence, arousal], axis=1).astype(np.float32)
        valid = np.ones(n, dtype=bool)
        # a random invalid span (missing face crops in the real data)
        if n > 16:
            s = rng.randint(0, n - 8)
            span = rng.randint(2, 8)
            valid[s:s + span] = False
            labels[s:s + span] = INVALID_LABEL
        out = {"frames": frames, "waveform": wav, "labels": labels, "valid": valid}
        if self._cache is not None:
            self._cache[video_id] = dict(out)
        return out
