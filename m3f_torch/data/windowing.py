"""Window-sequence example construction (the train side of the data layer).

The port's own numpy copy of the train half of
``m3f/pytorch_tpu/data/windowing.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_data.py`` holds the streams bitwise equal. The
model consumes sequences of W consecutive 16-frame windows; this module cuts
a loaded video (frames / waveform / labels / valid) into such examples with
static shapes:

    video  uint8  [W, L, S, S, 3]
    wav    f32    [W, samples_per_window]   (raw audio; the mel frontend
                                             runs on the device)
    per_frame=True (default, labels [T, 2]):
    labels f32    [W, L, 2]  per-frame labels (INVALID_LABEL where invalid)
    mask   bool   [W, L]     per-frame validity
    per_frame=False:
    labels f32    [W, 2]   masked mean of the frame labels in each window
    mask   bool   [W]      window has ≥1 valid frame

``samples_per_window`` is chosen so the frontend emits exactly
``mel_frames_per_window`` mel frames: with centered framing,
n_frames = 1 + samples//hop  ⇒  samples = (mel_frames − 1) · hop.

``process_sharded_stream`` feeds each process of a multi-process run a
disjoint share of the data (``SubsetDataset``, ``partition_video_ids``); in
one process it is ``example_stream``. Nothing else of ``parallel/`` is
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from m3f_torch.config import INVALID_LABEL, MelConfig, WindowConfig


def samples_per_window(mel: MelConfig, mel_frames: int) -> int:
    return (mel_frames - 1) * mel.hop_length


def samples_per_window_max(mel: MelConfig, mel_frames: int) -> int:
    """Static wav-buffer width of the DYNAMIC-hop paths: sized for the
    largest supported per-video hop (mel.max_hop_length, the 24 fps floor).
    Examples at faster rates use a (mel_frames−1)·hop prefix; the mel
    frontend's index-space reflection never reads past it."""
    return (mel_frames - 1) * mel.max_hop_length


def window_label(labels: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Masked mean of per-frame labels → per-window label [2]."""
    if valid.any():
        return labels[valid].mean(axis=0)
    return np.full(labels.shape[1], INVALID_LABEL, np.float32)


@dataclass
class WindowSequencer:
    window: WindowConfig
    mel: MelConfig
    fps: float = 30.0
    mel_frames: int = 16
    per_frame: bool = True   # per-frame labels [W,L,2] (ModelConfig.per_frame)
    # Per-video audio time base (VERDICT r4 missing #1): when True each
    # example carries its video's own mel hop (round(sr/fps), one mel frame
    # per video frame at the TRUE rate) and a max-hop-sized wav buffer, so
    # the fused frontend's 16 mel frames track the 16 video frames across
    # the WHOLE window — the fixed nominal hop warps off-rate windows by up
    # to ~1/5 of their span by the last frame. False keeps the historical
    # fixed-hop shapes (right for uniformly-nominal-rate corpora; the
    # training setup auto-enables hop_aware when the dataset probe finds
    # off-rate videos).
    hop_aware: bool = False

    @property
    def frames_per_example(self) -> int:
        return self.window.window_frames + (self.window.windows_per_clip - 1) * self.window.train_stride

    def cut(self, video: Dict[str, np.ndarray], start_frame: int) -> Dict[str, np.ndarray]:
        """One example: windows_per_clip windows starting at start_frame."""
        wcfg = self.window
        L, W, stride = wcfg.window_frames, wcfg.windows_per_clip, wcfg.train_stride
        frames, wav = video["frames"], video["waveform"]
        labels, valid = video["labels"], video["valid"]
        sr = self.mel.sample_rate
        # audio↔frame alignment honors the video's OWN frame rate when the
        # loader derived one (AffWild2Dataset.video_fps) — the corpus is not
        # uniformly 30 fps, and sample offsets computed with the global
        # constant desynchronize off-rate videos' audio (VERDICT r3 #1)
        fps = float(video.get("fps") or self.fps)
        if self.hop_aware:
            # per-video hop: the window's audio span scales with the video's
            # true rate; the static buffer is max-hop-sized so mixed-rate
            # batches stack (the frontend never reads past the real span)
            hop = self.mel.hop_for_fps(fps, self.fps)
            spw = (self.mel_frames - 1) * hop
            buf = samples_per_window_max(self.mel, self.mel_frames)
        else:
            hop = None
            spw = buf = samples_per_window(self.mel, self.mel_frames)

        vids, wavs, labs, mask = [], [], [], []
        for wi in range(W):
            fs = start_frame + wi * stride
            fe = fs + L
            vids.append(frames[fs:fe])
            ss = int(round(fs / fps * sr))
            seg = wav[ss:ss + spw]
            if len(seg) < buf:
                seg = np.pad(seg, (0, buf - len(seg)))
            wavs.append(seg)
            if self.per_frame:
                labs.append(labels[fs:fe])
                mask.append(valid[fs:fe])
            else:
                labs.append(window_label(labels[fs:fe], valid[fs:fe]))
                mask.append(bool(valid[fs:fe].any()))
        # stack already copies; astype(copy=False) avoids a SECOND full copy
        # when the source dtype is already right (the common case)
        out = {
            "video": np.stack(vids).astype(np.uint8, copy=False),
            "wav": np.stack(wavs).astype(np.float32, copy=False),
            "labels": np.stack(labs).astype(np.float32, copy=False),
            "mask": np.asarray(mask, dtype=bool),
        }
        if hop is not None:
            out["hop"] = np.int32(hop)   # scalar; batch_examples stacks [B]
        return out

    def example_starts(self, num_frames: int, hop: int = 0) -> List[int]:
        """Valid example start frames (hop defaults to one full example)."""
        span = self.frames_per_example
        hop = hop or span
        if num_frames < span:
            return []
        return list(range(0, num_frames - span + 1, hop))


def batch_examples(examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


def needs_dynamic_hop(dataset, mel: MelConfig, nominal_fps: float) -> bool:
    """True when any of the dataset's videos runs at a rate whose per-video
    mel hop differs from the configured nominal — the training setup then
    enables WindowSequencer.hop_aware so every window's audio time base
    follows its video's true clock. Short-circuits on the first off-rate
    video; per-video rates come from the dataset's cached ``video_fps``
    (container header / annotation-count+wav-header reads, no decoding).
    Datasets without the protocol (synthetic) are uniformly nominal."""
    video_fps = getattr(dataset, "video_fps", None)
    if video_fps is None:
        return False
    return any(
        mel.hop_for_fps(video_fps(v), nominal_fps) != mel.hop_length
        for v in dataset.video_ids())


def video_num_frames(dataset, video_id: str) -> int:
    """Frame count of a video WITHOUT decoding it when the dataset can
    (``num_frames`` protocol method); falls back to a full load."""
    nf = getattr(dataset, "num_frames", None)
    if nf is not None:
        return nf(video_id)
    return len(dataset.load_video(video_id)["labels"])


def example_stream(dataset, sequencer: WindowSequencer, batch_size: int,
                   seed: int = 0, loop: bool = True,
                   shuffle_buffer: int = 0,
                   skip_batches: int = 0,
                   cache_videos: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled (video, start) example stream → batched dict iterator.

    Loads one video at a time (videos are large); shuffles across the
    per-video example index. ``shuffle_buffer > 0`` additionally mixes
    examples ACROSS videos through a reservoir of that size (videos are
    visited in random order either way, but without a buffer each batch is
    drawn from one video at a time). The C++/threaded prefetch loader
    (data/native_loader.Prefetcher) wraps this.

    ``skip_batches`` fast-forwards the stream for EXACT training resume:
    the stream yields precisely the batches an uninterrupted run would have
    yielded from that point on (same RNG consumption, same examples).
    Skipping is cheap — shuffling runs over (video, start) indices and a
    skipped example is never decoded (frame counts come from
    ``dataset.num_frames`` when available). The only decode cost is at the
    skip boundary: up to ``shuffle_buffer`` reservoir entries produced
    during the skip are materialized lazily as they are drawn.

    ``cache_videos`` is the decode-cache capacity in whole videos (default
    1 = each video decoded once per epoch, one resident at a time — the
    right setting when videos are hundreds of MB). RAM-rich production
    hosts can raise it to keep hot videos decoded ACROSS epochs; N ≥ the
    dataset's video count decodes everything exactly once per run. Purely
    a host-memory/CPU trade — the emitted batches are identical.
    """
    rng = np.random.RandomState(seed)
    ids = dataset.video_ids()
    if not ids:
        raise ValueError("dataset has no videos")

    # A buffer larger than one epoch forces O(buffer/epoch) full-dataset
    # decodes before the FIRST batch emerges (measured: the 8-video
    # synthetic set filled a 256-example buffer through 16 epochs ≈ 75 s of
    # startup) while adding no mixing beyond the full-epoch shuffle the
    # reservoir already provides — cap it. Only when frame counts are cheap
    # (num_frames protocol); counting via decode would BE the fill cost.
    if shuffle_buffer > 1 and getattr(dataset, "num_frames", None) is not None:
        epoch_examples = sum(
            len(sequencer.example_starts(dataset.num_frames(v)))
            for v in ids)
        shuffle_buffer = min(shuffle_buffer, max(epoch_examples, 1))

    # LRU decode cache: index pairs arrive grouped by video, so each
    # video is decoded once per epoch (as the eager version did). Shared
    # with the num_frames fallback so a duck-typed dataset WITHOUT the
    # num_frames protocol still decodes each video once, not twice. A
    # SECOND slot exists only around a resume boundary: a leftover
    # skip-era reservoir tuple materializing from ANOTHER video must not
    # evict the generator's current video mid-run. Once no skip-era
    # tuples remain in flight the capacity drops back to 1, so steady
    # state holds exactly one decoded video (ADVICE r2: a permanent
    # LRU-2 kept an extra ~hundreds-of-MB video resident forever).
    cache: Dict[int, Dict[str, np.ndarray]] = {}
    pending_tuples = 0  # skip-era index tuples still in pool/batch
    base_cap = max(1, cache_videos)

    def load(vi):
        if vi in cache:
            cache[vi] = cache.pop(vi)  # refresh LRU order
        else:
            cap = base_cap + 1 if (skipping() or pending_tuples) else base_cap
            while len(cache) >= cap:
                cache.pop(next(iter(cache)))  # evict least-recently-used
            cache[vi] = dataset.load_video(ids[vi])
        return cache[vi]

    has_nf = getattr(dataset, "num_frames", None) is not None

    def nf(vi):
        if has_nf:
            return dataset.num_frames(ids[vi])
        return len(load(vi)["labels"])

    def gen_indices():
        # identical RNG call sequence to materialized iteration, but yields
        # (video_index, start_frame) — decode is deferred to yield time
        while True:
            order = rng.permutation(len(ids))
            for vi in order:
                starts = sequencer.example_starts(nf(vi))
                rng.shuffle(starts)
                for s in starts:
                    yield (vi, s)
            if not loop:
                return

    def cut(idx):
        vi, s = idx
        return sequencer.cut(load(vi), s)

    emitted = 0          # completed batches so far, INCLUDING skipped ones
    skipping = lambda: emitted < skip_batches

    def finish_batch(batch):
        nonlocal emitted, pending_tuples
        out = None
        if not skipping():
            # boundary entries pushed while skipping are still index pairs
            out = batch_examples([cut(e) if isinstance(e, tuple) else e
                                  for e in batch])
        # tuples leave the pool/batch here whether cut or discarded; once
        # the last one drains, release the boundary slot immediately (a
        # lazy shrink-on-next-load would keep an extra video resident when
        # the stream never loads another)
        pending_tuples -= sum(1 for e in batch if isinstance(e, tuple))
        if not skipping() and not pending_tuples:
            while len(cache) > base_cap:
                cache.pop(next(iter(cache)))  # keep the most recently used
        emitted += 1
        return out

    # batch persists ACROSS epochs: an epoch smaller than batch_size must
    # keep accumulating, not discard and spin forever
    batch: List = []
    pool: List = []
    for idx in gen_indices():
        # while skipping, the reservoir holds undecoded index pairs; the
        # steady state pushes materialized examples (same RNG either way)
        if skipping():
            ex = idx
            pending_tuples += 1
        else:
            ex = cut(idx)
        if shuffle_buffer > 1:
            pool.append(ex)
            if len(pool) < shuffle_buffer:
                continue
            ex = pool.pop(rng.randint(len(pool)))
        batch.append(ex)
        if len(batch) == batch_size:
            out = finish_batch(batch)
            if out is not None:
                yield out
            batch = []
    # drain (finite stream only)
    rng.shuffle(pool)
    for ex in pool:
        batch.append(ex)
        if len(batch) == batch_size:
            out = finish_batch(batch)
            if out is not None:
                yield out
            batch = []
    if batch:
        out = finish_batch(batch)
        if out is not None:
            yield out


# ---------------------------------------------------------------------------
# Multi-process input partitioning
# ---------------------------------------------------------------------------

@dataclass
class SubsetDataset:
    """View of a dataset restricted to a subset of its video ids."""

    base: object
    ids: List[str]

    def __post_init__(self):
        # advertise the num_frames protocol only when the base can honor it
        # cheaply — otherwise example_stream would take the has-protocol
        # branch and this forward's load_video fallback would bypass the
        # stream's decode cache, decoding every video twice per epoch
        if getattr(self.base, "num_frames", None) is None:
            self.num_frames = None

    def video_ids(self) -> List[str]:
        return list(self.ids)

    def load_video(self, video_id: str):
        return self.base.load_video(video_id)

    def num_frames(self, video_id: str) -> int:
        return self.base.num_frames(video_id)


def partition_video_ids(ids: List[str], process_index: int,
                        process_count: int) -> List[str]:
    """Round-robin partition: disjoint across processes, union == ids."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in "
                         f"[0, {process_count})")
    return list(ids)[process_index::process_count]


def process_grid() -> tuple:
    """(rank, world size) of an initialised ``torch.distributed`` group,
    else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_sharded_stream(dataset, sequencer: WindowSequencer,
                           local_batch_size: int, *, seed: int = 0,
                           loop: bool = True, shuffle_buffer: int = 0,
                           skip_batches: int = 0,
                           cache_videos: int = 1,
                           process_index: Optional[int] = None,
                           process_count: Optional[int] = None
                           ) -> Iterator[Dict[str, np.ndarray]]:
    """Per-process example stream for multi-process training: each process
    feeds a disjoint slice of the data, ``local_batch_size`` =
    global batch / ``process_count``. ``process_index`` / ``process_count``
    default to the rank and world size of an initialised
    ``torch.distributed`` group, else 0 and 1.

    Partitioning: video-level round-robin (+ a per-process shuffle seed) when
    there are at least as many videos as processes; otherwise every process
    runs the SAME deterministic example stream (same seed) and keeps examples
    ``i ≡ process_index (mod process_count)`` — example-level disjointness
    that still covers everything.
    """
    if process_index is None or process_count is None:
        rank, world = process_grid()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if pc == 1:
        yield from example_stream(dataset, sequencer, local_batch_size,
                                  seed=seed, loop=loop,
                                  shuffle_buffer=shuffle_buffer,
                                  skip_batches=skip_batches,
                                  cache_videos=cache_videos)
        return
    ids = dataset.video_ids()
    if len(ids) >= pc:
        sub = SubsetDataset(dataset, partition_video_ids(ids, pi, pc))
        yield from example_stream(sub, sequencer, local_batch_size,
                                  seed=seed + 1_000_003 * pi, loop=loop,
                                  shuffle_buffer=shuffle_buffer,
                                  skip_batches=skip_batches,
                                  cache_videos=cache_videos)
        return
    # tiny-dataset fallback (fewer videos than processes): example-level
    # interleave. skip here drops formed local batches — materialization
    # cost is bounded by the dataset being tiny by definition of this path
    src = example_stream(dataset, sequencer, 1, seed=seed, loop=loop,
                         shuffle_buffer=shuffle_buffer,
                         cache_videos=cache_videos)
    batch: List[Dict[str, np.ndarray]] = []
    skipped = 0
    for i, b in enumerate(src):
        if i % pc != pi:
            continue
        batch.append(b)
        if len(batch) == local_batch_size:
            if skipped < skip_batches:
                skipped += 1
            else:
                yield {k: np.concatenate([x[k] for x in batch])
                       for k in batch[0]}
            batch = []
