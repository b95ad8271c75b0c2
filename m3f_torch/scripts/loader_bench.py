"""Time the port's JPEG loader beside cv2's decode on a thread pool.

Host-side only: the 16 committed fixtures (``tests/data/torch_crops/``,
112x112 baseline JPEGs, the shape of the ABAW crops) cycled to ``--frames``
paths and decoded at 112 (no resize) by

- ``loader``: ``native_loader.decode_jpeg_batch`` as this host builds it
  (``backend`` in the line: ``own`` on a host without libjpeg's headers),
  with 1 and ``--threads`` threads;
- ``cv2_pool``: ``cv2.imread`` over a ``ThreadPoolExecutor`` of 1 and
  ``--threads`` workers, each decoding a contiguous share of the paths into
  the same preallocated batch (BGR to RGB): the alternative to a native
  decoder where libjpeg's headers are missing (cv2 releases the GIL while
  it decodes, but takes it back for every image).

Also the check that the files exist, both ways (``exists``: a stat a
path; ``listing``: ``native_loader._present``, one listing a directory).
All are timed in a fresh process (stage ``fresh``) and again after
``--churn-gb`` GB of host memory was allocated and freed in 50 MB arrays
(stage ``after_churn``), as a training process's checkpoints and batches
do before its loader runs. Each variant: one warm call, then the median of
``--repeats`` calls on the host clock, and its largest difference from the
committed reference decode. One JSON line per variant, then the card's
name and power limit where ``nvidia-smi`` answers::

    python -m m3f_torch.scripts.loader_bench [--frames 1024] [--threads 8]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from m3f_torch.data import native_loader

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_crops"


def cv2_pool_decode(paths, size, pool, workers, out):
    """cv2.imread of every path into ``out`` [n, size, size, 3] RGB, the
    paths split into ``workers`` contiguous shares run on ``pool``."""
    import cv2

    def share(lo, hi):
        for i in range(lo, hi):
            img = cv2.imread(paths[i], cv2.IMREAD_COLOR)
            out[i] = img[..., ::-1]

    n = len(paths)
    bounds = [n * k // workers for k in range(workers + 1)]
    for f in [pool.submit(share, bounds[k], bounds[k + 1])
              for k in range(workers)]:
        f.result()
    return out


def timed(fn, repeats):
    fn()                                            # warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--churn-gb", type=float, default=2.0)
    args = ap.parse_args(argv)

    ref = np.load(FIXTURES / "reference_decode.npz")["frames"]
    fx = [str(FIXTURES / f"{i:05d}.jpg") for i in range(1, 17)]
    paths = [fx[i % 16] for i in range(args.frames)]
    want = ref[np.arange(args.frames) % 16].astype(np.int16)
    out = np.empty((args.frames, 112, 112, 3), np.uint8)

    def report(stage, variant, threads, times, extra):
        s = statistics.median(times)
        line = {"stage": stage, "variant": variant, "threads": threads,
                "frames": args.frames, "size": 112, "s": times,
                "frames_per_s": args.frames / s,
                "max_abs_diff": int(np.abs(out.astype(np.int16) - want).max())}
        line.update(extra)
        print(json.dumps(line), flush=True)

    try:
        import cv2
    except ImportError:
        cv2 = None
    for stage in ("fresh", "after_churn"):
        if stage == "after_churn":
            chunks = [np.ones(50_000_000, np.uint8)
                      for _ in range(int(args.churn_gb * 20))]
            del chunks
        for t in sorted({1, args.threads}):
            out[:] = 0
            times = timed(lambda: native_loader.decode_jpeg_batch(
                paths, 112, n_threads=t, out=out), args.repeats)
            report(stage, "loader", t, times,
                   {"backend": native_loader.backend()})
        times = timed(lambda: [os.path.exists(p) for p in paths], args.repeats)
        listing = timed(lambda: native_loader._present(paths), args.repeats)
        print(json.dumps({"stage": stage, "variant": "exists_check",
                          "paths": args.frames, "exists_s": times,
                          "listing_s": listing}), flush=True)
        if cv2 is None:
            print(json.dumps({"variant": "cv2_pool", "skipped": "no cv2"}))
            continue
        for t in sorted({1, args.threads}):
            out[:] = 0
            with ThreadPoolExecutor(t) as pool:
                times = timed(lambda: cv2_pool_decode(paths, 112, pool, t, out),
                              args.repeats)
            report(stage, "cv2_pool", t, times, {"cv2": cv2.__version__})
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = ""
    print(card or "no nvidia-smi", flush=True)
    print(json.dumps({"cpu_count": os.cpu_count()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
