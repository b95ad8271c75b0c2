"""Tracing and step timing.

Counterpart of ``m3f/pytorch_tpu/utils/profiling.py``, over
``torch.profiler``: ``trace`` captures CPU and CUDA activity into a gzipped
chrome trace, ``summarize_trace`` and ``device_total_ms`` read the device
side of the newest one, ``StepTimer`` times host steps that end in a
synchronise of the card.

Device events are the trace's CUDA kernel, memcpy and memset events
(``cat`` ``kernel`` / ``gpu_memcpy`` / ``gpu_memset``), where the JAX
module reads the ops on its TPU tracks. A trace taken without a GPU holds
none, so its summary is empty.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(profile_dir: str):
    """Capture a ``torch.profiler`` trace of the block into ``profile_dir``
    as ``<worker>.<time>.pt.trace.json.gz`` (open it in Perfetto or
    TensorBoard), with each host op's input shapes; no-op if
    ``profile_dir`` is empty. The card is synchronised before the capture
    stops, so every kernel the block enqueued is in it."""
    if not profile_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                supported_activities,
                                tensorboard_trace_handler)
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities, record_shapes=True,
                 on_trace_ready=tensorboard_trace_handler(profile_dir,
                                                          use_gzip=True)):
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()


def _device_events(profile_dir: str) -> List[dict]:
    """The complete device events of the newest trace under ``profile_dir``."""
    paths = sorted(glob.glob(os.path.join(
        profile_dir, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {profile_dir}")
    with gzip.open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events
            if e.get("ph") == "X" and e.get("dur")
            and e.get("cat") in DEVICE_CATS]


def _detail(e: dict) -> str:
    """A kernel's launch geometry, or a copy's byte count."""
    args = e.get("args", {})
    if "grid" in args:
        return f"grid {args['grid']} block {args.get('block')}"
    if "bytes" in args:
        return f"{args['bytes']} bytes"
    return ""


def summarize_trace(profile_dir: str, top: int = 15,
                    group: bool = True) -> List[Dict]:
    """Device time per op of the newest trace under ``profile_dir``.

    ``group=True`` merges ops whose names differ only by a trailing ``.N``
    index; ``group=False`` keeps each name and adds its count and a detail
    (a kernel's grid and block, a copy's bytes). Returns {"op", "ms",
    "percent"[, "count", "detail"]} rows, largest first; percent of all
    device time in the trace."""
    agg = collections.Counter()
    count = collections.Counter()
    detail: Dict[str, str] = {}
    for e in _device_events(profile_dir):
        name = e.get("name", "")
        if name.isdigit():
            continue  # per-step markers
        key = re.sub(r"\.\d+$", "", name) if group else name
        agg[key] += e["dur"]
        count[key] += 1
        if not group and key not in detail:
            detail[key] = _detail(e)[:120]
    total = sum(agg.values())
    rows = []
    for k, v in agg.most_common(top):
        row = {"op": k, "ms": v / 1e3, "percent": 100.0 * v / total}
        if not group:
            row["count"] = count[k]
            row["detail"] = detail[k]
        rows.append(row)
    return rows


def device_total_ms(profile_dir: str) -> float:
    """Device busy time (ms) of the newest trace: the union of its device
    events' intervals, so work on two streams at once counts once. Beside
    the host time of the traced block it gives the card's idle share."""
    spans = sorted((e["ts"], e["ts"] + e["dur"])
                   for e in _device_events(profile_dir))
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


class StepTimer:
    """Host-clock step timing; ``stop(result)`` synchronises the card first
    when ``result`` is a CUDA tensor."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(n - 1, int(n * 0.9))],
            "min_s": ts[0],
            "max_s": ts[-1],
        }
