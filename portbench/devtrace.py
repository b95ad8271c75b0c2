"""The device trace of a run: ``torch.profiler`` over the measured window,
reduced to device intervals, each attributed to the host op that launched
it.

The reduction is ``m3f_torch/utils/profiling.py``'s and ``chip_smoke.py``'s
(``device_total_ms``: the union of device intervals; ``device_ms_by_op``:
the outermost host op around each launch, or the kernel's name where none
was, as for the port's kernels, launched through ctypes), copied here so
that the yardstick stays fixed, and made linear in the number of events.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import re
import tempfile
import types
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yield a holder whose ``trace`` is the window's ``Trace`` once the
    block ends (the card is synchronised first); nothing when disabled."""
    holder = types.SimpleNamespace(trace=None)
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities
    prof = profile(activities=[a for a in (ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA)
                               if a in supported_activities()])
    prof.__enter__()
    try:
        yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder.trace = Trace.load(path)
    finally:
        os.unlink(path)


class Trace:
    """Device events ``(name, start_us, end_us, launcher)`` of one trace,
    with the top-level host ops of each thread for the idle gaps."""

    def __init__(self, events: List[dict]):
        launch = {}
        ops = collections.defaultdict(list)
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat == "cpu_op":
                ops[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0),
                                      e["name"]))
            elif cat == "cuda_runtime":
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = (e["tid"], e["ts"], e["name"])
            elif cat in DEVICE_CATS and e.get("dur"):
                device.append(e)
        # the top-level ops of each thread: disjoint, sorted
        self.top: Dict[int, Tuple[List[float], List[Tuple]]] = {}
        for tid, lst in ops.items():
            lst.sort(key=lambda o: (o[0], -o[1]))
            tops, end = [], -float("inf")
            for o in lst:
                if o[0] >= end:
                    tops.append(o)
                    end = o[1]
            self.top[tid] = ([o[0] for o in tops], tops)
        self.events = []
        launches = collections.Counter()
        for e in device:
            r = launch.get(e.get("args", {}).get("correlation"))
            op = self.op_at(r[0], r[1]) if r is not None else None
            name = e["name"]
            self.events.append((name, e["ts"], e["ts"] + e["dur"],
                                op if op is not None else _short(name)))
            if r is not None:
                launches[r[0]] += 1
        self.main_tid = launches.most_common(1)[0][0] if launches else None

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def op_at(self, tid: int, ts: float) -> Optional[str]:
        """The top-level host op of thread ``tid`` running at ``ts``."""
        starts, tops = self.top.get(tid, ([], []))
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and tops[i][0] <= ts <= tops[i][1]:
            return tops[i][2]
        return None

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((a, b) for _, a, b, _ in self.events)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_s(self, keep: Callable[[str, str], bool]) -> float:
        """Summed device seconds of the events ``keep(kernel, launcher)``."""
        return sum(b - a for n, a, b, op in self.events if keep(n, op)) / 1e6

    def top_ops(self, k: int = 10) -> List[List]:
        """[launcher, seconds] of the ``k`` launchers with most device time."""
        agg = collections.Counter()
        for _, a, b, op in self.events:
            agg[op] += (b - a) / 1e6
        return [[n, s] for n, s in agg.most_common(k)]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """[host activity, seconds] of the device's idle gaps between its
        first and last event, each gap named by the top-level host op
        running at its middle (the launching thread's first), summed by
        name, the ``k`` largest."""
        agg = collections.Counter()
        busy = self.busy_intervals()
        tids = ([self.main_tid] if self.main_tid is not None else []) + \
            [t for t in self.top if t != self.main_tid]
        for (_, end), (start, _) in zip(busy, busy[1:]):
            mid = (end + start) / 2
            name = next((op for op in (self.op_at(t, mid) for t in tids)
                         if op is not None), "host: no op (Python)")
            agg[name] += (start - end) / 1e6
        return [[n, s] for n, s in agg.most_common(k)]


def _short(name: str) -> str:
    """A kernel's base name: ``void (anonymous namespace)::foo_kernel<...>(
    ...)`` → ``foo_kernel``."""
    n = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    head = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    return head.rsplit("::", 1)[-1] or name[:80]


_BOUNDS = r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*"


def kernel_names(csrc_dir: str) -> List[str]:
    """The names of every ``__global__`` function of the program's CUDA
    sources."""
    names = []
    for fn in sorted(os.listdir(csrc_dir)):
        if fn.endswith(".cu"):
            with open(os.path.join(csrc_dir, fn)) as f:
                src = f.read()
            names += re.findall(
                rf"__global__\s+(?:{_BOUNDS})?void\s+(?:{_BOUNDS})?(\w+)\s*\(",
                src)
    return sorted(set(names))
