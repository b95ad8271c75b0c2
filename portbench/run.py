"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
mix come from ``BENCHMARK.json``; the mix's runner (``runners/``) builds
the program (``m3f_torch``) and its inputs from the seed, warms the cell's
shapes, measures for ``--seconds``, then checks what the timed path
produced against the plain reference (``reference/``). With ``--trace 0``
the line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from the window's device trace (``metrics/``).

The last line of standard output is the result, a JSON object; the numbers
compared for ``correct`` close standard error, each beside its limit, and
close the result under ``checks``. Without the CUDA cards the cell asks
for, or with JAX or the JAX package loaded once the window has closed, the
run exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.getcwd()
if __package__ in (None, ""):
    # run as a script: import from the checkout's root, not from portbench/
    sys.path[0] = ROOT

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    t_start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    cell = harness.load_cell(ROOT, args.workload)
    harness.require_cards(cell.chips)
    # one process with one CPU thread of PyTorch's own: its idle OpenMP
    # workers spin on the cores the host path needs, and serving spread by
    # 4% over three runs of one seed with them, 0.7% without (PERF.md)
    import torch
    torch.set_num_threads(1)
    run = harness.runner(cell.traffic["runner"]).run(
        cell, args.seed, args.seconds, bool(args.trace), t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port must not",
              file=sys.stderr)
        return 3
    result = report(cell, run, bool(args.trace))
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def report(cell: harness.Cell, run: harness.Run, traced: bool) -> dict:
    """The result line: ``checks`` last."""
    if traced:
        metrics = harness.read_per_layer(run, cell.per_layer)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(run.e2e, setup_s=run.setup_s)
        metrics = {n: {"value": values[n], "unit": u}
                   for n, u in units.items()}
    device = harness.device_line(cell.chips, run.memory_peak)
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.idle_gaps(10)}
    out["checks"] = run.checks
    return out


if __name__ == "__main__":
    sys.exit(main())
