"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 -m portbench.limits --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--seconds 3]

For each seed, a run of the cell (a short window) gives the program's
numbers against the float32 reference. For each control seed the
reference's control (every conv and product operand rounded to the
precision below the configuration's: float8 e4m3 at a per-tensor scale
below bf16, TF32 below fp32) is put in the program's place and compared
with the same float32 reference; a training cell also reads the planted
fault "half the batch left out, the loss's mean over the rest". One JSON
line per reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from portbench import harness
from portbench.reference.model import Ops


def control(cell, run, lower: bool = True, half: bool = False,
            device="cuda") -> dict:
    """The readings of the reference in the program's place: in the
    precision below the configuration's (``lower``), or with half of each
    batch's rows (training)."""
    h = run.host
    drv = harness.runner(cell.traffic["runner"])
    ops = Ops.below(run.model["compute_dtype"]) if lower else Ops()
    if cell.traffic["runner"] == "serve_videos":
        got = drv.reference(h["pool"], list(h["want"]), h["weights"],
                            run.model, h["cfg"], device, ops)
        return drv.gaps(got, h["want"])
    rows = slice(0, h["cfg"].train.batch_size // 2) if half else slice(None)
    got = drv.reference(h["weights"], run.model, h["cfg"], h["pool"], device,
                        ops, rows)
    return drv.readings(got, h["want"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(os.getcwd(), args.workload)
    harness.require_cards(cell.chips)
    import torch
    torch.set_num_threads(1)
    drv = harness.runner(cell.traffic["runner"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(ctl - set(seeds)):
        t0 = time.time()
        run = drv.run(cell, seed, args.seconds, False, time.time())
        vals = run.host.get("readings") or {
            k: v["value"] for k, v in run.checks.items()}
        if seed in seeds:
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": "program", "checks": vals,
                              "e2e": run.e2e, "setup_s": run.setup_s,
                              "peak": run.memory_peak,
                              "s": time.time() - t0}), flush=True)
        if seed in ctl:
            kinds = [("control_" + Ops.below(run.model["compute_dtype"]).control,
                      dict(lower=True))]
            if cell.traffic["runner"] == "train_steps":
                kinds.append(("fault_half_batch", dict(lower=False, half=True)))
            for name, kw in kinds:
                t1 = time.time()
                c = control(cell, run, **kw)
                print(json.dumps({"workload": cell.name, "seed": seed,
                                  "reading": name,
                                  "checks": c,
                                  "s": time.time() - t1}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
