"""Paired timing of two checkouts of the port on one card: serving and
training, alternated.

    python3 -m m3f_torch.scripts.serve_train_ab --trees build/parent,. \\
        [--out ab.json]

The checkouts run in the order parent, change, change, parent (``ORDER``),
each in a fresh process with its own ``m3f_torch`` first on ``sys.path``.
A process serves a synthetic 1024-frame 112x112 video through
``Predictor(preset="longseq_eval")`` ``SERVES`` times after 3 warm calls
(frames/s of each call, host clock around ``torch.cuda.synchronize()``)
and then trains full-width ``fusion`` for ``STEPS`` steps after a 2-step
warm fit (s of each step but the first, between the ends of consecutive
logged steps, as ``chip_smoke.py``'s ``train_fusion`` does). The kernels
are built once, in the first checkout, and its ``build/kernels`` is copied
into the others: the libraries are named by a hash of their sources, so a
checkout whose ``csrc`` differs builds its own. Prints one line a process
(median, quartiles, extremes) and writes every time to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

ORDER = (0, 1, 1, 0)
SERVES = 30
STEPS = 12

_WORK = r'''
import json, sys, time
sys.path.insert(0, TREE)
import numpy as np
import torch
from m3f_torch import config
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import WindowSequencer, example_stream
from m3f_torch.infer import Predictor
from m3f_torch.ops import cuda_lib
from m3f_torch.train.loop import Trainer
if not cuda_lib.__file__.startswith(TREE):
    raise SystemExit("imported " + cuda_lib.__file__ + ", not " + TREE)
cuda_lib.build()
p = Predictor(preset="longseq_eval")
rng = np.random.RandomState(0)
frames = rng.randint(0, 256, (1024, 112, 112, 3), dtype=np.uint8)
wav = (rng.randn(int(round(1024 / 30 * 16000)) + 16000) * 0.1
       ).astype(np.float32)
for _ in range(3):
    p.predict_video(frames=frames, waveform=wav)
serve = []
for _ in range(SERVES):
    torch.cuda.synchronize()
    t = time.perf_counter()
    p.predict_video(frames=frames, waveform=wav)
    torch.cuda.synchronize()
    serve.append(1024 / (time.perf_counter() - t))
del p
torch.cuda.empty_cache()
cfg = config.apply_overrides(config.fusion(), {"train.log_every": 1})
ds = SyntheticAVDataset(cfg.data, cfg.model.mel, seed=0)
seq = WindowSequencer(cfg.window, cfg.model.mel, fps=cfg.data.fps,
                      mel_frames=cfg.model.audio.mel_frames_per_window)
for v in ds.video_ids():
    ds.load_video(v)
stream = lambda skip: example_stream(ds, seq, cfg.train.batch_size, seed=0,
                                     skip_batches=skip)
tr = Trainer(cfg)
tr.fit(stream, num_steps=2, log=lambda s: None)
ends = []
tr.fit(stream, num_steps=STEPS, log=lambda s: ends.append(time.perf_counter()))
steps = np.diff(ends)[1:].tolist()
print("AB " + json.dumps({"frames_per_s": serve, "s_per_step": steps}))
'''


def _summary(v):
    q = statistics.quantiles(v, n=4)
    return (f"median {statistics.median(v):.4f} q1 {q[0]:.4f} q3 {q[2]:.4f} "
            f"min {min(v):.4f} max {max(v):.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", required=True,
                    help="two checkouts (repo roots), parent,change")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    if len(trees) != 2:
        ap.error(f"--trees names {len(trees)} checkouts, not 2")
    first = trees[0]
    subprocess.run([sys.executable, "-c",
                    f"import sys; sys.path.insert(0, {first!r}); "
                    "from m3f_torch.ops import cuda_lib; cuda_lib.build()"],
                   check=True)
    for t in trees[1:]:
        shutil.copytree(os.path.join(first, "build", "kernels"),
                        os.path.join(t, "build", "kernels"), dirs_exist_ok=True)
    runs = []
    for i in ORDER:
        code = (f"TREE = {trees[i]!r}\nSERVES = {SERVES}\n"
                f"STEPS = {STEPS}\n" + _WORK)
        r = subprocess.run([sys.executable, "-c", code], cwd=trees[i],
                           capture_output=True, text=True)
        line = [l for l in r.stdout.splitlines() if l.startswith("AB ")]
        if r.returncode or not line:
            print(r.stdout[-2000:], r.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"checkout {trees[i]} failed")
        d = json.loads(line[0][3:])
        d["tree"] = i
        runs.append(d)
        print(f"tree {i}: frames/s {_summary(d['frames_per_s'])} | s/step "
              f"{_summary(d['s_per_step'])}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
