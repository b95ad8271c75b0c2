"""Training: ``Trainer.train_step`` over a pool of batches.

The mix (``traffic/<name>.json``) gives the number of batches in the pool,
the steps the reference follows, the share of valid frames and the wav's
level; the batch geometry is the preset's (``train.batch_size`` sequences
of ``window.windows_per_clip`` windows of 16 frames). The pool is made from
the seed on the card and copied to the host, whose arrays ``train_step``
uploads as a data loader's would be. Set-up builds one ``Trainer``, loads
the seeded weights and drives its first ``check_steps`` steps through
``train_step`` on the pool's first batches; the window goes on with that
same state over the pool, cycled, until ``seconds`` have passed.
``train_clips_per_s`` is every clip (a 16-frame window) trained over the
window's whole length.

Correct: the reference follows the first ``check_steps`` steps from the
same weights and batches, once the window has closed; compared are each
step's loss, the norm of each leaf's first gradient as the optimizer got it
(Adam's first moment after step 1, over 1 - b1; the median leaf's gap:
the worst leaf, on most seeds the stem's first convolution, is the small
remainder of sums that cancel, since its input, frames / 255, has a mean
near 0.5 and the train-mode BatchNorm after it leaves its output gradient
a zero mean a channel, and bf16 reads 0.18-0.30 there as the float8
control does) and the norm of each leaf's change over those steps (the worst leaf's
gap; leaves whose reference gradient is under a thousandth of the median
leaf's are left out: rounding alone moves them under Adam).
"""

from __future__ import annotations

import gc
import os
import statistics
import tempfile
import time

import numpy as np

from portbench import devtrace, harness
from portbench.reference import train as ref_train
from portbench.reference.model import Ops

STILL = 1e-3             # leaves under this share of the median gradient


def make_pool(traffic: dict, cfg, seed: int, device):
    """[batch]: host arrays video [B, W, L, S, S, 3] uint8, wav [B, W, spw]
    float32, labels [B, W, L, 2] in [-1, 1], mask [B, W, L]."""
    import torch
    B, W = cfg.train.batch_size, cfg.window.windows_per_clip
    L, S = cfg.window.window_frames, cfg.data.image_size
    spw = (cfg.model.audio.mel_frames_per_window - 1) * cfg.model.mel.hop_length
    g = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, "pool"))
    pool = []
    for _ in range(traffic["pool_batches"]):
        pool.append({
            "video": torch.randint(0, 256, (B, W, L, S, S, 3), dtype=torch.uint8,
                                   generator=g, device=device).cpu().numpy(),
            "wav": (traffic["wav_std"] * torch.randn(
                B, W, spw, generator=g, device=device)).cpu().numpy(),
            "labels": (torch.rand(B, W, L, 2, generator=g, device=device)
                       * 2 - 1).cpu().numpy(),
            "mask": (torch.rand(B, W, L, generator=g, device=device)
                     < traffic["label_valid"]).cpu().numpy()})
    return pool


def run(cell, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda") -> harness.Run:
    import torch

    from m3f_torch.ops import cuda_lib
    from m3f_torch.train.loop import Trainer
    traffic = cell.traffic
    model = cell.config["model"]
    ckpt_dir = os.path.join(tempfile.gettempdir(), "portbench_ckpt")
    cfg = harness.program_config(cell, {"train.checkpoint_dir": ckpt_dir})
    if device == "cuda":
        cuda_lib.build()
    tr = Trainer(cfg, device=device)
    shapes = {k: tuple(v.shape) for k, v in tr.model.state_dict().items()}
    w0 = harness.make_weights(shapes, seed, device)
    harness.calibrate(w0, model, seed, device)
    tr.model.load_state_dict(w0)
    state = tr.init_state(keep_weights=True)
    pool = make_pool(traffic, cfg, seed, device)
    n_check = traffic["check_steps"]

    losses, first, change = [], {}, {}
    for k in range(n_check):
        m = tr.train_step(state, pool[k])
        losses.append(float(m["loss"]))
        if k == 0:
            first = {n: float(mu.norm()) / (1.0 - ref_train.B1)
                     for n, mu in state.opt_state["mu"].items()}
    change = {n: float((p.detach() - w0[n]).norm())
              for n, p in state.params.items()}
    B, W = cfg.train.batch_size, cfg.window.windows_per_clip
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t_start

    steps = 0
    with devtrace.profiled(traced) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            m = tr.train_step(state, pool[(n_check + steps) % len(pool)])
            steps += 1
        if device == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    counts = {"steps": steps, "clips_per_step": B * W}
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    loss_last = float(m["loss"])
    del tr, state, m
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    want = reference(w0, model, cfg, pool[:n_check], device)
    got = (losses, first, change)
    found = readings(got, want)
    return harness.Run(
        setup_s=setup_s, window_s=window_s, attempted=steps,
        failed=0 if np.isfinite(loss_last) else 1, memory_peak=peak,
        e2e={"train_clips_per_s": steps * B * W / window_s},
        checks=harness.checks(found, cell),
        model=model, counts=counts, trace=prof.trace,
        host={"want": want, "weights": w0, "pool": pool[:n_check], "cfg": cfg,
              "readings": found})


def reference(w0, model, cfg, batches, device, ops: Ops = None, rows=slice(None)):
    with harness.fp32_exact():
        return ref_train.train(
            w0, model, batches, lr=cfg.train.optim.learning_rate,
            clip=cfg.train.optim.grad_clip_norm, device=device, ops=ops,
            rows=rows)


def readings(got, want) -> dict:
    """Every number of the comparison: the loss gap of the worst step; the
    first gradient's and the change's per-leaf gaps by the worst leaf and
    by the median leaf; and the worst leaves."""
    (losses, first, change), (r_losses, r_first, r_change) = got, want
    med = sorted(r_first.values())[len(r_first) // 2]
    moved = {n for n, g in r_first.items() if g >= STILL * med}
    grad = ref_train.leaf_gaps(first, r_first)
    chg = ref_train.leaf_gaps(change, r_change, moved)
    return {"loss_gap": max(abs(a - b) for a, b in zip(losses, r_losses)),
            "grad_gap": max(grad.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap": max(chg.values()),
            "change_gap_median": statistics.median(chg.values()),
            "worst_grad": sorted(grad, key=grad.get)[-3:],
            "worst_change": sorted(chg, key=chg.get)[-3:]}

