"""Whole-video scoring: a closed loop of videos through
``Predictor.predict_many``.

The mix (``traffic/<name>.json``) gives the pool's video lengths in frames,
its frame rate, the wav's level and ``pipeline``. The pool is made from the
seed on the card (uniform uint8 face crops, Gaussian 16 kHz wav) and
copied to the host, where a client's videos are. Set-up warms one video of
each shape signature the pool brings. The window scores whole passes over
the pool, each in an order drawn from the seed, back to back, until
``seconds`` have passed; ``serve_frames_per_s`` is every frame scored over
the window's whole length.

Correct: once the window has closed, the last scoring of a sample of the
pool drawn from the seed (its longest video, one that takes the fused eval
and one more) is held against the plain reference, in float32, on the same
weights and inputs: the widest and the mean gap of a frame's prediction.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from portbench import devtrace, harness
from portbench.reference import serve as ref_serve
from portbench.reference.model import Net, Ops


def make_pool(traffic: dict, seed: int, size: int, device):
    """[(video_id, frames [n, S, S, 3] uint8, wav [samples] float32)]."""
    import torch
    lengths = traffic["lengths"]
    fps, sr = traffic["fps"], traffic["sample_rate"]
    g = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, "pool"))
    frames = torch.randint(0, 256, (sum(lengths), size, size, 3),
                           dtype=torch.uint8, generator=g, device=device).cpu()
    n_wav = [int(round(n / fps * sr)) for n in lengths]
    wav = (traffic["wav_std"] * torch.randn(sum(n_wav), generator=g,
                                            device=device)).cpu()
    pool, f0, w0 = [], 0, 0
    for i, (n, nw) in enumerate(zip(lengths, n_wav)):
        pool.append((f"v{i:02d}_{n}", frames[f0:f0 + n].numpy(),
                     wav[w0:w0 + nw].numpy()))
        f0, w0 = f0 + n, w0 + nw
    return pool


def sample(pool, seed: int, fused, count: int = 3):
    """Indices of the videos the reference checks: the longest, one for
    which ``fused(n_frames)`` holds (it takes the fused eval), and others
    drawn from the seed."""
    rng = np.random.default_rng(harness.sub_seed(seed, "sample"))
    lengths = [len(p[1]) for p in pool]
    chosen = [int(np.argmax(lengths))]
    short = [i for i, n in enumerate(lengths) if fused(n) and i not in chosen]
    chosen.append(int(rng.choice(short)))
    rest = [i for i in range(len(pool)) if i not in chosen]
    chosen += [int(i) for i in rng.choice(rest, count - 2, replace=False)]
    return chosen


def run(cell, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda") -> harness.Run:
    import torch

    from m3f_torch.infer.predictor import Predictor
    from m3f_torch.ops import cuda_lib
    traffic = cell.traffic
    model = cell.config["model"]
    cfg = harness.program_config(cell)
    if device == "cuda":
        cuda_lib.build()
    p = Predictor(cfg=cfg, device=device)
    shapes = {k: tuple(v.shape) for k, v in p.model.state_dict().items()}
    weights = harness.make_weights(shapes, seed, device)
    harness.calibrate(weights, model, seed, device)
    p.model.load_state_dict(weights)
    size = cfg.data.image_size
    pool = make_pool(traffic, seed, size, device)
    rng = np.random.default_rng(harness.sub_seed(seed, "order"))

    # warm every (frame bucket, window bucket) signature the pool brings
    seen, warm = set(), []
    for vid, fr, wv in pool:
        sig = p.trainer.eval_buckets(len(fr))
        if sig not in seen:
            seen.add(sig)
            warm.append((vid, {"frames": fr, "waveform": wv}))
    for _ in p.predict_many(warm, pipeline=traffic["pipeline"]):
        pass
    clips = []
    hook = p.model.visual.register_forward_pre_hook(
        lambda mod, args: clips.append(int(args[0].shape[0])))
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t_start

    served = []                       # (index, frames, preds)
    order = []

    def feed(t0):
        while time.perf_counter() - t0 < seconds:
            perm = rng.permutation(len(pool))
            for i in perm:
                order.append(int(i))
                vid, fr, wv = pool[i]
                yield vid, {"frames": fr, "waveform": wv}

    with devtrace.profiled(traced) as prof:
        t0 = time.perf_counter()
        for k, (vid, preds) in enumerate(
                p.predict_many(feed(t0), pipeline=traffic["pipeline"])):
            served.append((order[k], preds))
        window_s = time.perf_counter() - t0
    hook.remove()
    frames = sum(len(pool[i][1]) for i, _ in served)
    windows = sum(len(ref_serve.window_starts(len(pool[i][1]), cfg.window.window_frames,
                                              cfg.window.eval_stride))
                  for i, _ in served)
    failed = sum(1 for i, pr in served
                 if pr.shape != (len(pool[i][1]), 2) or not np.isfinite(pr).all())
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    counts = {"frames": frames, "windows": windows, "videos": len(served),
              "forward_clips": clips}
    last = {i: pr for i, pr in served}
    del p
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    wcfg = cfg.window
    picks = sample(pool, seed, lambda n: len(ref_serve.window_starts(
        n, wcfg.window_frames, wcfg.eval_stride)) <= wcfg.eval_max_windows)
    want = reference(pool, picks, weights, model, cfg, device)
    return harness.Run(
        setup_s=setup_s, window_s=window_s, attempted=len(served),
        failed=failed, memory_peak=peak,
        e2e={"serve_frames_per_s": frames / window_s},
        checks=harness.checks(gaps({i: last.get(i) for i in picks}, want),
                              cell),
        model=model, counts=counts, trace=prof.trace,
        host={"want": want, "weights": weights, "pool": pool, "cfg": cfg})


def reference(pool, picks, weights, model, cfg, device, ops: Ops = None):
    """{index: the reference's predictions [n, 2]} of the picked videos
    (``ops``: the reference's arithmetic, float32 by default)."""
    import torch
    mel = cfg.model.mel
    spw = (cfg.model.audio.mel_frames_per_window - 1) * mel.hop_length
    net = Net(weights, model, ops=ops)
    out = {}
    with harness.fp32_exact():
        for i in picks:
            _, fr, wv = pool[i]
            out[i] = ref_serve.predict_video(
                net, fr, wv, fps=cfg.data.fps, sr=mel.sample_rate,
                W=cfg.window.windows_per_clip, L=cfg.window.window_frames,
                stride=cfg.window.eval_stride, spw=spw, device=device)
            if device == "cuda":
                torch.cuda.empty_cache()
    return out


def gaps(got, want) -> dict:
    """The widest and the mean gap of a frame's prediction between ``got``
    and ``want`` ({index: [n, 2]}); a video never scored reads inf."""
    allg = np.concatenate([
        (np.full(w.size, np.inf) if got.get(i) is None
         else np.abs(got[i] - w).reshape(-1)) for i, w in want.items()])
    return {"pred_max_gap": float(allg.max()),
            "pred_mean_gap": float(allg.mean())}
