"""Tiny cells for the CPU tests: the committed configurations and mixes at
small widths and sizes (a test run holds them), run through the runners
with ``device="cpu"``, where the port takes its plain versions."""

from __future__ import annotations

import json
import os
import time

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 12345          # beyond 32 signed bits, as a check's may be


def _load(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


def tiny_config(conv_mode="2plus1d", dtype="float32") -> dict:
    cfg = _load("configs", "m3f_r2plus1d18.json")
    m = cfg["model"]
    m["visual"].update(conv_mode=conv_mode, block_channels=[8, 16, 16, 16],
                       blocks_per_stage=[2, 1, 1, 1], stem_channels=8,
                       feature_dim=16, size=32)
    m["audio"].update(channels=[4, 8, 8, 8], feature_dim=8)
    m["gru"].update(hidden_size=8)
    m["compute_dtype"] = dtype
    return cfg


def cell(kind: str, conv_mode="2plus1d", dtype="float32") -> harness.Cell:
    """``kind``: "serve" (videos of 40, 120 and 600 frames, windows past 8
    take the chunked eval) or "train" (batches of 4 sequences)."""
    if kind == "serve":
        t = _load("traffic", "whole_videos_30fps.json")
        t["lengths"] = [40, 120, 600]
        t["overrides"] = {"data.image_size": 32, "window.eval_max_windows": 8}
    else:
        t = _load("traffic", "train_b32_w4.json")
        t["overrides"] = {"data.image_size": 32, "train.batch_size": 4}
        t["pool_batches"] = 4
    return harness.Cell(f"tiny_{kind}", 1, tiny_config(conv_mode, dtype), t,
                        [], [])


def run(c: harness.Cell, seconds: float = 1.0, traced: bool = False,
        seed: int = SEED) -> harness.Run:
    return harness.runner(c.traffic["runner"]).run(
        c, seed, seconds, traced, time.time(), device="cpu")
