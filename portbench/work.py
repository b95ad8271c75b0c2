"""The yardstick's arithmetic: peaks of one H100, model FLOPs of the M3T
fusion model, and the least time of the fused conv units (rows 3-8).

Peaks are NVIDIA's data sheet for the H100 SXM (dense, 700 W). A model
FLOP is two per multiply-add of every convolution and product the forward
needs, counted from the configuration's shapes with zero padding included
(torchvision's convention: R(2+1)D-18 is 40.52 G multiply-adds and R3D-18
40.70 G on a 16x112x112 clip); the log-mel frontend is left out (under
0.01% of a window). A train step counts three forwards (forward, and the
data and filter gradients).

A conv unit's bound counts what its function needs (``chip_smoke.py``'s
arithmetic, frozen here): 2·C_in·C_out operations a (position, tap) pair
whose input lies inside the clip, and each operand read and each result
written once: bf16 x, w and y, fp32 affine and channel sums; the least
time is the larger of operations at the bf16 peak and bytes at the memory
rate, summed over the launches.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Tuple

PEAK_BF16 = 989e12       # FLOP/s, dense bf16 tensor cores
PEAK_FP32 = 67e12        # FLOP/s, fp32 outside the tensor cores
HBM = 3.35e12            # B/s


def peak_flops(model: dict) -> float:
    """The chip's peak in the precision the model computes in (fp32 with
    TF32 off runs outside the tensor cores)."""
    return {"bfloat16": PEAK_BF16, "float32": PEAK_FP32}[model["compute_dtype"]]


def visual_macs(visual: dict, frames: int, size: int) -> int:
    """Multiply-adds of the backbone on one [frames, size, size] clip: each
    convolution's output positions x kernel taps x channels."""
    total = 0
    t, h = frames, size

    def conv(ci, co, k, stride, pad):
        nonlocal total, t, h
        t = (t + 2 * pad[0] - k[0]) // stride[0] + 1
        h = (h + 2 * pad[1] - k[1]) // stride[1] + 1
        total += t * h * h * co * ci * math.prod(k)

    two = visual["conv_mode"] == "2plus1d"
    if two:
        conv(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3))
        conv(45, visual["stem_channels"], (3, 1, 1), (1, 1, 1), (1, 0, 0))
    else:
        conv(3, visual["stem_channels"], (3, 7, 7), (1, 2, 2), (1, 3, 3))
    cin = visual["stem_channels"]
    for si, (co, n) in enumerate(zip(visual["block_channels"],
                                     visual["blocks_per_stage"])):
        for bi in range(n):
            s = 2 if si > 0 and bi == 0 else 1
            t0, h0 = t, h
            if two:
                mid = midplanes(cin, co)
                conv(cin, mid, (1, 3, 3), (1, s, s), (0, 1, 1))
                conv(mid, co, (3, 1, 1), (s, 1, 1), (1, 0, 0))
                conv(co, mid, (1, 3, 3), (1, 1, 1), (0, 1, 1))
                conv(mid, co, (3, 1, 1), (1, 1, 1), (1, 0, 0))
            else:
                conv(cin, co, (3, 3, 3), (s, s, s), (1, 1, 1))
                conv(co, co, (3, 3, 3), (1, 1, 1), (1, 1, 1))
            if s != 1 or cin != co:
                t1, h1 = t, h
                t, h = t0, h0
                conv(cin, co, (1, 1, 1), (s, s, s), (0, 0, 0))
                t, h = t1, h1
            cin = co
    return total


def midplanes(cin: int, co: int) -> int:
    """torchvision's FLOP-matched (2+1)D width."""
    return (27 * cin * co) // (9 * cin + 3 * co)


def audio_macs(model: dict) -> int:
    """The audio CNN and its Dense on one window's [frames, n_mels] log-mel."""
    h = model["audio"]["mel_frames_per_window"]
    w = model["mel"]["n_mels"]
    cin, total = 1, 0
    for co in model["audio"]["channels"]:
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        total += h * w * co * cin * 9
        cin = co
    return total + h * cin * model["audio"]["feature_dim"]


def fusion_macs_per_frame(model: dict) -> int:
    """The BiGRU (input projection and recurrence, every layer) and the head,
    per frame of a sequence."""
    hid = model["gru"]["hidden_size"]
    d = model["visual"]["feature_dim"] + model["audio"]["feature_dim"]
    total = 0
    for _ in range(model["gru"]["num_layers"]):
        total += 2 * (d * 3 * hid + hid * 3 * hid)
        d = 2 * hid
    return total + d * 2


def window_flops(model: dict, frames: int, size: int) -> float:
    """Model FLOPs of one window's forward (16 frames: a clip, its audio,
    and its frames' share of the BiGRU and head)."""
    return 2.0 * (visual_macs(model["visual"], frames, size)
                  + audio_macs(model) + frames * fusion_macs_per_frame(model))


def train_clip_flops(model: dict, frames: int, size: int) -> float:
    return 3.0 * window_flops(model, frames, size)


# -- the fused conv units (rows 3-8) ----------------------------------------

Unit = Tuple[str, Tuple[int, ...], Tuple[int, ...], bool]


def fused_units(visual: dict, clips: int, frames: int, size: int
                ) -> List[Unit]:
    """(kind, x shape, w shape, affine) of each unit launch of one forward
    over ``clips`` clips: every stride-1 identity block of a 2plus1d
    backbone runs conv1's spatial unit (no prologue) and temporal unit,
    conv2's spatial and temporal units (with the BatchNorm prologue)."""
    if visual["conv_mode"] != "2plus1d" or visual.get("se_ratio", 0):
        return []
    units: List[Unit] = []
    t, h = frames, (size - 1) // 2 + 1
    cin = visual["stem_channels"]
    for si, (co, n) in enumerate(zip(visual["block_channels"],
                                     visual["blocks_per_stage"])):
        for bi in range(n):
            s = 2 if si > 0 and bi == 0 else 1
            if s == 2:
                t, h = (t - 1) // 2 + 1, (h - 1) // 2 + 1
            if s == 1 and cin == co:
                mid = midplanes(cin, co)
                xs, xm = (clips, t, h, h, co), (clips, t, h, h, mid)
                units += [("spatial", xs, (3, 3, co, mid), False),
                          ("temporal", xm, (3, mid, co), True),
                          ("spatial", xs, (3, 3, co, mid), True),
                          ("temporal", xm, (3, mid, co), True)]
            cin = co
    return units


def tap_pairs(kind: str, b: int, t: int, h: int, w: int) -> int:
    """(output position, tap) pairs whose input lies inside the clip."""
    if kind == "temporal":
        return b * h * w * (3 * t - 2)
    return b * t * (3 * h - 2) * (3 * w - 2)


def _least(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM, flops / PEAK_BF16)


def unit_bounds(unit: Unit) -> Tuple[float, float, float]:
    """Least seconds of (forward, data gradient, filter gradient)."""
    kind, xs, ws, affine = unit
    m, ci, co = math.prod(xs[:-1]), xs[-1], ws[-1]
    nw = math.prod(ws)
    flops = 2 * tap_pairs(kind, *xs[:4]) * ci * co
    aff = 2 * ci * 4 if affine else 0
    vec = 2 * co * 4 + aff
    fwd = m * ci * 2 + nw * 2 + m * co * 2 + aff + 2 * co * 4
    data = 2 * m * co * 2 + nw * 2 + m * ci * 2 \
        + (m * ci * 2 if affine else 0) + vec + aff
    filt = m * ci * 2 + 2 * m * co * 2 + vec + nw * 4
    return _least(fwd, flops), _least(data, flops), _least(filt, flops)


def units_forward_s(visual: dict, clips: Iterable[int], frames: int,
                    size: int) -> float:
    """Least seconds of every unit launch of forwards over ``clips``."""
    return sum(unit_bounds(u)[0] for c in clips
               for u in fused_units(visual, c, frames, size))


def units_train_s(visual: dict, clips: int, frames: int, size: int) -> float:
    """Least seconds of one train step's unit launches: forward, data and
    filter gradient of each unit."""
    return sum(sum(unit_bounds(u))
               for u in fused_units(visual, clips, frames, size))
