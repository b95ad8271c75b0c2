"""Packed-layout (channels-major) stage-1 spatial conv probe on the card.

Counterpart of ``scripts/probe_packed_conv.py``. The question it asks: does
a channels-major layout (positions on the minor axis, the conv as
``Y[COUT, HWP] = W[COUT, K] @ P[K, HWP]`` per image, the im2col P built from
nine shifted slabs) beat the library conv on the model's native
channels-last layout, at the fusion model's heaviest conv, the stage-1
spatial conv ``[32,16,56,56,64] -> 144``? The kernels are
``m3f_torch.ops.packed_conv`` (``csrc/packed_conv.cu``).

Run on a machine with an NVIDIA GPU, from the repository root:

    python -m m3f_torch.scripts.probe_packed_conv [--iters 30] [--run ...]

``M3F_PROBE_COUT=128`` probes COUT 128. ``--run`` takes a comma list of the
JAX script's phases:

- ``check``: packed_conv and packed_conv_chunked against ``reference_conv``
  over the first HW positions, max relative error below 2e-2;
- ``xla``: ``reference_conv``, the library conv (``F.conv2d``, cuDNN) on
  the native layout, in the place of the JAX script's XLA conv; its TF/s,
  measured in the same run, is the bar the packed kernels are printed
  against;
- ``v1``, ``v2-chunked``: ``packed_conv`` (bf16 y), ``packed_conv_chunked``;
- ``ablate``: ``ablate_slabs`` (the im2col alone) and ``ablate_matmul``
  (the product alone, on one resident P);
- ``gemm``: ``torch.matmul`` at the conv's GEMM shapes (positions-major
  ``[M, K] x [K, COUT]`` and ``x [K, 128]``, channels-major ``[COUT, K] x
  [K, M]``, M = 131072), the ceiling of a plain product.

Times are CUDA events around ``--iters`` calls after a warm one. Nothing
runs at import.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from m3f_torch.nn import resolve_device
from m3f_torch.ops.packed_conv import (ProbeShape, ablate_matmul, ablate_slabs,
                                       pack_w, pack_x, packed_conv,
                                       packed_conv_chunked)

REL_LIMIT = 2e-2            # probe_packed_conv.py:333
GEMM_M = 131072             # rows of the GEMM-ceiling products
PHASES = ("check", "xla", "v1", "v2-chunked", "ablate", "gemm")
VARIANTS = {"v1": packed_conv, "v2-chunked": packed_conv_chunked}


def reference_conv(x_nd: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """The same conv by the library on the native layout: ``x_nd`` [BT, H,
    W, CIN], ``w_hwio`` [3, 3, CIN, COUT] -> [BT, H, W, COUT] in x's dtype
    (a channels-last ``F.conv2d`` with zero padding 1)."""
    w = w_hwio.to(x_nd.dtype).permute(3, 2, 0, 1) \
        .contiguous(memory_format=torch.channels_last)
    return F.conv2d(x_nd.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def rel_err(got_cm: torch.Tensor, want_nd: torch.Tensor,
            shape: ProbeShape) -> float:
    """max |got - want| / max |want| over the first HW positions, computed
    on the tensors' device (one scalar comes back)."""
    got = got_cm[:, :, :shape.HW].float().transpose(1, 2).reshape(want_nd.shape)
    want = want_nd.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()


def make_inputs(shape: ProbeShape, device, seed: int = 0):
    """The JAX script's inputs (probe_packed_conv.py:317-324) from ``seed``:
    x [B,T,H,W,CIN] and w [3,3,CIN,COUT] / sqrt(K), packed (``x_cm``,
    ``w_cm``) and native (``x_nd``, ``w_nd``), bf16 on ``device``; the
    numpy generator comes back too, for ``p_const``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(shape.B, shape.T, shape.H, shape.W, shape.CIN).astype(np.float32)
    w = (rng.randn(3, 3, shape.CIN, shape.COUT) / np.sqrt(shape.K)).astype(np.float32)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device).to(torch.bfloat16)
    return {"x_cm": dev(pack_x(x, shape)), "w_cm": dev(pack_w(w)),
            "x_nd": dev(x.reshape(shape.BT, shape.H, shape.W, shape.CIN)),
            "w_nd": dev(w)}, rng


def check(inputs: Dict[str, torch.Tensor], shape: ProbeShape) -> Dict[str, float]:
    """Each packed variant's max relative error against reference_conv."""
    want = reference_conv(inputs["x_nd"], inputs["w_nd"])
    return {name: rel_err(fn(inputs["x_cm"], inputs["w_cm"], shape), want, shape)
            for name, fn in VARIANTS.items()}


def measure(fn, *args, iters: int = 30) -> float:
    """Seconds per call: CUDA events around ``iters`` calls after a warm
    one (the calls queue in order on one stream)."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def gemm_ceiling(shape: ProbeShape, device, iters: int = 30
                 ) -> List[Tuple[str, float, int]]:
    """(name, seconds, flop) of ``torch.matmul`` with bf16 output at the
    conv's three GEMM shapes (probe_packed_conv.py:285-299)."""
    rng = np.random.RandomState(1)
    m, k, co = GEMM_M, shape.K, shape.COUT
    rows = []
    for name, a_shape, b_shape in (
            (f"positions-major [M,{k}]x[{k},{co}]", (m, k), (k, co)),
            (f"positions-major [M,{k}]x[{k},128]", (m, k), (k, 128)),
            (f"channels-major  [{co},{k}]x[{k},M]", (co, k), (k, m))):
        a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)
                .to(torch.bfloat16) for s in (a_shape, b_shape))
        rows.append((f"gemm {name}", measure(torch.matmul, a, b, iters=iters),
                     2 * a_shape[0] * a_shape[1] * b_shape[1]))
    return rows


def run(shape: ProbeShape, todo: Sequence[str], iters: int = 30) -> dict:
    """The phases ``todo`` at ``shape`` on the GPU -> {"check": {variant:
    max rel err}, "rows": [(name, seconds per call, flop)]}. Raises without
    a GPU, and when a checked variant is off by REL_LIMIT or more."""
    unknown = sorted(set(todo) - set(PHASES))
    if unknown:
        raise ValueError(f"unknown phases {unknown}; choose from {PHASES}")
    dev = resolve_device("cuda")
    inputs, rng = make_inputs(shape, dev)
    args = (inputs["x_cm"], inputs["w_cm"], shape)
    flop = 2 * shape.BT * shape.HW * shape.K * shape.COUT
    out = {"check": {}, "rows": []}
    if "check" in todo:
        out["check"] = check(inputs, shape)
        bad = {k: v for k, v in out["check"].items() if not v < REL_LIMIT}
        if bad:
            raise RuntimeError(f"packed conv vs reference_conv: max rel err "
                               f"{bad}, limit {REL_LIMIT}")
    rows = out["rows"]
    if "xla" in todo:
        rows.append(("reference_conv (F.conv2d, NHWC)",
                     measure(reference_conv, inputs["x_nd"], inputs["w_nd"],
                             iters=iters), flop))
    for name, fn in VARIANTS.items():
        if name in todo:
            rows.append((f"packed {name}", measure(fn, *args, iters=iters), flop))
    if "ablate" in todo:
        rows.append(("ablate: im2col slabs only",
                     measure(ablate_slabs, *args, iters=iters), flop))
        p_const = torch.from_numpy(rng.randn(shape.K, shape.HWP).astype(np.float32)) \
            .to(dev).to(torch.bfloat16)
        rows.append(("ablate: matmul only",
                     measure(ablate_matmul, p_const, inputs["w_cm"], shape,
                             iters=iters), flop))
    if "gemm" in todo:
        rows += gemm_ceiling(shape, dev, iters)
    return out


def card() -> str:
    """The card's ``nvidia-smi`` name and power limit."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--run", default=",".join(PHASES),
                    help=f"comma list of phases: {', '.join(PHASES)}")
    args = ap.parse_args(argv)
    resolve_device("cuda")
    shape = ProbeShape(COUT=int(os.environ.get("M3F_PROBE_COUT", "144")))
    print(f"card: {card()}")
    print(f"shape: {shape}")
    res = run(shape, args.run.split(","), args.iters)
    for name, err in res["check"].items():
        print(f"{name}: max rel err vs reference_conv {err:.2e}")
    bar = next((fl / t for name, t, fl in res["rows"]
                if name.startswith("reference_conv")), None)
    for name, t, fl in res["rows"]:
        beats = bar is not None and name.startswith("packed") and fl / t > bar
        print(f"{name}: {t * 1e3:.4f} ms  {fl / t / 1e12:.1f} TF/s"
              + (f"  <-- beats reference_conv ({bar / 1e12:.1f} TF/s)"
                 if beats else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
