"""Where the temporal filter-gradient kernel's time goes, on the card.

Times ``conv_unit_bwd_filter(kind="temporal")`` at the four temporal units
of the full-width ``fusion`` train step (32 clips, BN prologue on), beside:

- the same kernel at each channel block it can take (48, 64);
- three ablations of ``csrc/conv_bn.cu`` built with ``-DTF_ABLATE``: without
  forming x̂ and ge (1), without the products (2), without both, which
  leaves the cp.async ring streaming x, gy and y (3) — their dw is wrong,
  they are timed only;
- cuDNN's weight gradient (``torch.nn.grad.conv3d_weight``) on x̂ and ge
  already formed, and a device copy of x (the card's memory rate on this
  tensor).

Run on a machine with an NVIDIA GPU, from the repository root:

    python -m m3f_torch.scripts.temporal_filter_sweep [--reps 20]

It prints the ``nvidia-smi`` card line, then one JSON line per shape with
the median ms of ``--reps`` calls between CUDA events. Nothing runs at
import.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from typing import Callable, Dict

import torch

from m3f_torch.nn import resolve_device
from m3f_torch.ops import conv_bn, cuda_lib

# (x shape, C_out) of the fusion train step's temporal units, 32 clips
SHAPES = (((32, 16, 56, 56, 144), 64), ((32, 8, 28, 28, 288), 128),
          ((32, 4, 14, 14, 576), 256), ((32, 2, 7, 7, 1152), 512))
ABLATIONS = {"no_forming": 1, "no_products": 2, "streaming_only": 3}
HBM = 3.35e12            # H100 SXM memory rate, B/s
PEAK_BF16 = 989e12       # H100 SXM dense bf16 tensor rate, FLOP/s


def build_ablations() -> Dict[str, Callable]:
    """``m3f_conv_unit_bwd_filter`` of each ablation build (one nvcc per
    build, all at once, under build/kernels/ablate/)."""
    out = cuda_lib.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    src = str(cuda_lib.CSRC / "conv_bn.cu")
    procs = {name: subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, f"-DTF_ABLATE={k}", "-o",
         str(out / f"libconv_bn_ablate{k}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for name, k in ABLATIONS.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
        fn = ctypes.CDLL(str(out / f"libconv_bn_ablate{ABLATIONS[name]}.so")
                         ).m3f_conv_unit_bwd_filter
        fn.argtypes = cuda_lib.SIGNATURES["conv_bn"]["m3f_conv_unit_bwd_filter"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def timed(fn: Callable, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def launch(fn, x, inv, shift, y, gy, gs1, gs2, ci_blk: int) -> torch.Tensor:
    """One call of a build's C entry point with the planner's tiling and
    ``ci_blk`` (what ``conv_unit_bwd_filter`` does, minus its checks)."""
    b, t, h, w, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_bn.temporal_filter_plan(b, t, h, w, ci, co, sms)
    dw = torch.empty(3 * ci, co, dtype=torch.float32, device=x.device)
    part = torch.empty(plan.slices * 3 * ci * co, dtype=torch.float32,
                       device=x.device) if plan.slices > 1 else None
    err = fn(x.data_ptr(), gy.data_ptr(), y.data_ptr(), gs1.data_ptr(),
             gs2.data_ptr(), inv.data_ptr(), shift.data_ptr(), dw.data_ptr(),
             None if part is None else part.data_ptr(), 1, b, t, h, w, ci, co,
             plan.co_tile, plan.slices, ci_blk, plan.strip,
             cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "temporal filter sweep")
    return dw


def sweep(reps: int) -> None:
    dev = resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cuda_lib.build(["conv_bn"])
    main = cuda_lib.library("conv_bn").m3f_conv_unit_bwd_filter
    ablated = build_ablations()
    g = torch.Generator(device=dev).manual_seed(12)
    for xs, co in SHAPES:
        ci = xs[-1]
        x = torch.randn(*xs, device=dev, generator=g).to(torch.bfloat16)
        inv = torch.rand(ci, device=dev, generator=g) + 0.5
        shift = torch.randn(ci, device=dev, generator=g) * 0.1
        y = torch.randn(*xs[:-1], co, device=dev, generator=g).to(torch.bfloat16)
        gy = (torch.randn(*xs[:-1], co, device=dev, generator=g) * 1e-2
              ).to(torch.bfloat16)
        gs1 = torch.randn(co, device=dev, generator=g) * 1e-5
        gs2 = torch.randn(co, device=dev, generator=g) * 1e-6
        args = (x, inv, shift, y, gy, gs1, gs2)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = conv_bn.temporal_filter_plan(*xs, co, sms)
        row = {"x": list(xs), "co": co, "plan": plan._asdict(),
               "ms": timed(lambda: conv_bn.conv_unit_bwd_filter(
                   *args, kind="temporal"), reps)}
        for cb in (48, 64):
            row[f"ci_blk_{cb}_ms"] = timed(lambda: launch(main, *args, cb), reps)
        for name, fn in ablated.items():
            row[f"{name}_ms"] = timed(lambda: launch(fn, *args, plan.ci_blk), reps)
        xn = conv_bn._prologue(x, inv, shift).permute(0, 4, 1, 2, 3)
        gn = conv_bn._gy_eff(gy, y, gs1, gs2).permute(0, 4, 1, 2, 3)
        row["cudnn_ms"] = timed(lambda: torch.nn.grad.conv3d_weight(
            xn, (co, ci, 3, 1, 1), gn, padding=(1, 0, 0)), reps)
        buf = torch.empty_like(x)
        row["copy_x_ms"] = timed(lambda: buf.copy_(x), reps)
        m = x.numel() // ci
        flops = 2 * m * 3 * ci * co
        nbytes = m * ci * 2 + 2 * m * co * 2 + 2 * ci * 4 + 2 * co * 4 \
            + 3 * ci * co * 4
        row["bound_ms"] = max(nbytes / HBM, flops / PEAK_BF16) * 1e3
        row["tflops"] = flops / row["ms"] / 1e9
        row["input_TBps"] = nbytes / row["ms"] / 1e9
        print(json.dumps(row), flush=True)
        del x, y, gy, xn, gn, buf, args
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    sweep(ap.parse_args(argv).reps)


if __name__ == "__main__":
    main()
