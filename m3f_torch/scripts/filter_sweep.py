"""Where the walk kernels' time goes, on the card: both filter gradients,
both data gradients, both forward units, the mel frontend, the GRU
recurrence and the packed-layout conv of the layout probe.

Times ``conv_unit_bwd_filter`` (``--kind spatial``, the row walk, or
``--kind temporal``, the frame walk) or ``conv_unit_bwd_data`` of the
temporal unit (``--kind temporal_data``, its frame walk) or of the spatial
unit (``--kind spatial_data``, its row walk) at the four units of that kind
in the full-width ``fusion`` train step (32 clips, BN prologue on), beside:

- the same kernel at each tiling it can take: the temporal kernel's channel
  blocks (48, 64); the spatial kernel's channel tiles (64 x 48, 32 x 48)
  and its steps (48 .. 128 output pixels, where the rings fit shared
  memory);
- ablations of ``csrc/conv_bn.cu`` built with ``-DSF_ABLATE`` /
  ``-DTF_ABLATE``: without forming x̂ and ge (1), without the products (2),
  without both, which leaves the cp.async rings streaming x, gy and y (3),
  and for the spatial kernel without the copies (4: the rings stay zero),
  with the products alone (5), the forming alone (6) and the walk alone
  (7: cursors, tables, barriers, the partials and their sum) — their dw
  is wrong, they are timed only;
- cuDNN's weight gradient (``torch.nn.grad.conv3d_weight``) on x̂ and ge
  already formed, and a device copy of x (the card's memory rate on this
  tensor);
- for ``temporal_data``: the planner's tiling, one and two frames ahead,
  half and a quarter of the units per block, twice the blocks, and (built
  with ``-DTD_TRIALS``) the layouts not kept: 12 warps on 64 positions, and
  two blocks a multiprocessor of 32 positions with 4 warps or with 6 capped
  at 168 registers; ablations built with ``-DTD_ABLATE``: without forming
  ge (1), without the products (2), without the copies of gy, y and x (4),
  without the epilogue (8: mask, scale, sums, dx stores), and with only the
  rings streaming (11); cuDNN's data gradient
  (``torch.nn.grad.conv3d_input``) on ge already formed, and a device copy
  of the same bytes (gy, y and x in, dx out);
- for ``spatial_data``: with and without the prologue, the planner's tiling
  and every step the entry point takes where its buffers fit (256 and 128
  output pixels x 64 input channels); ablations built with
  ``-DSD_ABLATE``: without forming ge (1), without the products (2),
  without the copies of gy, y and x (4), without the epilogue (8), and with
  the filter stream alone (15); cuDNN's data gradient
  (``torch.nn.grad.conv3d_input``) on ge already formed, and a device copy
  of the same bytes;
- ``--kind spatial_fwd``: ``conv_unit_fwd`` of the spatial unit (its row
  walk) at the four spatial units of the serving forward (128 clips), with
  and without the prologue: the planner's tiling, both layouts (steps of
  128 x 144 output channels, 256 x 64) with the filter resident and
  streamed where they fit; ablations built with ``-DSW_ABLATE``: without
  forming x̂ (1), the products (2), the copies (4), the epilogue (8), and
  the walk alone (15); cuDNN's conv alone and with the fp32 sums of y, a
  device copy of x and y, and with ``--parent`` an earlier ``conv_bn.cu``'s
  spatial forward (the per-tap gather), timed before and after the rest;
- ``--kind temporal_fwd``: ``conv_unit_fwd`` of the temporal unit (its
  frame walk) at the four temporal units of the serving forward (128 clips)
  and of the train step (32 clips), with the prologue, every time a device
  time (``timed`` queued): in alternating rounds (``alternating``) the
  wrapper, the planner's tiling through the C entry twice (the gap between
  the two is the spread of identical launches), every layout (strips of
  128 x 64 output channels, and of 64 x 64 two blocks a SM, the filter
  resident and streamed where they fit) at the planner's chunks and at
  twice as many, and the ranges the planner took before it counted waves
  and one unit a range;
  ablations built with ``-DTW_ABLATE``: without forming x̂ (1), the
  products (2), the copies (4), the epilogue (8), and the walk alone (15);
  cuDNN's conv alone and with the fp32 sums of y, a device copy of x and y,
  and with ``--parent`` an earlier ``conv_bn.cu``'s temporal forward (the
  per-tap gather, ``conv_unit_kernel``), timed before and after the rest;
- ``--kind spatial_fwd_f32``: ``conv_unit_fwd`` of the spatial unit at fp32
  x (the row walk ``spatial_fwd_f32_kernel`` in ``csrc/conv_bn_f32.cu``) at
  the four spatial units of the serving forward (128 clips) and at a
  stage-1 unit of 112x112 images (``data.image_size=224``, 32 clips: the
  plan's 8-channel chunks), with and without the prologue, every time a
  device time: in alternating rounds the wrapper, the planner's layout
  through the C entry twice (their gap is the spread of identical
  launches), every layout the plan
  can choose (N tiles of 144 and 128, K chunks of 16 and 8) through the C
  entry, the per-tap gather (``conv_f32_kernel``, the first design and the
  route of images too wide for the walk) through this source's
  ``m3f_conv_unit_fwd_f32`` and, with ``--parent``, through an earlier
  ``conv_bn_f32.cu``'s, and cuDNN's fp32 conv plus the sums (TF32 off);
  ablations built with ``-DSWF_ABLATE``: without
  forming x̂ (1), the products (2), the copies (4), the epilogue (8), and
  the walk alone (15); cuDNN's conv alone and a device copy of x and y;
- ``--kind temporal_fwd_f32``: ``conv_unit_fwd`` of the temporal unit at
  fp32 x (the frame walk ``temporal_fwd_f32_kernel`` in
  ``csrc/conv_bn_f32.cu``) at the four temporal units of the serving
  forward (128 clips) and of the train step (32 clips), with and without
  the prologue, every time a device time: in alternating rounds the
  wrapper, the planner's layout through the C entry twice, the filter
  resident and streamed where each fits, with ``--parent`` an earlier
  ``conv_bn_f32.cu``'s temporal forward (the per-tap gather, kind 1 of
  its ``m3f_conv_unit_fwd_f32``, ``PARENT_F32_SIGNATURE``), and
  cuDNN's fp32 conv plus the sums (TF32 off); ablations built with
  ``-DTWF_ABLATE``: without forming x̂ (1), the products (2), the copies
  (4), the epilogue (8), and the walk alone (15); cuDNN's conv alone and a
  device copy of x and y. Both fp32 kinds run one check and one sweep
  (``check_fwd_f32`` / ``sweep_fwd_f32``) from their row of ``F32_FWD``;
  every bound counts the (position, tap) pairs inside the clip
  (``conv_bn.tap_pairs``);
- ``--kind spatial_filter_f32``: ``conv_unit_bwd_filter`` of the spatial
  unit at fp32 x (the row walk ``spatial_filter_f32_kernel`` in
  ``csrc/conv_bn_f32.cu``) at the four spatial units of the train step (32
  clips) and at a stage-1 unit of 112x112 images, with and without the
  prologue, every time a device time: in alternating rounds the wrapper,
  the planner's layout through the C entry twice, every layout the plan can
  choose (N tiles of 144 and 128, steps of 128, 64 and 32), the per-tap
  gather (``bwd_filter_f32_kernel``, the first design and the route of
  images too wide for the walk) through this source's entry and, with
  ``--parent``, through an earlier ``conv_bn_f32.cu``'s, and cuDNN's fp32
  ``conv3d_weight`` on x̂ and ge already formed (TF32 off); ablations built
  with ``-DSFF_ABLATE`` (the fold of ge runs in each): without forming x̂
  (1), the products (2), the copies (4), the epilogue (8), the copies alone
  (3: no forming, no products), the products alone (5), the forming alone
  (6), and the walk alone (15); a device copy of x, gy and y;
- ``--kind spatial_data_f32``: ``conv_unit_bwd_data`` of the spatial unit
  at fp32 x (the row walk ``spatial_data_f32_kernel`` in
  ``csrc/conv_bn_f32.cu``, with its K split's second pass) at the four
  spatial units of the train step (32 clips) and at a stage-1 unit of
  112x112 images, with and without the prologue, every time a device time:
  in alternating rounds the wrapper, the planner's layout through the C
  entry twice, every layout the plan can choose (N tiles of 128 and 64, K
  chunks of 16 and 8, each with the plan's split for it) and the plan's
  layout with its K whole, the per-tap gather (``bwd_data_f32_kernel``,
  the first design and the route of images too wide for the walk) through
  this source's entry and, with ``--parent``, through an earlier
  ``conv_bn_f32.cu``'s, and cuDNN's fp32 ``conv3d_input`` on ge already
  formed (TF32 off); ablations built with ``-DSDF_ABLATE``: without
  forming ge (1), the products (2), the copies (4), the epilogue (8), and
  the walk alone (15); a device copy of gy, y and x;
- ``--kind temporal_data_f32``: ``conv_unit_bwd_data`` of the temporal
  unit at fp32 x (the frame walk ``temporal_data_f32_kernel`` in
  ``csrc/conv_bn_f32.cu``) at the four temporal units of the train step
  (32 clips, with the prologue), every time a device time: in alternating
  rounds the wrapper, the planner's layout through the C entry twice,
  every N tile the plan can choose (64, 144) and the plan's with
  the filter resident and streamed, with ``--parent`` an earlier
  ``conv_bn_f32.cu``'s per-tap gather (``bwd_data_f32_kernel``, the first
  design), and cuDNN's fp32 ``conv3d_input`` on ge already formed (TF32
  off); ablations built with ``-DTDF_ABLATE``: without folding ge (1), the
  products (2), the copies (4), the epilogue (8), the walk alone (15), and
  x read from global memory in the epilogue in place of its copies ahead
  (16, the first design); a device copy of gy, y and x;
- ``--kind temporal_filter_f32``: ``conv_unit_bwd_filter`` of the temporal
  unit at fp32 x (the frame walk ``temporal_filter_f32_kernel`` in
  ``csrc/conv_bn_f32.cu``) at the four temporal units of the train step
  (32 clips, with the prologue), every time a device time: in alternating
  rounds the wrapper, the planner's layout through the C entry twice,
  every layout the plan can choose (channel blocks of 48 and 64 over
  strips of 32, four and three blocks a SM), the planner's layout in other
  slice counts, with
  ``--parent`` an earlier ``conv_bn_f32.cu``'s per-tap gather
  (``bwd_filter_f32_kernel``, the first design), and cuDNN's fp32
  ``conv3d_weight`` on x̂ and ge already formed (TF32 off); ablations
  built with ``-DTFF_ABLATE``: without forming x̂ and folding ge (1), the
  products (2), the copies (4), the dw stores (8), the walk alone (15),
  and the sums stored in channel order (64, b and the sum in one register
  bank); a device copy of x, gy and y. ``--check`` also counts the
  walk's FFMAs whose sources meet in a register bank, from the built
  library's SASS;
- ``--kind mel``: the mel kernel (one mixed-radix FFT walk) at the
  serving path's shapes (static and per-row hop) with n_fft 1024 and 400,
  and untimed at the other radices up to the largest n_fft its plan takes,
  against the plain version, and beside ``torch.stft`` + the mel matmul in
  turn (5 rounds);
- ``--kind gru``: the GRU's cluster walk (``gru_cluster_kernel``) at the
  serving (16 sequences of 128 steps) and train (8 of 64, fp32 carries)
  shapes, bf16 and fp32 W, every time a device time: in alternating rounds
  the wrapper, its C entry twice, the stream route (the first design),
  the planner's cluster with K in 1, 2 and 4 warp parts, clusters of 16
  blocks, ``nn.GRU`` and the port's layer (input projection, then the
  kernel) on the same input, and with ``--parent`` an earlier ``gru.cu``'s
  ``m3f_gru_fwd``; ablation builds ``-DGRU_ABLATE``: without the products
  (1), the exchange (2), the walk alone (5: exchange and cluster barrier,
  the chain's floor, also per step), a block barrier in place of the
  cluster barrier (8), without the output stores (16) or the xp copies
  (32);
- ``--kind packed``: the packed-layout conv's walk (``packed_tma_kernel``,
  rows 9 and 12) at the probe's full shape, COUT 144, 128, 152 and 192,
  every time a device time: in alternating rounds rows 9 (bf16 and fp32
  y), 12, 10 and 11 through the wrappers, every layout of
  ``packed_conv.LAYOUTS`` that fits through the C entry (whole and
  chunked), ``--parent``'s rows 9, 12, 10 and 11 (an earlier
  ``packed_conv.cu``, the ``mma.sync`` design),
  ``F.conv2d`` channels-last, ``torch.matmul`` at the GEMM shapes and a
  device copy of x and y; ablation builds ``-DPK_ABLATE``: without the
  products (1: copies, fragment loads, mask and stores, the byte floor),
  the mask (2), the y stores (4, the products kept live) and with one x
  window for all three dy (8: the cost of the window reads);
- ``--kind packed_ablate``: the probe's two ablation kernels (row 10,
  ``ablate_slabs_kernel``; row 11, ``ablate_matmul_kernel``) at the same
  full shapes, every time a device time: in alternating rounds rows 10 and
  11 through the wrappers, every layout of ``ablation_plan`` that fits
  (row 11: ``packed_conv.MATMUL_LAYOUTS``; row 10: ring depths, one x
  window a tile or one a dy) through
  the C entry, ``--parent``'s rows 10 and 11 (an earlier
  ``packed_conv.cu``'s ``m3f_packed_conv``), ``torch.matmul`` batched over
  BT and a device copy of x and y; ablation builds ``-DPA_ABLATE``: without
  the products (1, row 11), the mask (2, row 10), the y stores (4) and with
  the rows >= COUT not formed (8, row 10).

Run on a machine with an NVIDIA GPU, from the repository root:

    python -m m3f_torch.scripts.filter_sweep --kind spatial [--reps 20]
    python -m m3f_torch.scripts.filter_sweep --kind spatial --check
    python -m m3f_torch.scripts.filter_sweep --kind temporal_data --check
    python -m m3f_torch.scripts.filter_sweep --kind spatial_data --check
    python -m m3f_torch.scripts.filter_sweep --kind spatial_fwd --check
    python -m m3f_torch.scripts.filter_sweep --kind spatial_fwd \
        --parent build/parent/conv_bn.cu
    python -m m3f_torch.scripts.filter_sweep --kind spatial_fwd_f32 --check \
        [--parent build/parent/conv_bn_f32.cu]
    python -m m3f_torch.scripts.filter_sweep --kind spatial_fwd_f32 \
        --parent build/parent/conv_bn_f32.cu
    python -m m3f_torch.scripts.filter_sweep --kind spatial_filter_f32 --check
    python -m m3f_torch.scripts.filter_sweep --kind spatial_filter_f32 \
        [--reps 10] [--parent build/parent/conv_bn_f32.cu]
    python -m m3f_torch.scripts.filter_sweep --kind spatial_data_f32 --check
    python -m m3f_torch.scripts.filter_sweep --kind spatial_data_f32 \
        [--reps 10] [--parent build/parent/conv_bn_f32.cu]
    python -m m3f_torch.scripts.filter_sweep --kind temporal_data_f32 --check \
        [--parent build/parent/conv_bn_f32.cu]
    python -m m3f_torch.scripts.filter_sweep --kind temporal_data_f32 \
        [--reps 10] [--parent build/parent/conv_bn_f32.cu]
    python -m m3f_torch.scripts.filter_sweep --kind temporal_filter_f32 \
        --check [--parent build/parent/conv_bn_f32.cu]
    python -m m3f_torch.scripts.filter_sweep --kind temporal_filter_f32 \
        [--reps 10] [--parent build/parent/conv_bn_f32.cu]
    python -m m3f_torch.scripts.filter_sweep --kind temporal_fwd_f32 --check
    python -m m3f_torch.scripts.filter_sweep --kind temporal_fwd_f32 \
        [--reps 10] [--parent build/parent/conv_bn_f32.cu]
    python -m m3f_torch.scripts.filter_sweep --kind temporal_fwd --check
    python -m m3f_torch.scripts.filter_sweep --kind temporal_fwd \
        --parent build/parent/conv_bn.cu
    python -m m3f_torch.scripts.filter_sweep --kind mel [--check]
    python -m m3f_torch.scripts.filter_sweep --kind gru [--check] \
        [--parent build/parent/gru.cu]
    python -m m3f_torch.scripts.filter_sweep --kind packed [--check] \
        [--parent build/parent/packed_conv.cu]
    python -m m3f_torch.scripts.filter_sweep --kind packed_ablate [--check] \
        [--parent build/parent/packed_conv.cu]

It prints the ``nvidia-smi`` card line, then one JSON line per shape with
the median ms of ``--reps`` calls between CUDA events. ``--check`` instead
prints what ``ptxas`` says of the kernel (registers, spills, shared memory)
and holds the kernel once against the plain version at each shape and at a
few small ones (``temporal_data``: at every layout the entry point takes;
``spatial_data``: at every step; ``spatial_fwd``: at every layout, filter
resident and streamed; ``spatial_fwd_f32``, ``temporal_fwd_f32``,
``spatial_filter_f32``, ``spatial_data_f32``, ``temporal_data_f32``,
``temporal_filter_f32``: at every layout, and the per-tap gathers;
``temporal_fwd``: at every layout; ``gru``: on both routes at the edge
shapes too, and at every layout; ``packed`` and
``packed_ablate``: every layout at small, edge and full shapes, and an
input one element off 16 bytes, which must give the plain version's y).
Nothing runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from m3f_torch.nn import resolve_device
from m3f_torch.ops import conv_bn, cuda_lib, gru, packed_conv

# (x shape, C_out) of the fusion train step's units, 32 clips
SHAPES = {
    "spatial": (((32, 16, 56, 56, 64), 144), ((32, 8, 28, 28, 128), 288),
                ((32, 4, 14, 14, 256), 576), ((32, 2, 7, 7, 512), 1152)),
    "temporal": (((32, 16, 56, 56, 144), 64), ((32, 8, 28, 28, 288), 128),
                 ((32, 4, 14, 14, 576), 256), ((32, 2, 7, 7, 1152), 512))}
SMALL = {"spatial": (((3, 5, 7, 9, 24), 40), ((2, 3, 5, 7, 152), 40),
                     ((3, 4, 1, 1, 16), 8)),
         "temporal": (((2, 3, 10, 10, 152), 40),)}
KNOB = {"spatial": "SF_ABLATE", "temporal": "TF_ABLATE"}
ABLATIONS = {"no_forming": 1, "no_products": 2, "streaming_only": 3}
# spatial only: without the copies (the rings stay zero), alone and with one
# of the other two left out
NO_COPIES = {"no_copies": 4, "products_only": 5, "forming_only": 6,
             "walk_only": 7}
SPATIAL_STEPS = (48, 64, 80, 96, 112, 128)
TAPS = {"spatial": 9, "temporal": 3}
HBM = 3.35e12            # H100 SXM memory rate, B/s
PEAK_BF16 = 989e12       # H100 SXM dense bf16 tensor rate, FLOP/s
PEAK_FP32 = 67e12        # H100 SXM fp32 rate outside the tensor cores


def build_variants(defines: Dict[str, str],
                   entry: str = "m3f_conv_unit_bwd_filter",
                   sources: Optional[Dict[str, str]] = None,
                   argtypes: Optional[list] = None) -> Dict[str, Callable]:
    """``entry`` of conv_bn.cu built with each ``-D`` (one nvcc per build,
    all at once, under build/kernels/ablate/); ``sources`` names another
    source file for a build (a define of "" adds none), ``argtypes`` another
    C signature."""
    out = cuda_lib.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    src = str(cuda_lib.CSRC / "conv_bn.cu")
    sources = sources or {}
    procs = {name: subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS,
         *(f"-D{d}".split() if d else []), "-o",
         str(out / f"libconv_bn_{name}.so"), sources.get(name, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for name, d in defines.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
        fn = getattr(ctypes.CDLL(str(out / f"libconv_bn_{name}.so")), entry)
        fn.argtypes = argtypes or cuda_lib.SIGNATURES["conv_bn"][entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def resources(kind: str) -> None:
    """Print what ptxas says of the kind's kernels
    (``<kind>_filter_kernel``, ``temporal_data_kernel``,
    ``spatial_data_kernel``, ``spatial_fwd_kernel``, ``temporal_fwd_kernel``;
    in conv_bn_f32.cu ``spatial_fwd_f32_kernel``,
    ``temporal_fwd_f32_kernel``, ``spatial_filter_f32_kernel``,
    ``spatial_data_f32_kernel``, ``data_split_sum_f32_kernel``,
    ``temporal_data_f32_kernel`` and ``temporal_filter_f32_kernel``;
    in melspec.cu ``log_mel_kernel`` (tables in shared or device memory);
    in gru.cu
    ``gru_cluster_kernel`` and ``gru_kernel``)."""
    kernels = {"spatial_fwd": ("spatial_fwd_kernel",),
               "spatial_fwd_f32": ("spatial_fwd_f32_kernel",),
               "spatial_filter_f32": ("spatial_filter_f32_kernel",),
               "spatial_data_f32": ("spatial_data_f32_kernel",
                                    "data_split_sum_f32_kernel"),
               "temporal_data_f32": ("temporal_data_f32_kernel",),
               "temporal_filter_f32": ("temporal_filter_f32_kernel",),
               "temporal_fwd_f32": ("temporal_fwd_f32_kernel",),
               "temporal_fwd": ("temporal_fwd_kernel",),
               "mel": ("log_mel",),
               "gru": ("18gru_cluster_kernel", "10gru_kernel")}.get(
        kind, (f"{kind}_kernel" if kind.endswith("_data")
               else f"{kind}_filter_kernel",))
    source = {"mel": "melspec", "gru": "gru", "spatial_fwd_f32": "conv_bn_f32",
              "temporal_fwd_f32": "conv_bn_f32",
              "spatial_filter_f32": "conv_bn_f32",
              "spatial_data_f32": "conv_bn_f32",
              "temporal_data_f32": "conv_bn_f32",
              "temporal_filter_f32": "conv_bn_f32"}.get(kind, "conv_bn")
    log = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         "/dev/null", *(["-DTD_TRIALS"] if kind == "temporal_data" else []),
         str(cuda_lib.CSRC / f"{source}.cu")],
        capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed:\n{log.stdout}{log.stderr}")
    lines = log.stderr.splitlines()
    for i, line in enumerate(lines):
        kernel = next((k for k in kernels if k in line), None)
        if "Compiling entry function" in line and kernel:
            name = line.split("'")[1]
            print(json.dumps({"kernel": name[name.index(kernel) - 2:][:72],
                              "ptxas": [l.strip() for l in lines[i + 1:i + 4]]}),
                  flush=True)


def ffma_bank_conflicts(lib, kernel: str) -> Dict[str, Dict[str, int]]:
    """For each function of the built library ``lib`` whose name holds
    ``kernel``: its FFMAs, and those of them whose source registers read
    from the register file (not marked ``.reuse``) include two in one bank
    (register number mod 2), from ``cuobjdump -sass``. Such an FFMA waits a
    cycle for its second read; the count shows when ptxas lays a kernel's
    sums out against its operands (temporal_filter_f32_kernel's epilogue
    note)."""
    nvcc = Path(cuda_lib._nvcc())
    sass = subprocess.run([str(nvcc.with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return count_ffma_bank_conflicts(sass, kernel)


def count_ffma_bank_conflicts(sass: str, kernel: str
                              ) -> Dict[str, Dict[str, int]]:
    """``ffma_bank_conflicts`` on the text of ``cuobjdump -sass``."""
    ins = re.compile(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"(FFMA[A-Z0-9_.]*)\s+(.*?);")
    counts = {}
    for func in re.split(r"\n\s*Function : ", sass):
        name = func.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        total = clash = 0
        for line in func.splitlines():
            m = ins.match(line)
            if not m:
                continue
            regs = [r.strip() for r in m.group(2).split(",")][1:4]
            banks = [int(r[1:].split(".")[0]) % 2 for r in regs
                     if re.fullmatch(r"R\d+", r)]
            total += 1
            clash += len(banks) != len(set(banks))
        counts[name[name.index(kernel):]] = {"ffma": total,
                                             "bank_conflicts": clash}
    return counts


SPIN_CYCLES = 2_000_000  # ~1 ms of torch.cuda._sleep, longer than a call's
#                          host work (planner, allocations, launches)
ROUNDS = 5               # rounds of --reps calls in ``alternating``


def timed(fn: Callable, reps: int, queued: bool = False) -> float:
    """Median ms of ``reps`` calls, each between two CUDA events. With
    ``queued`` each call is queued behind a spin kernel, so the host has
    launched the whole call before the first event is reached: the events
    then time the device alone, not the host's launch work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def alternating(fns: Dict[str, Callable], reps: int) -> Dict[str, list]:
    """``fns`` timed in turn (``timed``, queued) for ROUNDS rounds: {name:
    [median of the round medians, largest - smallest round median]}."""
    per = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            per[name].append(timed(fn, reps, queued=True))
    return {name: [statistics.median(v), max(v) - min(v)]
            for name, v in per.items()}


def launch(fn, kind: str, x, inv, shift, y, gy, gs1, gs2,
           ci_blk: Optional[int] = None, co_tile: Optional[int] = None,
           step: Optional[int] = None) -> Optional[torch.Tensor]:
    """One call of a build's C entry point with the planner's tiling, or
    with ``ci_blk`` / ``co_tile`` / ``step`` in its place (what
    ``conv_unit_bwd_filter`` does, minus its checks). None when the entry
    point refuses the tiling (the rings do not fit shared memory)."""
    b, t, h, w, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if kind == "spatial":
        plan = conv_bn.spatial_filter_plan(b, t, h, w, ci, co, sms)
        strip = step or plan.step
    else:
        plan = conv_bn.temporal_filter_plan(b, t, h, w, ci, co, sms)
        strip = plan.strip
    k = TAPS[kind] * ci
    dw = torch.empty(k, co, dtype=torch.float32, device=x.device)
    part = torch.empty(plan.slices * k * co, dtype=torch.float32,
                       device=x.device) if plan.slices > 1 else None
    err = fn(x.data_ptr(), gy.data_ptr(), y.data_ptr(), gs1.data_ptr(),
             gs2.data_ptr(), inv.data_ptr(), shift.data_ptr(), dw.data_ptr(),
             None if part is None else part.data_ptr(),
             0 if kind == "spatial" else 1, b, t, h, w, ci, co,
             co_tile or plan.co_tile, plan.slices, ci_blk or plan.ci_blk,
             strip, cuda_lib.stream_ptr(x))
    if err == 1 and kind == "spatial" and (step or co_tile):
        return None                      # cudaErrorInvalidValue: no such tiling
    cuda_lib.check(err, f"{kind} filter sweep")
    return dw


def inputs(xs, co, dev, g):
    ci = xs[-1]
    x = torch.randn(*xs, device=dev, generator=g).to(torch.bfloat16)
    inv = torch.rand(ci, device=dev, generator=g) + 0.5
    shift = torch.randn(ci, device=dev, generator=g) * 0.1
    y = torch.randn(*xs[:-1], co, device=dev, generator=g).to(torch.bfloat16)
    gy = (torch.randn(*xs[:-1], co, device=dev, generator=g) * 1e-2
          ).to(torch.bfloat16)
    gs1 = torch.randn(co, device=dev, generator=g) * 1e-5
    gs2 = torch.randn(co, device=dev, generator=g) * 1e-6
    return x, inv, shift, y, gy, gs1, gs2


def check(kind: str) -> None:
    """ptxas' resource lines, then the kernel once against the plain version
    at each train shape and a few small ones: max |dw - ref| over the
    largest |ref|, and whether a second call repeats dw bit for bit."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False      # the plain version in fp32
    resources(kind)
    cuda_lib.build(["conv_bn"])
    g = torch.Generator(device=dev).manual_seed(12)
    for xs, co in SMALL[kind] + SHAPES[kind]:
        args = inputs(xs, co, dev, g)
        dw = conv_bn.conv_unit_bwd_filter(*args, kind=kind)
        again = conv_bn.conv_unit_bwd_filter(*args, kind=kind)
        torch.cuda.synchronize()
        ref = conv_bn.conv_unit_bwd_filter_reference(*args, kind=kind)
        print(json.dumps({
            "x": list(xs), "co": co,
            "max_err_over_max_ref": ((dw - ref).abs().max() / ref.abs().max()).item(),
            "repeats": torch.equal(dw, again)}), flush=True)
        del args, dw, again, ref
        torch.cuda.empty_cache()


def sweep(kind: str, reps: int) -> None:
    dev = resolve_device("cuda")
    cuda_lib.build(["conv_bn"])
    main = cuda_lib.library("conv_bn").m3f_conv_unit_bwd_filter
    defines = {name: f"{KNOB[kind]}={k}" for name, k in ABLATIONS.items()}
    if kind == "spatial":
        defines.update({name: f"SF_ABLATE={k}" for name, k in NO_COPIES.items()})
    built = build_variants(defines)
    g = torch.Generator(device=dev).manual_seed(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_of = conv_bn.spatial_filter_plan if kind == "spatial" \
        else conv_bn.temporal_filter_plan
    ksize, pad = ((1, 3, 3), (0, 1, 1)) if kind == "spatial" \
        else ((3, 1, 1), (1, 0, 0))
    for xs, co in SHAPES[kind]:
        ci = xs[-1]
        args = inputs(xs, co, dev, g)
        x, inv, shift, y, gy, gs1, gs2 = args
        plan = plan_of(*xs, co, sms)
        row = {"kind": kind, "x": list(xs), "co": co, "plan": plan._asdict(),
               "ms": timed(lambda: conv_bn.conv_unit_bwd_filter(
                   *args, kind=kind), reps)}

        def variant(key, fn, **tiling):
            if launch(fn, kind, *args, **tiling) is not None:
                row[key] = timed(lambda: launch(fn, kind, *args, **tiling), reps)
        if kind == "temporal":
            for cb in (48, 64):
                variant(f"ci_blk_{cb}_ms", main, ci_blk=cb)
        else:
            for cb, ct in conv_bn._SPATIAL_TILES:
                variant(f"tile_{cb}x{ct}_ms", main, ci_blk=cb, co_tile=ct)
            for step in SPATIAL_STEPS:
                variant(f"step_{step}_ms", main, step=step)
        for name, fn in built.items():
            variant(f"{name}_ms", fn)
        xn = conv_bn._prologue(x, inv, shift).permute(0, 4, 1, 2, 3)
        gn = conv_bn._gy_eff(gy, y, gs1, gs2).permute(0, 4, 1, 2, 3)
        row["cudnn_ms"] = timed(lambda: torch.nn.grad.conv3d_weight(
            xn, (co, ci) + ksize, gn, padding=pad), reps)
        buf = torch.empty_like(x)
        row["copy_x_ms"] = timed(lambda: buf.copy_(x), reps)
        m = x.numel() // ci
        flops = 2 * conv_bn.tap_pairs(kind, *xs[:4]) * ci * co
        nbytes = m * ci * 2 + 2 * m * co * 2 + 2 * ci * 4 + 2 * co * 4 \
            + TAPS[kind] * ci * co * 4
        row["bound_ms"] = max(nbytes / HBM, flops / PEAK_BF16) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_BF16 \
            else "operations"
        row["tflops"] = flops / row["ms"] / 1e9
        row["input_TBps"] = nbytes / row["ms"] / 1e9
        print(json.dumps(row), flush=True)
        del x, y, gy, xn, gn, buf, args
        torch.cuda.empty_cache()


# --- the temporal data gradient -------------------------------------------

TD_ABLATIONS = {"no_forming": 1, "no_products": 2, "no_copies": 4,
                "no_epilogue": 8, "streaming_only": 11}
# (strip, warps, resident, ahead) of every layout the entry point takes
# (12 warps, and 4 warps on 32 positions, only in a -DTD_TRIALS build, where
# (32, 6, 1, 1) is the build capped at two blocks' registers)
TD_LAYOUTS = ((64, 8, 1, 2), (64, 8, 1, 1), (64, 12, 1, 2), (32, 6, 1, 2),
              (32, 6, 1, 1), (32, 4, 1, 1), (32, 6, 0, 1), (16, 6, 0, 1))
# small shapes (x shape, C_out): a partial strip and masked channels; T = 1
# with C_in over one N tile; C_out wide enough that the planner streams the
# filter with 32 and with 16 positions
TD_SMALL = (((2, 3, 10, 10, 152), 40), ((3, 1, 6, 5, 160), 24),
            ((2, 4, 5, 5, 40), 160), ((2, 2, 3, 3, 24), 344))


def data_inputs(xs, co, dev, g):
    x, inv, shift, y, gy, gs1, gs2 = inputs(xs, co, dev, g)
    ci = xs[-1]
    w = ((torch.rand(3, ci, co, device=dev, generator=g) * 2 - 1)
         / (3 * ci) ** 0.5).to(torch.bfloat16)
    return x, w, inv, shift, y, gy, gs1, gs2


def launch_data(fn, x, w, inv, shift, y, gy, gs1, gs2, layout=None,
                per_block: Optional[int] = None):
    """One call of a build's ``m3f_conv_unit_bwd_data`` for the temporal
    unit with the planner's tiling, or with ``layout`` = (strip, warps,
    resident, ahead) / ``per_block`` units a block in its place (what
    ``conv_unit_bwd_data`` does, minus its checks). None when the entry
    point refuses the layout (its rings do not fit shared memory, or the
    build lacks it)."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_bn.temporal_data_plan(b, t, h, wd, ci, co, sms)
    strip, warps, resident, ahead = layout or (
        plan.strip, plan.warps, int(plan.resident), plan.ahead)
    units = b * -(-h * wd // strip)
    per = per_block or (plan.units_per_block if not layout else -(
        -units // max(1, min(units, sms // plan.n_tiles))))
    rows = -(-units // per)
    dx = torch.empty_like(x)
    dinv = torch.empty(ci, dtype=torch.float32, device=x.device)
    dshift = torch.empty_like(dinv)
    part = torch.empty(2 * rows * ci, dtype=torch.float32, device=x.device)
    err = fn(gy.data_ptr(), y.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
             w.data_ptr(), x.data_ptr(), inv.data_ptr(), shift.data_ptr(),
             dx.data_ptr(), dinv.data_ptr(), dshift.data_ptr(),
             part.data_ptr(), 1, b, t, h, wd, ci, co, plan.n_tile, per, strip,
             warps, resident, ahead, cuda_lib.stream_ptr(x))
    if err == 1 and layout:
        return None                      # cudaErrorInvalidValue: no such layout
    cuda_lib.check(err, "temporal data sweep")
    return dx, dinv, dshift


def _data_errors(got, ref) -> Dict[str, float]:
    """max |dx - ref| over max |ref|, and the same of dinv and dshift."""
    return {k: ((a.float() - r.float()).abs().max()
                / r.float().abs().max().clamp_min(1e-30)).item()
            for k, a, r in zip(("dx", "dinv", "dshift"), got, ref)}


def check_data() -> None:
    """ptxas' resource lines, then the temporal data gradient against the
    plain version: the wrapper once at each small and each train shape (and
    whether a second call repeats dx, dinv and dshift bit for bit), and at
    the small shapes every layout the entry point takes."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False      # the plain version in fp32
    resources("temporal_data")
    cuda_lib.build(["conv_bn"])
    trials = build_variants({"trials": "TD_TRIALS"}, "m3f_conv_unit_bwd_data")
    g = torch.Generator(device=dev).manual_seed(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in TD_SMALL + SHAPES["temporal"]:
        args = data_inputs(xs, co, dev, g)
        got = conv_bn.conv_unit_bwd_data(*args, kind="temporal")
        again = conv_bn.conv_unit_bwd_data(*args, kind="temporal")
        torch.cuda.synchronize()
        ref = conv_bn.conv_unit_bwd_data_reference(*args, kind="temporal")
        plan = conv_bn.temporal_data_plan(*xs, co, sms)
        row = {"x": list(xs), "co": co,
               "plan": [plan.strip, plan.warps, plan.resident, plan.ahead],
               "max_err_over_max_ref": _data_errors(got, ref),
               "repeats": all(torch.equal(a, b) for a, b in zip(got, again))}
        if (xs, co) in TD_SMALL:
            for layout in TD_LAYOUTS:
                out = launch_data(trials["trials"], *args, layout=layout)
                torch.cuda.synchronize()
                row["layout_" + "_".join(map(str, layout))] = \
                    None if out is None else _data_errors(out, ref)
        print(json.dumps(row), flush=True)
        del args, got, again, ref
        torch.cuda.empty_cache()


def sweep_data(reps: int) -> None:
    dev = resolve_device("cuda")
    cuda_lib.build(["conv_bn"])
    main = cuda_lib.library("conv_bn").m3f_conv_unit_bwd_data
    defines = {name: f"TD_ABLATE={k}" for name, k in TD_ABLATIONS.items()}
    defines["trials"] = "TD_TRIALS"
    built = build_variants(defines, "m3f_conv_unit_bwd_data")
    trials = built.pop("trials")
    g = torch.Generator(device=dev).manual_seed(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in SHAPES["temporal"]:
        ci = xs[-1]
        args = data_inputs(xs, co, dev, g)
        x, w, inv, shift, y, gy, gs1, gs2 = args
        plan = conv_bn.temporal_data_plan(*xs, co, sms)
        row = {"kind": "temporal_data", "x": list(xs), "co": co,
               "plan": plan._asdict(),
               "ms": timed(lambda: conv_bn.conv_unit_bwd_data(
                   *args, kind="temporal"), reps)}

        def variant(key, fn, **tiling):
            if launch_data(fn, *args, **tiling) is not None:
                row[key] = timed(lambda: launch_data(fn, *args, **tiling), reps)
        variant("entry_ms", main)
        for layout in TD_LAYOUTS:
            key = "layout_" + "_".join(map(str, layout))
            variant(key + "_ms", trials, layout=layout)
            # twice the blocks: two a multiprocessor where they fit
            units = xs[0] * -(-xs[2] * xs[3] // layout[0])
            variant(key + "_two_blocks_ms", trials, layout=layout,
                    per_block=-(-units // max(1, 2 * sms // plan.n_tiles)))
        for div in (2, 4):
            variant(f"units_per_block_over_{div}_ms", main,
                    per_block=max(1, plan.units_per_block // div))
        for name, fn in built.items():
            variant(f"{name}_ms", fn)
        kern, pad = conv_bn._torch_kernel(w, "temporal")
        kern = kern.contiguous(memory_format=torch.channels_last_3d)
        gn = conv_bn._gy_eff(gy, y, gs1, gs2).permute(0, 4, 1, 2, 3)
        xshape = (xs[0], ci) + tuple(xs[1:4])
        row["cudnn_ms"] = timed(lambda: torch.nn.grad.conv3d_input(
            xshape, kern, gn, padding=pad), reps)
        bx, bg = torch.empty_like(x), torch.empty_like(gy)
        row["copy_same_bytes_ms"] = timed(
            lambda: (bx.copy_(x), bg.copy_(gy)), reps)
        m = x.numel() // ci
        flops = 2 * conv_bn.tap_pairs("temporal", *xs[:4]) * ci * co
        nbytes = 2 * m * co * 2 + 2 * m * ci * 2 + 3 * ci * co * 2 \
            + 2 * co * 4 + 4 * ci * 4
        row["bound_ms"] = max(nbytes / HBM, flops / PEAK_BF16) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_BF16 \
            else "operations"
        row["tflops"] = flops / row["ms"] / 1e9
        row["TBps"] = nbytes / row["ms"] / 1e9
        print(json.dumps(row), flush=True)
        del x, y, gy, gn, bx, bg, args
        torch.cuda.empty_cache()


# --- the spatial data gradient --------------------------------------------

SD_ABLATIONS = {"no_forming": 1, "no_products": 2, "no_copies": 4,
                "no_epilogue": 8, "filter_stream_only": 15}
# small shapes (x shape, C_out): a partial N tile and masked pixels (W = 9,
# steps spanning rows and images); C_in 152; one-pixel images; wide C_out
SD_SMALL = (((3, 5, 7, 9, 24), 40), ((2, 3, 5, 7, 152), 40),
            ((3, 4, 1, 1, 16), 8), ((1, 2, 14, 14, 40), 512),
            ((1, 2, 7, 7, 24), 1024))


def spatial_data_inputs(xs, co, dev, g):
    x, inv, shift, y, gy, gs1, gs2 = inputs(xs, co, dev, g)
    ci = xs[-1]
    w = ((torch.rand(3, 3, ci, co, device=dev, generator=g) * 2 - 1)
         / (9 * ci) ** 0.5).to(torch.bfloat16)
    return x, w, inv, shift, y, gy, gs1, gs2


def launch_spatial_data(fn, x, w, inv, shift, y, gy, gs1, gs2, step=None):
    """One call of a build's ``m3f_conv_unit_bwd_data`` for the spatial unit
    with the planner's tiling, or with ``step`` output pixels a step in its
    place (what ``conv_unit_bwd_data`` does, minus its checks); ``inv`` None
    leaves the prologue out. None when the entry point refuses the step (its
    buffers do not fit)."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_bn.spatial_data_plan(b, t, h, wd, ci, co, sms)
    wf = w.flip((0, 1)).movedim(-2, 0).reshape(ci, 9 * co).contiguous()
    dx = torch.empty_like(x)
    ptr = lambda v: None if v is None else v.data_ptr()
    dinv = dshift = part = None
    if inv is not None:
        dinv = torch.empty(ci, dtype=torch.float32, device=x.device)
        dshift = torch.empty_like(dinv)
        part = torch.empty(2 * plan.part_rows * ci, dtype=torch.float32,
                           device=x.device)
    err = fn(gy.data_ptr(), y.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
             wf.data_ptr(), None if inv is None else x.data_ptr(), ptr(inv),
             ptr(shift), dx.data_ptr(), ptr(dinv), ptr(dshift), ptr(part), 0,
             b, t, h, wd, ci, co, plan.n_tile, plan.images_per_range,
             step or plan.step, plan.warps, 0, 0, cuda_lib.stream_ptr(x))
    if err == 1 and step:
        return None                      # cudaErrorInvalidValue: no such step
    cuda_lib.check(err, f"spatial data sweep, step {step}")
    return dx, dinv, dshift


def check_spatial_data() -> None:
    """ptxas' resource lines, then the spatial data gradient against the
    plain version, with and without the prologue: the wrapper once at each
    small and each train shape (and whether a second call repeats dx, dinv
    and dshift bit for bit), and at the small shapes every step the entry
    point takes where it fits."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False      # the plain version in fp32
    resources("spatial_data")
    cuda_lib.build(["conv_bn"])
    main = cuda_lib.library("conv_bn").m3f_conv_unit_bwd_data
    g = torch.Generator(device=dev).manual_seed(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in SD_SMALL + SHAPES["spatial"]:
        x, w, inv, shift, y, gy, gs1, gs2 = spatial_data_inputs(xs, co, dev, g)
        plan = conv_bn.spatial_data_plan(*xs, co, sms)
        row = {"x": list(xs), "co": co, "plan": [plan.step, plan.buf_rows]}
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            args = (x, w, *a, y, gy, gs1, gs2)
            got = conv_bn.conv_unit_bwd_data(*args, kind="spatial")
            again = conv_bn.conv_unit_bwd_data(*args, kind="spatial")
            torch.cuda.synchronize()
            ref = conv_bn.conv_unit_bwd_data_reference(*args, kind="spatial")
            n = 3 if affine else 1
            key = "affine" if affine else "plain"
            row[key] = {"max_err_over_max_ref": _data_errors(got[:n], ref[:n]),
                        "repeats": all(torch.equal(p, q)
                                       for p, q in zip(got[:n], again[:n]))}
            if (xs, co) in SD_SMALL:
                for step in conv_bn._SD_STEPS:
                    out = launch_spatial_data(main, *args, step=step)
                    torch.cuda.synchronize()
                    row[key][f"step_{step}"] = \
                        None if out is None else _data_errors(out[:n], ref[:n])
            del got, again, ref
        print(json.dumps(row), flush=True)
        del x, y, gy
        torch.cuda.empty_cache()


def sweep_spatial_data(reps: int) -> None:
    dev = resolve_device("cuda")
    cuda_lib.build(["conv_bn"])
    main = cuda_lib.library("conv_bn").m3f_conv_unit_bwd_data
    built = build_variants({name: f"SD_ABLATE={k}"
                            for name, k in SD_ABLATIONS.items()},
                           "m3f_conv_unit_bwd_data")
    g = torch.Generator(device=dev).manual_seed(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in SHAPES["spatial"]:
        ci = xs[-1]
        x, w, inv, shift, y, gy, gs1, gs2 = spatial_data_inputs(xs, co, dev, g)
        plan = conv_bn.spatial_data_plan(*xs, co, sms)
        kern, pad = conv_bn._torch_kernel(w, "spatial")
        kern = kern.contiguous(memory_format=torch.channels_last_3d)
        gn = conv_bn._gy_eff(gy, y, gs1, gs2).permute(0, 4, 1, 2, 3)
        xshape = (xs[0], ci) + tuple(xs[1:4])
        cudnn = timed(lambda: torch.nn.grad.conv3d_input(
            xshape, kern, gn, padding=pad), reps)
        m = x.numel() // ci
        flops = 2 * conv_bn.tap_pairs("spatial", *xs[:4]) * ci * co
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            args = (x, w, *a, y, gy, gs1, gs2)
            row = {"kind": "spatial_data", "x": list(xs), "co": co,
                   "affine": affine, "plan": plan._asdict(),
                   "ms": timed(lambda: conv_bn.conv_unit_bwd_data(
                       *args, kind="spatial"), reps)}
            row["entry_ms"] = timed(lambda: launch_spatial_data(main, *args), reps)
            for step in conv_bn._SD_STEPS:
                if launch_spatial_data(main, *args, step=step) is not None:
                    row[f"step_{step}_ms"] = timed(
                        lambda: launch_spatial_data(main, *args, step=step), reps)
            if affine:
                for name, fn in built.items():
                    row[f"{name}_ms"] = timed(
                        lambda: launch_spatial_data(fn, *args), reps)
            row["cudnn_ms"] = cudnn
            if affine:      # x and gy read and written: gy, y, x in, dx out
                bx, bg = torch.empty_like(x), torch.empty_like(gy)
                row["copy_same_bytes_ms"] = timed(
                    lambda: (bx.copy_(x), bg.copy_(gy)), reps)
                del bx, bg
            nbytes = 2 * m * co * 2 + m * ci * 2 + 9 * ci * co * 2 + 2 * co * 4
            if affine:
                nbytes += m * ci * 2 + 4 * ci * 4
            row["bound_ms"] = max(nbytes / HBM, flops / PEAK_BF16) * 1e3
            row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_BF16 \
                else "operations"
            row["tflops"] = flops / row["ms"] / 1e9
            row["TBps"] = nbytes / row["ms"] / 1e9
            print(json.dumps(row), flush=True)
        del x, y, gy, gn, args
        torch.cuda.empty_cache()


# --- the spatial forward ----------------------------------------------------

# (x shape, C_out) of the serving forward's spatial units, 128 clips
FWD_SHAPES = (((128, 16, 56, 56, 64), 144), ((128, 8, 28, 28, 128), 288),
              ((128, 4, 14, 14, 256), 576), ((128, 2, 7, 7, 512), 1152))
SW_ABLATIONS = {"no_forming": 1, "no_products": 2, "no_copies": 4,
                "no_epilogue": 8, "walk_only": 15}
# small shapes (x shape, C_out): both layouts, masked channels, partial
# chunks, steps spanning images, one-pixel images, the filter streamed
SW_SMALL = (((3, 5, 7, 9, 24), 40), ((2, 3, 5, 7, 32), 136),
            ((8, 250, 3, 5, 24), 40), ((2, 2, 11, 13, 152), 288),
            ((1, 2, 9, 9, 200), 152), ((1, 2, 6, 6, 264), 288),
            ((3, 4, 1, 1, 16), 8), ((1, 2, 7, 7, 24), 1152))
# the parent's C entry (the per-tap gather kernel, KIND 0): x, wk, inv,
# shift, y, s1, s2, part, kind, B, T, H, W, Ci, Co, bn, tiles_per_block, stream
PARENT_FWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def fwd_inputs(xs, co, dev, g):
    ci = xs[-1]
    x = torch.randn(*xs, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.rand(3, 3, ci, co, device=dev, generator=g) * 2 - 1) / (9 * ci) ** 0.5
    inv = torch.rand(ci, device=dev, generator=g) + 0.5
    shift = torch.randn(ci, device=dev, generator=g) * 0.1
    return x, w, inv, shift


def _wk(w):
    """[3, 3, Ci, Co] → the kernels' [Co, 9·Ci] bf16 B operand."""
    return w.to(torch.bfloat16).movedim(-1, 0).reshape(w.shape[-1], -1).contiguous()


def launch_spatial_fwd(fn, x, wk, inv, shift, layout=None, resident=None):
    """One call of a build's ``m3f_conv_unit_fwd`` for the spatial unit with
    the planner's tiling, or with ``layout`` = (step, N tile) / ``resident``
    in its place (what ``conv_unit_fwd`` does, minus its checks); ``inv``
    None leaves the prologue out. None when the entry point refuses it."""
    b, t, h, wd, ci = x.shape
    co = wk.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_bn.spatial_fwd_plan(b, t, h, wd, ci, co, sms)
    step, nb = layout or (plan.step, plan.n_tile)
    res = plan.resident if resident is None else resident
    n_tiles = -(-co // nb)
    per = -(-plan.images // max(1, min(plan.images, sms // n_tiles)))
    rows = -(-plan.images // per)
    y = torch.empty(*x.shape[:-1], co, dtype=x.dtype, device=x.device)
    s1 = torch.empty(co, dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    part = torch.empty(2 * rows * co, dtype=torch.float32, device=x.device)
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(x.data_ptr(), wk.data_ptr(), ptr(inv), ptr(shift), y.data_ptr(),
             s1.data_ptr(), s2.data_ptr(), part.data_ptr(), 0, b, t, h, wd, ci,
             co, nb, per, step, int(res), 0, cuda_lib.stream_ptr(x))
    if err == 1 and (layout or resident is not None):
        return None                      # cudaErrorInvalidValue: no such tiling
    cuda_lib.check(err, f"spatial forward sweep, {layout} resident={res}")
    return y, s1, s2


def _parent_tiling(m: int, co: int, dev) -> tuple:
    """The per-tap gather kernel's tiling (the parent sources' planner):
    the widest N tile of 64, 96, 48 dividing C_out (else 64), and row tiles
    of 128 pixels a block for ~4 waves of the card, at most 8; returns
    (N tile, row tiles a block, partial rows)."""
    bn = next((n for n in (64, 96, 48) if co % n == 0), 64)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles_m = -(-m // 128)
    tpb = max(1, min(8, tiles_m * (-(-co // bn)) // (4 * sms)))
    return bn, tpb, -(-tiles_m // tpb)


def launch_parent_fwd(fn, x, wk, inv, shift, kind=0, extra=()):
    """One call of a parent source's per-tap gather forward (spatial kind
    0, or temporal kind 1) with the parent's tiling; ``extra`` are the
    trailing int arguments its C entry takes beyond ``tiles_per_block``."""
    b, t, h, wd, ci = x.shape
    co = wk.shape[0]
    bn, tpb, rows = _parent_tiling(b * t * h * wd, co, x.device)
    y = torch.empty(*x.shape[:-1], co, dtype=x.dtype, device=x.device)
    s1 = torch.empty(co, dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    part = torch.empty(2 * rows * co, dtype=torch.float32, device=x.device)
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(x.data_ptr(), wk.data_ptr(), ptr(inv), ptr(shift), y.data_ptr(),
             s1.data_ptr(), s2.data_ptr(), part.data_ptr(), kind, b, t, h, wd,
             ci, co, bn, tpb, *extra, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "parent forward")
    return y, s1, s2


def _fwd_errors(got, ref) -> Dict[str, float]:
    """max |y - ref| over max |ref|, and the same of s1 and s2."""
    return {k: ((a.float() - r.float()).abs().max()
                / r.float().abs().max().clamp_min(1e-30)).item()
            for k, a, r in zip(("y", "s1", "s2"), got, ref)}


def check_spatial_fwd() -> None:
    """ptxas' resource lines, then the spatial forward against the plain
    version, with and without the prologue: the wrapper once at each small
    and each serving shape (and whether a second call repeats y, s1 and s2
    bit for bit), and at the small shapes both layouts, filter resident and
    streamed, where the entry point takes them."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resources("spatial_fwd")
    cuda_lib.build(["conv_bn"])
    main = cuda_lib.library("conv_bn").m3f_conv_unit_fwd
    g = torch.Generator(device=dev).manual_seed(13)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in SW_SMALL + FWD_SHAPES:
        x, w, inv, shift = fwd_inputs(xs, co, dev, g)
        plan = conv_bn.spatial_fwd_plan(*xs, co, sms)
        row = {"x": list(xs), "co": co,
               "plan": [plan.step, plan.n_tile, plan.resident, plan.buf_rows]}
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            got = conv_bn.conv_unit_fwd(x, w, *a, kind="spatial")
            again = conv_bn.conv_unit_fwd(x, w, *a, kind="spatial")
            torch.cuda.synchronize()
            ref = conv_bn.conv_unit_reference(x, w, *a, kind="spatial")
            key = "affine" if affine else "plain"
            row[key] = {"max_err_over_max_ref": _fwd_errors(got, ref),
                        "repeats": all(torch.equal(p, q)
                                       for p, q in zip(got, again))}
            if (xs, co) in SW_SMALL:
                for layout in conv_bn._SW_LAYOUTS:
                    for res in (True, False):
                        out = launch_spatial_fwd(main, x, _wk(w), *a,
                                                 layout=layout, resident=res)
                        torch.cuda.synchronize()
                        row[key][f"{layout[0]}x{layout[1]}_res{int(res)}"] = \
                            None if out is None else _fwd_errors(out, ref)
            del got, again, ref
        print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()


def sweep_spatial_fwd(reps: int, parent: Optional[str]) -> None:
    import torch.nn.functional as F
    dev = resolve_device("cuda")
    cuda_lib.build(["conv_bn"])
    main = cuda_lib.library("conv_bn").m3f_conv_unit_fwd
    defines = {name: f"SW_ABLATE={k}" for name, k in SW_ABLATIONS.items()}
    built = build_variants(defines, "m3f_conv_unit_fwd")
    old = None
    if parent:
        old = build_variants({"parent": ""}, "m3f_conv_unit_fwd",
                             {"parent": parent}, PARENT_FWD_ARGS)["parent"]
    g = torch.Generator(device=dev).manual_seed(13)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in FWD_SHAPES:
        ci = xs[-1]
        x, w, inv, shift = fwd_inputs(xs, co, dev, g)
        wk = _wk(w)
        plan = conv_bn.spatial_fwd_plan(*xs, co, sms)
        kern, pad = conv_bn._torch_kernel(w.to(x.dtype), "spatial")
        kern = kern.contiguous(memory_format=torch.channels_last_3d)
        m = x.numel() // ci
        flops = 2 * conv_bn.tap_pairs("spatial", *xs[:4]) * ci * co
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            xh = conv_bn._prologue(x, *a).permute(0, 4, 1, 2, 3)
            row = {"kind": "spatial_fwd", "x": list(xs), "co": co,
                   "affine": affine, "plan": plan._asdict()}
            if old is not None:
                row["parent_ms"] = [timed(lambda: launch_parent_fwd(
                    old, x, wk, *a), reps)]
            row["ms"] = timed(lambda: conv_bn.conv_unit_fwd(
                x, w, *a, kind="spatial"), reps)
            row["entry_ms"] = timed(
                lambda: launch_spatial_fwd(main, x, wk, *a), reps)
            for layout in conv_bn._SW_LAYOUTS:
                for res in (True, False):
                    if launch_spatial_fwd(main, x, wk, *a, layout=layout,
                                          resident=res) is not None:
                        row[f"{layout[0]}x{layout[1]}_res{int(res)}_ms"] = timed(
                            lambda: launch_spatial_fwd(main, x, wk, *a,
                                                       layout=layout,
                                                       resident=res), reps)
            if affine:
                for name, fn in built.items():
                    row[f"{name}_ms"] = timed(
                        lambda: launch_spatial_fwd(fn, x, wk, *a), reps)

            def sums():
                yf = F.conv3d(xh, kern, padding=pad).float()
                return yf.sum((0, 2, 3, 4)), (yf * yf).sum((0, 2, 3, 4))
            row["cudnn_conv_ms"] = timed(lambda: F.conv3d(xh, kern, padding=pad),
                                         reps)
            row["cudnn_conv_sums_ms"] = timed(sums, reps)
            bx = torch.empty_like(x)
            by = torch.empty(*xs[:-1], co, dtype=x.dtype, device=dev)
            sy = torch.zeros_like(by)
            row["copy_x_and_y_ms"] = timed(lambda: (bx.copy_(x), by.copy_(sy)), reps)
            if old is not None:
                row["parent_ms"].append(timed(lambda: launch_parent_fwd(
                    old, x, wk, *a), reps))
            nbytes = m * ci * 2 + m * co * 2 + 9 * ci * co * 2 + 2 * co * 4 \
                + (2 * ci * 4 if affine else 0)
            row["bound_ms"] = max(nbytes / HBM, flops / PEAK_BF16) * 1e3
            row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_BF16 \
                else "operations"
            row["tflops"] = flops / row["ms"] / 1e9
            print(json.dumps(row), flush=True)
            del xh, bx, by, sy
        del x
        torch.cuda.empty_cache()


# --- the temporal forward ---------------------------------------------------

# (x shape, C_out) of the temporal units: the serving forward (128 clips)
# and the train step (32 clips)
TW_SHAPES = tuple(((clips, t, s, s, mid), c)
                  for clips in (128, 32)
                  for c, t, s, mid in ((64, 16, 56, 144), (128, 8, 28, 288),
                                       (256, 4, 14, 576), (512, 2, 7, 1152)))
TW_ABLATIONS = {"no_forming": 1, "no_products": 2, "no_copies": 4,
                "no_epilogue": 8, "walk_only": 15}
# (strip, N tile, filter resident) of every layout the entry point takes
TW_LAYOUTS = tuple((s, n, r) for r in (True, False)
                   for s, n in conv_bn._TW_BUILT)
# small shapes (x shape, C_out): T 7 / 1 / 2 / 3, a partial strip, a strip
# spanning clips, masked channels (C_in 40, 152; C_out 24, 40), chunks
# (C_in 296, 576: several a frame), the filter streamed (C_out 344), widths
# that are not multiples of 8 (the wrapper pads them)
TW_SMALL = (((2, 7, 5, 3, 40), 24), ((3, 1, 6, 5, 24), 16),
            ((2, 2, 9, 9, 48), 40), ((2, 3, 10, 10, 152), 40),
            ((1, 3, 9, 8, 8), 96), ((2, 3, 7, 5, 296), 144),
            ((2, 4, 5, 5, 40), 160), ((2, 2, 3, 3, 24), 344),
            ((3, 3, 7, 7, 576), 256), ((2, 3, 4, 5, 12), 20),
            ((1, 2, 6, 6, 108), 48))
# the parent's C entry (the per-tap gather, KIND 1): x, wk, inv, shift, y,
# s1, s2, part, kind, B, T, H, W, Ci, Co, bn, tiles_per_block, step,
# resident, stream
PARENT_TW_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def tw_inputs(xs, co, dev, g):
    ci = xs[-1]
    x = torch.randn(*xs, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.rand(3, ci, co, device=dev, generator=g) * 2 - 1) / (3 * ci) ** 0.5
    inv = torch.rand(ci, device=dev, generator=g) + 0.5
    shift = torch.randn(ci, device=dev, generator=g) * 0.1
    return x, w, inv, shift


def _wk_t(w):
    """[3, Ci, Co] → the kernels' [Co, 3·Ci] bf16 B operand."""
    return w.to(torch.bfloat16).movedim(-1, 0).reshape(w.shape[-1], -1).contiguous()


def launch_temporal_fwd(fn, x, wk, inv, shift, layout=None, chunks=None,
                        per=None):
    """One call of a build's ``m3f_conv_unit_fwd`` for the temporal unit
    with the planner's tiling, or with ``layout`` = (strip, N tile,
    resident), ``chunks`` a frame and ``per`` units a range in its place
    (what ``conv_unit_fwd`` does, minus its checks); ``inv`` None leaves
    the prologue out. None when the entry point (or the planner) refuses
    it."""
    b, t, h, wd, ci = x.shape
    co = wk.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    try:
        plan = conv_bn.temporal_fwd_plan(b, t, h, wd, ci, co, sms, layout)
    except ValueError:
        return None
    kc = plan.k_chunk
    if chunks:
        kc = conv_bn._cdiv(conv_bn._cdiv(ci, chunks), 16) * 16
    per = per or plan.units_per_block
    y = torch.empty(*x.shape[:-1], co, dtype=x.dtype, device=x.device)
    s1 = torch.empty(co, dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    part = torch.empty(2 * conv_bn._cdiv(plan.units, per) * co,
                       dtype=torch.float32, device=x.device)
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(x.data_ptr(), wk.data_ptr(), ptr(inv), ptr(shift), y.data_ptr(),
             s1.data_ptr(), s2.data_ptr(), part.data_ptr(), 1, b, t, h, wd, ci,
             co, plan.n_tile, per, plan.strip, int(plan.resident), kc,
             cuda_lib.stream_ptr(x))
    if err == 1 and (layout or chunks):
        return None                      # cudaErrorInvalidValue: no such tiling
    cuda_lib.check(err, f"temporal forward sweep, {layout} {chunks} {per}")
    return y, s1, s2


def _tw_per_one_wave(plan, sms: int) -> int:
    """The units a range the planner took before it filled a wave: at most
    blocks-a-SM x sms // n_tiles ranges, as few as that allows."""
    slots = conv_bn._TW_BUILT[(plan.strip, plan.n_tile)] * sms
    return conv_bn._cdiv(plan.units,
                         max(1, min(plan.units, slots // plan.n_tiles)))


def check_temporal_fwd() -> None:
    """ptxas' resource lines, then the temporal forward against the plain
    version, with and without the prologue: the wrapper once at each small,
    serving and train shape (and whether a second call repeats y, s1 and s2
    bit for bit), and at the small shapes every layout the entry point
    takes."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resources("temporal_fwd")
    cuda_lib.build(["conv_bn"])
    main = cuda_lib.library("conv_bn").m3f_conv_unit_fwd
    g = torch.Generator(device=dev).manual_seed(15)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in TW_SMALL + TW_SHAPES:
        x, w, inv, shift = tw_inputs(xs, co, dev, g)
        ci8, co8 = -(-xs[-1] // 8) * 8, -(-co // 8) * 8
        plan = conv_bn.temporal_fwd_plan(*xs[:-1], ci8, co8, sms)
        row = {"x": list(xs), "co": co,
               "plan": [plan.strip, plan.n_tile, plan.resident, plan.k_chunk,
                        plan.chunks, plan.blocks]}
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            got = conv_bn.conv_unit_fwd(x, w, *a, kind="temporal")
            again = conv_bn.conv_unit_fwd(x, w, *a, kind="temporal")
            torch.cuda.synchronize()
            ref = conv_bn.conv_unit_reference(x, w, *a, kind="temporal")
            key = "affine" if affine else "plain"
            row[key] = {"max_err_over_max_ref": _fwd_errors(got, ref),
                        "repeats": all(torch.equal(p, q)
                                       for p, q in zip(got, again))}
            if (xs, co) in TW_SMALL and xs[-1] % 8 == 0 and co % 8 == 0:
                for layout in TW_LAYOUTS:
                    out = launch_temporal_fwd(main, x, _wk_t(w), *a,
                                              layout=layout)
                    torch.cuda.synchronize()
                    row[key]["_".join(map(str, layout))] = \
                        None if out is None else _fwd_errors(out, ref)
            del got, again, ref
        print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()


def sweep_temporal_fwd(reps: int, parent: Optional[str]) -> None:
    import torch.nn.functional as F
    dev = resolve_device("cuda")
    cuda_lib.build(["conv_bn"])
    main = cuda_lib.library("conv_bn").m3f_conv_unit_fwd
    defines = {name: f"TW_ABLATE={k}" for name, k in TW_ABLATIONS.items()}
    built = build_variants(defines, "m3f_conv_unit_fwd")
    old = None
    if parent:
        old = build_variants({"parent": ""}, "m3f_conv_unit_fwd",
                             {"parent": parent}, PARENT_TW_ARGS)["parent"]
    g = torch.Generator(device=dev).manual_seed(15)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in TW_SHAPES:
        ci = xs[-1]
        x, w, inv, shift = tw_inputs(xs, co, dev, g)
        wk = _wk_t(w)
        a = (inv, shift)                 # every temporal unit has the prologue
        plan = conv_bn.temporal_fwd_plan(*xs, co, sms)
        row = {"kind": "temporal_fwd", "x": list(xs), "co": co,
               "plan": plan._asdict()}
        if old is not None:
            row["parent_ms"] = [timed(lambda: launch_parent_fwd(
                old, x, wk, *a, 1, (0, 0)), reps, queued=True)]
        entry = lambda: launch_temporal_fwd(main, x, wk, *a)
        fns = {"wrapper": lambda: conv_bn.conv_unit_fwd(
                   x, w, *a, kind="temporal"),
               "entry": entry, "entry_again": entry}
        for per in {_tw_per_one_wave(plan, sms), 1} - {plan.units_per_block}:
            fns[f"entry_per{per}"] = lambda per=per: launch_temporal_fwd(
                main, x, wk, *a, per=per)
        for layout in TW_LAYOUTS:
            try:
                lp = conv_bn.temporal_fwd_plan(*xs, co, sms, layout)
            except ValueError:
                continue
            for ch in (lp.chunks, 2 * lp.chunks):
                if launch_temporal_fwd(main, x, wk, *a, layout=layout,
                                       chunks=ch) is None:
                    continue
                fns["_".join(map(str, (*layout, "chunks", ch)))] = \
                    lambda layout=layout, ch=ch: launch_temporal_fwd(
                        main, x, wk, *a, layout=layout, chunks=ch)
        row["alternating_ms"] = alternating(fns, reps)
        row["ms"] = row["alternating_ms"]["wrapper"][0]
        row["entry_ms"] = row["alternating_ms"]["entry"][0]
        row["identical_launches_gap_ms"] = abs(
            row["entry_ms"] - row["alternating_ms"]["entry_again"][0])
        for name, fn in built.items():
            row[f"{name}_ms"] = timed(
                lambda: launch_temporal_fwd(fn, x, wk, *a), reps, queued=True)
        xh = conv_bn._prologue(x, *a).permute(0, 4, 1, 2, 3)
        kern, pad = conv_bn._torch_kernel(w.to(x.dtype), "temporal")
        kern = kern.contiguous(memory_format=torch.channels_last_3d)

        def sums():
            yf = F.conv3d(xh, kern, padding=pad).float()
            return yf.sum((0, 2, 3, 4)), (yf * yf).sum((0, 2, 3, 4))
        row["cudnn_conv_ms"] = timed(lambda: F.conv3d(xh, kern, padding=pad),
                                     reps, queued=True)
        row["cudnn_conv_sums_ms"] = timed(sums, reps, queued=True)
        bx = torch.empty_like(x)
        by = torch.empty(*xs[:-1], co, dtype=x.dtype, device=dev)
        sy = torch.zeros_like(by)
        row["copy_x_and_y_ms"] = timed(lambda: (bx.copy_(x), by.copy_(sy)),
                                       reps, queued=True)
        if old is not None:
            row["parent_ms"].append(timed(lambda: launch_parent_fwd(
                old, x, wk, *a, 1, (0, 0)), reps, queued=True))
        m = x.numel() // ci
        flops = 2 * conv_bn.tap_pairs("temporal", *xs[:4]) * ci * co
        nbytes = m * ci * 2 + m * co * 2 + 3 * ci * co * 2 + 2 * co * 4 \
            + 2 * ci * 4
        row["bound_ms"] = max(nbytes / HBM, flops / PEAK_BF16) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_BF16 \
            else "operations"
        row["tflops"] = flops / row["ms"] / 1e9
        row["TBps"] = nbytes / row["ms"] / 1e9
        print(json.dumps(row), flush=True)
        del x, xh, bx, by, sy
        torch.cuda.empty_cache()


# --- the fp32 forwards: the spatial row walk and the temporal frame walk -----

# ablation builds of conv_bn_f32.cu (-DSWF_ABLATE / -DTWF_ABLATE)
F32_ABLATIONS = {"no_forming": 1, "no_products": 2, "no_copies": 4,
                 "no_epilogue": 8, "walk_only": 15}
# small shapes (x shape, C_out) of the spatial walk: partial chunks, masked
# N tiles, steps across images (7x7 and 4x7 images, 135 images: ranges of
# 2), one-pixel images (8-channel chunks), C_out 1152 / 256 / 200, images
# too wide for the walk (the per-tap gather)
SWF_SMALL = (((3, 5, 7, 9, 24), 40), ((3, 45, 7, 7, 24), 40),
             ((2, 3, 4, 7, 40), 200), ((2, 16, 7, 7, 64), 1152),
             ((2, 4, 14, 14, 32), 256), ((3, 4, 1, 1, 16), 72),
             ((1, 2, 9, 9, 200), 152), ((1, 2, 2, 240, 16), 16))
# stage 1 of data.image_size=224 (112x112 images) at 32 clips: too wide for
# 16-channel chunks, so the plan takes 8-channel ones
SWF_WIDE = (((32, 16, 112, 112, 64), 144),)
# small shapes of the temporal walk: T 1 / 2 / 3 / 5, strips across clips
# (7x7 and 5x5 images), a partial chunk (C_in 40), masked N tiles (C_out
# 40, 200), several units a range (1568 positions: 13 or 25 strips), a
# resident filter (C_in 200)
TWF_SMALL = (((2, 1, 3, 5, 24), 40), ((3, 2, 7, 7, 16), 40),
             ((2, 3, 4, 7, 40), 200), ((2, 5, 6, 3, 40), 24),
             ((32, 2, 7, 7, 64), 512), ((1, 3, 9, 9, 200), 72))
# the gather's C entry in this source, and in older sources that took the
# kind (0 spatial, 1 temporal) before the batch
GATHER_F32_ENTRY = "m3f_conv_unit_fwd_f32"
PARENT_F32_SIGNATURE = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p]


def swf_inputs(xs, co, dev, g):
    ci = xs[-1]
    x = torch.randn(*xs, device=dev, generator=g)
    w = (torch.rand(3, 3, ci, co, device=dev, generator=g) * 2 - 1) / (9 * ci) ** 0.5
    inv = torch.rand(ci, device=dev, generator=g) + 0.5
    shift = torch.randn(ci, device=dev, generator=g) * 0.1
    return x, w, inv, shift


def launch_swf(fn, x, wk, inv, shift, layout=None):
    """One call of a build's ``m3f_spatial_fwd_f32`` with the planner's
    layout or ``layout`` = (N tile, K chunk) (what ``conv_unit_fwd`` does
    for fp32 x, minus its checks); ``inv`` None leaves the prologue out.
    None where the layout does not fit."""
    b, t, h, wd, ci = x.shape
    co = wk.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nb, kc = layout or (None, None)
    plan = conv_bn.f32_spatial_fwd_plan(b, t, h, wd, ci, co, sms, nb, kc)
    if plan is None:
        return None
    y = torch.empty(*x.shape[:-1], co, device=x.device)
    s1 = torch.empty(co, device=x.device)
    s2 = torch.empty_like(s1)
    part = torch.empty(2 * plan.part_rows * co, device=x.device)
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(x.data_ptr(), wk.data_ptr(), ptr(inv), ptr(shift), y.data_ptr(),
             s1.data_ptr(), s2.data_ptr(), part.data_ptr(), b, t, h, wd, ci,
             co, plan.n_tile, plan.k_chunk, plan.images_per_range,
             cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"fp32 spatial forward sweep, {layout}")
    return y, s1, s2


CUDA_ERROR_INVALID_VALUE = 1


def launch_twf(fn, x, wk, inv, shift, layout=None):
    """One call of a build's ``m3f_temporal_fwd_f32`` with the planner's
    layout or the filter resident (``layout`` True) or streamed (False)
    over the planner's ranges (what ``conv_unit_fwd`` does for fp32 x,
    minus its checks); ``inv`` None leaves the prologue out. None where the
    C entry refuses the layout (a resident filter that does not fit)."""
    b, t, h, wd, ci = x.shape
    co = wk.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_bn.f32_temporal_fwd_plan(b, t, h, wd, ci, co, sms)
    resident = plan.resident if layout is None else layout
    y = torch.empty(*x.shape[:-1], co, device=x.device)
    s1 = torch.empty(co, device=x.device)
    s2 = torch.empty_like(s1)
    part = torch.empty(2 * plan.part_rows * co, device=x.device)
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(x.data_ptr(), wk.data_ptr(), ptr(inv), ptr(shift), y.data_ptr(),
             s1.data_ptr(), s2.data_ptr(), part.data_ptr(), b, t, h, wd, ci,
             co, int(resident), plan.units_per_range, cuda_lib.stream_ptr(x))
    if err == CUDA_ERROR_INVALID_VALUE and layout is not None:
        return None
    cuda_lib.check(err, f"fp32 temporal forward sweep, resident={resident}")
    return y, s1, s2



def launch_gather_f32(fn, x, wk, inv, shift, kind=None):
    """One call of a ``m3f_conv_unit_fwd_f32`` (the per-tap gather,
    conv_f32_kernel) with ``f32_fwd_plan``'s tiling: this source's (spatial
    only, ``kind`` None) or an older source's, which takes ``kind`` (0
    spatial, 1 temporal; built with PARENT_F32_SIGNATURE)."""
    b, t, h, wd, ci = x.shape
    co = wk.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_bn.f32_fwd_plan(b, t, h, wd, co, sms)
    y = torch.empty(*x.shape[:-1], co, device=x.device)
    s1 = torch.empty(co, device=x.device)
    s2 = torch.empty_like(s1)
    part = torch.empty(2 * plan.ranges * co, device=x.device)
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(x.data_ptr(), wk.data_ptr(), ptr(inv), ptr(shift), y.data_ptr(),
             s1.data_ptr(), s2.data_ptr(), part.data_ptr(),
             *(() if kind is None else (kind,)), b, t, h, wd, ci, co,
             plan.tiles_per_range, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "fp32 gather forward")
    return y, s1, s2


class F32FwdKind(NamedTuple):
    """What the fp32 forward sweep does for one kind: the kernel's ``taps``
    (the filter's leading ``kernel`` shape), the C ``entry`` and its
    ``launch`` (layout None: the planner's), the ``plan`` function, the
    ``layouts`` the plan can take (name -> layout), the ablation ``knob``,
    the random ``seed``, the shapes of ``--check`` and of the sweep,
    whether this source's per-tap ``gather`` takes the kind, and the kind
    an older source's gather took (``parent_kind``)."""
    taps: int
    kernel: tuple
    entry: str
    launch: Callable
    plan: Callable
    layouts: Dict[str, object]
    knob: str
    seed: int
    check_shapes: tuple
    sweep_shapes: tuple
    gather: bool
    parent_kind: int


F32_FWD = {
    "spatial": F32FwdKind(
        9, (3, 3), "m3f_spatial_fwd_f32", launch_swf,
        conv_bn.f32_spatial_fwd_plan,
        {f"layout_{nb}x{kc}": (nb, kc) for nb in conv_bn._SWF_N_TILES
         for kc in conv_bn._SWF_K_CHUNKS},
        "SWF_ABLATE", 13, SWF_SMALL + FWD_SHAPES, FWD_SHAPES + SWF_WIDE,
        True, 0),
    "temporal": F32FwdKind(
        3, (3,), "m3f_temporal_fwd_f32", launch_twf,
        conv_bn.f32_temporal_fwd_plan,
        {"filter_resident": True, "filter_streamed": False},
        "TWF_ABLATE", 17, TWF_SMALL + TW_SHAPES, TW_SHAPES, False, 1)}


def _f32_fwd_inputs(spec: F32FwdKind, xs, co, dev, g):
    """x, the filter in the kind's shape, its [taps·C_in, C_out] matrix,
    inv and shift."""
    x, w, inv, shift = swf_inputs(xs, co, dev, g)
    ci = xs[-1]
    w = w.reshape(9, ci, co)[:spec.taps].reshape(*spec.kernel, ci, co)
    return x, w, w.reshape(spec.taps * ci, co), inv, shift


def check_fwd_f32(kind: str, parent: Optional[str] = None) -> None:
    """ptxas' resource lines of the kind's fp32 walk, then the walk against
    the plain version (TF32 off), with and without the prologue: the
    wrapper once at each small and serving shape (and whether a second call
    repeats y, s1 and s2 bit for bit), every layout of the kind that fits
    at each shape, and, for the spatial kind, the per-tap gather; with
    ``parent`` (a source with the same C entry) whether that source's walk
    gives the same y, s1 and s2 bit for bit at the planner's layout."""
    spec = F32_FWD[kind]
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resources(f"{kind}_fwd_f32")
    cuda_lib.build(["conv_bn_f32"])
    lib = cuda_lib.library("conv_bn_f32")
    main = getattr(lib, spec.entry)
    old = None
    if parent:
        old = build_variants({"parent_walk": ""}, spec.entry,
                             {"parent_walk": parent},
                             cuda_lib.SIGNATURES["conv_bn_f32"][spec.entry])[
                                 "parent_walk"]
    g = torch.Generator(device=dev).manual_seed(spec.seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in spec.check_shapes:
        x, w, wk, inv, shift = _f32_fwd_inputs(spec, xs, co, dev, g)
        plan = spec.plan(*xs, co, sms)
        row = {"x": list(xs), "co": co,
               "plan": None if plan is None else plan._asdict()}
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            got = conv_bn.conv_unit_fwd(x, w, *a, kind=kind)
            again = conv_bn.conv_unit_fwd(x, w, *a, kind=kind)
            torch.cuda.synchronize()
            ref = conv_bn.conv_unit_reference(x, w, *a, kind=kind)
            key = "affine" if affine else "plain"
            row[key] = {"max_err_over_max_ref": _fwd_errors(got, ref),
                        "repeats": all(torch.equal(p, q)
                                       for p, q in zip(got, again))}
            for name, layout in spec.layouts.items():
                out = spec.launch(main, x, wk, *a, layout=layout)
                torch.cuda.synchronize()
                row[key][name] = None if out is None else _fwd_errors(out, ref)
                del out
            if spec.gather:
                out = launch_gather_f32(getattr(lib, GATHER_F32_ENTRY), x,
                                        wk, *a)
                torch.cuda.synchronize()
                row[key]["gather"] = _fwd_errors(out, ref)
                del out
            if old is not None:
                out = spec.launch(old, x, wk, *a)
                torch.cuda.synchronize()
                row[key]["parent_bit_equal"] = None if out is None else all(
                    torch.equal(p, q) for p, q in zip(out, got))
                del out
            del got, again, ref
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()


def sweep_fwd_f32(kind: str, reps: int, parent: Optional[str]) -> None:
    """The kind's fp32 walk at its sweep shapes (spatial: the serving
    forward's four units, 128 clips, and SWF_WIDE; temporal: the four units
    of the serving forward and of the train step, 32 clips), with and
    without the prologue, every time a device time: in alternating rounds
    the wrapper, the planner's layout through the C entry twice (their gap
    is the spread of identical launches), every layout of the kind that
    fits, the spatial per-tap gather through this source's entry, with
    ``parent`` that source's gather of the kind, and cuDNN's fp32 conv
    plus the sums (TF32 off); then the ablation builds, cuDNN's conv alone
    and a device copy of x and y. The bound counts the operations the
    function needs (``conv_bn.tap_pairs``)."""
    import torch.nn.functional as F
    spec = F32_FWD[kind]
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.build(["conv_bn_f32"])
    lib = cuda_lib.library("conv_bn_f32")
    main = getattr(lib, spec.entry)
    src = str(cuda_lib.CSRC / "conv_bn_f32.cu")
    defines = {f"{kind}_f32_{name}": f"{spec.knob}={k}"
               for name, k in F32_ABLATIONS.items()}
    built = build_variants(defines, spec.entry, {name: src for name in defines},
                           cuda_lib.SIGNATURES["conv_bn_f32"][spec.entry])
    old = None
    if parent:
        old = build_variants({"parent_f32": ""}, GATHER_F32_ENTRY,
                             {"parent_f32": parent},
                             PARENT_F32_SIGNATURE)["parent_f32"]
    g = torch.Generator(device=dev).manual_seed(spec.seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in spec.sweep_shapes:
        ci = xs[-1]
        x, w, wk, inv, shift = _f32_fwd_inputs(spec, xs, co, dev, g)
        plan = spec.plan(*xs, co, sms)
        kern, pad = conv_bn._torch_kernel(w, kind)
        kern = kern.contiguous(memory_format=torch.channels_last_3d)
        m = x.numel() // ci
        flops = 2 * conv_bn.tap_pairs(kind, *xs[:4]) * ci * co
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            xh = conv_bn._prologue(x, *a).permute(0, 4, 1, 2, 3)

            def sums():
                yf = F.conv3d(xh, kern, padding=pad)
                return yf.sum((0, 2, 3, 4)), (yf * yf).sum((0, 2, 3, 4))
            entry = lambda: spec.launch(main, x, wk, *a)
            fns = {"wrapper": lambda: conv_bn.conv_unit_fwd(
                       x, w, *a, kind=kind),
                   "entry": entry, "entry_again": entry}
            for name, layout in spec.layouts.items():
                if spec.launch(main, x, wk, *a, layout=layout) is not None:
                    fns[name] = lambda layout=layout: spec.launch(
                        main, x, wk, *a, layout=layout)
            if spec.gather:
                fns["gather"] = lambda: launch_gather_f32(
                    getattr(lib, GATHER_F32_ENTRY), x, wk, *a)
            if old is not None:
                fns["parent"] = lambda: launch_gather_f32(old, x, wk, *a,
                                                          spec.parent_kind)
            fns["cudnn_conv_sums"] = sums
            row = {"kind": f"{kind}_fwd_f32", "x": list(xs), "co": co,
                   "affine": affine, "plan": plan._asdict(),
                   "alternating_ms": alternating(fns, reps)}
            row["ms"] = row["alternating_ms"]["wrapper"][0]
            row["identical_launches_gap_ms"] = abs(
                row["alternating_ms"]["entry"][0]
                - row["alternating_ms"]["entry_again"][0])
            for name, fn in built.items():
                row[f"{name[len(kind) + 5:]}_ms"] = timed(
                    lambda: spec.launch(fn, x, wk, *a), reps, queued=True)
            row["cudnn_conv_ms"] = timed(
                lambda: F.conv3d(xh, kern, padding=pad), reps, queued=True)
            bx = torch.empty_like(x)
            by = torch.empty(*xs[:-1], co, device=dev)
            sy = torch.zeros_like(by)
            row["copy_x_and_y_ms"] = timed(
                lambda: (bx.copy_(x), by.copy_(sy)), reps, queued=True)
            nbytes = 4 * (m * ci + m * co + spec.taps * ci * co + 2 * co
                          + (2 * ci if affine else 0))
            row["bound_ms"] = max(nbytes / HBM, flops / PEAK_FP32) * 1e3
            row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_FP32 \
                else "operations"
            row["tflops"] = flops / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            del xh, bx, by, sy
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()


# --- the fp32 spatial filter gradient: the row walk --------------------------

# small shapes (x shape, C_out) of the walk: a partial channel block (C_in
# 24), masked N tiles (C_out 40, 200), steps across images (7x7 images; 135
# images: slices of 2 with a one-image last slice on 132 SMs at C_in 24 ->
# 40), 1x1 images, C_out 1152, images too wide for the walk (the gather)
SFF_SMALL = (((3, 5, 7, 9, 24), 40), ((1, 131, 7, 7, 24), 40),
             ((2, 3, 4, 7, 40), 200), ((2, 16, 7, 7, 64), 1152),
             ((3, 4, 1, 1, 16), 72), ((1, 2, 2, 600, 16), 16))
# stage 1 of data.image_size=224 (112x112 images) at 32 clips
SFF_WIDE = (((32, 16, 112, 112, 64), 144),)
SFF_ABLATIONS = {"no_forming": 1, "no_products": 2, "no_copies": 4,
                 "no_epilogue": 8, "walk_only": 15, "copies_only": 3,
                 "products_only": 5, "forming_only": 6}
SFF_ENTRY = "m3f_spatial_filter_f32"
GATHER_FILTER_F32_ENTRY = "m3f_conv_unit_bwd_filter_f32"
# an older conv_bn_f32.cu's filter gather entry, which took the kind (git
# show 6f59ff2:m3f_torch/csrc/conv_bn_f32.cu, the last with the temporal
# kind)
PARENT_FILTER_F32_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p]


def sff_inputs(xs, co, dev, g):
    """fp32 x, inv, shift, y, gy, gs1, gs2 for one spatial unit."""
    ci = xs[-1]
    x = torch.randn(*xs, device=dev, generator=g)
    inv = torch.rand(ci, device=dev, generator=g) + 0.5
    shift = torch.randn(ci, device=dev, generator=g) * 0.1
    y = torch.randn(*xs[:-1], co, device=dev, generator=g)
    gy = torch.randn(*xs[:-1], co, device=dev, generator=g) * 1e-2
    gs1 = torch.randn(co, device=dev, generator=g) * 1e-5
    gs2 = torch.randn(co, device=dev, generator=g) * 1e-6
    return x, inv, shift, y, gy, gs1, gs2


def launch_sff(fn, x, inv, shift, y, gy, gs1, gs2, layout=None):
    """One call of a build's ``m3f_spatial_filter_f32`` with the planner's
    layout or ``layout`` = (N tile, step) (what ``conv_unit_bwd_filter``
    does for fp32 x, minus its checks); ``inv`` None leaves the prologue
    out. None where no such layout fits."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_bn.f32_spatial_filter_plan(b, t, h, wd, ci, co, sms,
                                           *(layout or ()))
    if plan is None:
        return None
    dw = torch.empty(9 * ci, co, device=x.device)
    part = torch.empty(plan.slices * 9 * ci * co, device=x.device) \
        if plan.slices > 1 else None
    ge = torch.empty(plan.ge_bytes // 4, device=x.device)
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(x.data_ptr(), gy.data_ptr(), y.data_ptr(), gs1.data_ptr(),
             gs2.data_ptr(), ptr(inv), ptr(shift), dw.data_ptr(), ptr(part),
             ge.data_ptr(), b, t, h, wd, ci, co, plan.n_tile, plan.step,
             plan.images_per_slice, plan.slices, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"fp32 spatial filter sweep, {layout}")
    return dw


def _parent_filter_tiling(b, t, h, wd, ci, co, taps, sms):
    """(chunks a slice, slices, K) of the per-tap filter gather's tiling
    (``f32_bwd_filter_plan``, which took the kind before the temporal frame
    walk: K = taps·C_in rows in tiles of 64)."""
    k = taps * ci
    tiles = -(-k // 64) * -(-co // 64)
    chunks = -(-(b * t * h * wd) // 16)
    want = max(1, min(chunks, -(-8 * sms // tiles),
                      conv_bn._FILTER_PART_BYTES // (4 * k * co)))
    per = max(1, -(-chunks // want))
    return per, max(1, -(-chunks // per)), k


def launch_filter_gather_f32(fn, x, inv, shift, y, gy, gs1, gs2, kind=None):
    """One call of a ``m3f_conv_unit_bwd_filter_f32`` (the per-tap gather,
    bwd_filter_f32_kernel) with its tiling: this source's (spatial only,
    ``kind`` None) or an older source's, which takes ``kind`` (0 spatial, 1
    temporal; built with PARENT_FILTER_F32_SIGNATURE)."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per, slices, k = _parent_filter_tiling(b, t, h, wd, ci, co,
                                           3 if kind == 1 else 9, sms)
    dw = torch.empty(k, co, device=x.device)
    part = torch.empty(slices * k * co, device=x.device) if slices > 1 else None
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(x.data_ptr(), gy.data_ptr(), y.data_ptr(), gs1.data_ptr(),
             gs2.data_ptr(), ptr(inv), ptr(shift), dw.data_ptr(), ptr(part),
             *(() if kind is None else (kind,)), b, t, h, wd, ci, co, per,
             slices, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "fp32 filter gather")
    return dw


def _dw_over_limit(got, ref, absw) -> float:
    """max |dw - ref| over the limit 1e-5 of sum |x^|*|ge| plus 1e-6 of that
    sum's largest (chip_smoke.py's dw limit)."""
    lim = 1e-5 * absw + 1e-6 * absw.max()
    return ((got.reshape(ref.shape) - ref).abs() / lim).max().item()


def _abs_dw(xh, ge):
    """sum over pixels of |x^| * |ge| per filter element [3, 3, C_in, C_out]."""
    ci, co = xh.shape[-1], ge.shape[-1]
    dk = torch.nn.grad.conv3d_weight(
        xh.abs().permute(0, 4, 1, 2, 3), (co, ci, 1, 3, 3),
        ge.abs().permute(0, 4, 1, 2, 3), padding=(0, 1, 1))
    return dk[:, :, 0].permute(2, 3, 1, 0)


SFF_LAYOUTS = {f"layout_{nb}x{st}": (nb, st) for nb in conv_bn._SFF_N_TILES
               for st in conv_bn._SFF_STEPS}


def check_filter_f32() -> None:
    """ptxas' resource lines of the walk, then the walk against the plain
    version (TF32 off), with and without the prologue, at SFF_SMALL, the
    train step's four spatial units (32 clips) and SFF_WIDE: the wrapper
    (and whether a second call repeats dw bit for bit), every layout that
    fits through the C entry, and the per-tap gather; each as max |dw -
    ref| over max |ref| and over chip_smoke.py's dw limit."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resources("spatial_filter_f32")
    cuda_lib.build(["conv_bn_f32"])
    lib = cuda_lib.library("conv_bn_f32")
    main, gather = getattr(lib, SFF_ENTRY), getattr(lib, GATHER_FILTER_F32_ENTRY)
    g = torch.Generator(device=dev).manual_seed(23)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in SFF_SMALL + SHAPES["spatial"] + SFF_WIDE:
        x, inv, shift, y, gy, gs1, gs2 = sff_inputs(xs, co, dev, g)
        plan = conv_bn.f32_spatial_filter_plan(*xs, co, sms)
        row = {"x": list(xs), "co": co,
               "plan": None if plan is None else plan._asdict()}
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            args = (x, *a, y, gy, gs1, gs2)
            got = conv_bn.conv_unit_bwd_filter(*args, kind="spatial")
            again = conv_bn.conv_unit_bwd_filter(*args, kind="spatial")
            torch.cuda.synchronize()
            ref = conv_bn.conv_unit_bwd_filter_reference(*args, kind="spatial")
            absw = _abs_dw(conv_bn._prologue(x, *a), conv_bn._gy_eff(gy, y, gs1, gs2))
            err = lambda d: {"over_max_ref": ((d.reshape(ref.shape) - ref).abs().max()
                                              / ref.abs().max()).item(),
                             "over_limit": _dw_over_limit(d, ref, absw)}
            key = "affine" if affine else "plain"
            row[key] = {"wrapper": err(got), "repeats": torch.equal(got, again)}
            for name, layout in SFF_LAYOUTS.items():
                out = launch_sff(main, *args, layout=layout)
                torch.cuda.synchronize()
                row[key][name] = None if out is None else err(out)
                del out
            out = launch_filter_gather_f32(gather, *args)
            torch.cuda.synchronize()
            row[key]["gather"] = err(out)
            del got, again, ref, absw, out
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        del x, y, gy
        torch.cuda.empty_cache()


def sweep_filter_f32(reps: int, parent: Optional[str]) -> None:
    """The walk at the train step's four spatial units (32 clips) and
    SFF_WIDE, with and without the prologue, every time a device time: in
    alternating rounds the wrapper, the planner's layout through the C entry
    twice (their gap is the spread of identical launches), every layout that
    fits, the per-tap gather through this source's entry and, with
    ``parent``, through that source's, and cuDNN's fp32
    ``conv3d_weight`` on x̂ and ge already formed (TF32 off); then the
    ablation builds (-DSFF_ABLATE) and a device copy of x, gy and y. The
    bound counts the operations the function needs
    (``conv_bn.tap_pairs``)."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.build(["conv_bn_f32"])
    lib = cuda_lib.library("conv_bn_f32")
    main, gather = getattr(lib, SFF_ENTRY), getattr(lib, GATHER_FILTER_F32_ENTRY)
    src = str(cuda_lib.CSRC / "conv_bn_f32.cu")
    sig = cuda_lib.SIGNATURES["conv_bn_f32"]
    defines = {f"sff_{name}": f"SFF_ABLATE={k}"
               for name, k in SFF_ABLATIONS.items()}
    built = build_variants(defines, SFF_ENTRY, {name: src for name in defines},
                           sig[SFF_ENTRY])
    old = None
    if parent:
        old = build_variants({"parent_f32": ""}, GATHER_FILTER_F32_ENTRY,
                             {"parent_f32": parent},
                             PARENT_FILTER_F32_SIGNATURE)["parent_f32"]
    g = torch.Generator(device=dev).manual_seed(23)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in SHAPES["spatial"] + SFF_WIDE:
        ci = xs[-1]
        x, inv, shift, y, gy, gs1, gs2 = sff_inputs(xs, co, dev, g)
        plan = conv_bn.f32_spatial_filter_plan(*xs, co, sms)
        m = x.numel() // ci
        flops = 2 * conv_bn.tap_pairs("spatial", *xs[:4]) * ci * co
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            args = (x, *a, y, gy, gs1, gs2)
            xn = conv_bn._prologue(x, *a).permute(0, 4, 1, 2, 3)
            gn = conv_bn._gy_eff(gy, y, gs1, gs2).permute(0, 4, 1, 2, 3)
            entry = lambda: launch_sff(main, *args)
            fns = {"wrapper": lambda: conv_bn.conv_unit_bwd_filter(
                       *args, kind="spatial"),
                   "entry": entry, "entry_again": entry}
            for name, layout in SFF_LAYOUTS.items():
                if launch_sff(main, *args, layout=layout) is not None:
                    fns[name] = lambda layout=layout: launch_sff(
                        main, *args, layout=layout)
            fns["gather"] = lambda: launch_filter_gather_f32(gather, *args)
            if old is not None:
                fns["parent"] = lambda: launch_filter_gather_f32(old, *args,
                                                                 kind=0)
            fns["cudnn_conv3d_weight"] = lambda: torch.nn.grad.conv3d_weight(
                xn, (co, ci, 1, 3, 3), gn, padding=(0, 1, 1))
            row = {"kind": "spatial_filter_f32", "x": list(xs), "co": co,
                   "affine": affine, "plan": plan._asdict(),
                   "alternating_ms": alternating(fns, reps)}
            row["ms"] = row["alternating_ms"]["wrapper"][0]
            row["identical_launches_gap_ms"] = abs(
                row["alternating_ms"]["entry"][0]
                - row["alternating_ms"]["entry_again"][0])
            for name, fn in built.items():
                row[f"{name[4:]}_ms"] = timed(
                    lambda: launch_sff(fn, *args), reps, queued=True)
            bx, by, bg = torch.empty_like(x), torch.empty_like(y), torch.empty_like(gy)
            row["copy_x_gy_y_ms"] = timed(
                lambda: (bx.copy_(x), by.copy_(y), bg.copy_(gy)), reps,
                queued=True)
            nbytes = 4 * (m * ci + 2 * m * co + 9 * ci * co + 2 * co
                          + (2 * ci if affine else 0))
            row["bound_ms"] = max(nbytes / HBM, flops / PEAK_FP32) * 1e3
            row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_FP32 \
                else "operations"
            row["tflops"] = {k: flops / v[0] / 1e9
                             for k, v in row["alternating_ms"].items()}
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            del xn, gn, bx, by, bg
            torch.cuda.empty_cache()
        del x, y, gy
        torch.cuda.empty_cache()


# --- the fp32 spatial data gradient: the row walk ----------------------------

# small shapes (x shape, C_out) of the walk: C_out 40 (chunks of 16, 16 and
# 8), 129 7x7 images four a range with a one-image last range at C_in 200
# (four N tiles of 64, the last masked), C_out 200 at C_in 40 (a masked
# tile of 64), 1x1 images several a step (N tiles of 128, 8-channel chunks,
# K split), C_out 1152 at 7x7 images, images too wide for the walk (the
# gather)
SDF_SMALL = (((3, 5, 7, 9, 24), 40), ((1, 129, 7, 7, 200), 40),
             ((2, 3, 4, 7, 40), 200), ((3, 100, 1, 1, 16), 72),
             ((2, 16, 7, 7, 64), 1152), ((1, 2, 2, 600, 16), 16))
SDF_ABLATIONS = {"no_forming": 1, "no_products": 2, "no_copies": 4,
                 "no_epilogue": 8, "walk_only": 15}
SDF_ENTRY = "m3f_spatial_data_f32"
GATHER_DATA_F32_ENTRY = "m3f_conv_unit_bwd_data_f32"
# an older conv_bn_f32.cu's gather entry, which took the kind (git show
# 20c000c:m3f_torch/csrc/conv_bn_f32.cu, the last with the temporal kind)
PARENT_DATA_F32_SIGNATURE = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p]
# every layout the plan can take (N tile, K chunk), each with the plan's
# split for it, and the plan's layout with its K whole
SDF_LAYOUTS = {**{f"layout_{nb}x{kc}": (nb, kc, None)
                  for nb in conv_bn._SDF_N_TILES for kc in conv_bn._SDF_K_CHUNKS},
               "one_split": (None, None, 1)}


def sdf_inputs(xs, co, dev, g):
    """fp32 x, w [3, 3, C_in, C_out], inv, shift, y, gy, gs1, gs2."""
    x, inv, shift, y, gy, gs1, gs2 = sff_inputs(xs, co, dev, g)
    ci = xs[-1]
    w = (torch.rand(3, 3, ci, co, device=dev, generator=g) * 2 - 1) / (9 * ci) ** 0.5
    return x, w, inv, shift, y, gy, gs1, gs2


def launch_sdf(fn, x, w, inv, shift, y, gy, gs1, gs2, layout=None):
    """One call of a build's ``m3f_spatial_data_f32`` with the planner's
    layout or ``layout`` = (N tile, K chunk, K splits; None: the plan's)
    (what ``conv_unit_bwd_data`` does for fp32 x, minus its checks); ``inv``
    None leaves the prologue out. None where no such layout fits."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nb, kc, splits = layout or (None, None, None)
    if layout is not None and nb is None:       # the plan's layout, asked splits
        p = conv_bn.f32_spatial_data_plan(b, t, h, wd, ci, co, sms)
        if p is None:
            return None
        nb, kc = p.n_tile, p.k_chunk
    plan = conv_bn.f32_spatial_data_plan(b, t, h, wd, ci, co, sms, nb, kc,
                                         splits)
    if plan is None:
        return None
    wt = conv_bn.f32_bwd_data_filter(w, "spatial").contiguous()
    dx = torch.empty_like(x)
    affine = inv is not None
    dinv = torch.empty(ci, device=x.device) if affine else None
    dshift = torch.empty(ci, device=x.device) if affine else None
    part = torch.empty(2 * plan.part_rows * ci, device=x.device) if affine else None
    dxpart = torch.empty(plan.part_bytes // 4, device=x.device) \
        if plan.k_splits > 1 else None
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(gy.data_ptr(), y.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
             wt.data_ptr(), x.data_ptr() if affine else None, ptr(inv),
             ptr(shift), dx.data_ptr(), ptr(dinv), ptr(dshift), ptr(part),
             ptr(dxpart), b, t, h, wd, ci, co, plan.n_tile, plan.k_chunk,
             plan.images_per_range, plan.k_splits, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"fp32 spatial data sweep, {layout}")
    return dx, dinv, dshift


def launch_data_gather_f32(fn, x, w, inv, shift, y, gy, gs1, gs2,
                           kind=None):
    """One call of a ``m3f_conv_unit_bwd_data_f32`` (the per-tap gather,
    bwd_data_f32_kernel) with ``f32_bwd_data_plan``'s tiling: this source's
    (spatial only, ``kind`` None) or an older source's, which takes ``kind``
    (0 spatial, 1 temporal; built with PARENT_DATA_F32_SIGNATURE). The
    filter's rank says the kind."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_bn.f32_bwd_data_plan(b, t, h, wd, ci, sms)
    wt = conv_bn.f32_bwd_data_filter(
        w, "spatial" if w.dim() == 4 else "temporal").contiguous()
    dx = torch.empty_like(x)
    affine = inv is not None
    dinv = torch.empty(ci, device=x.device) if affine else None
    dshift = torch.empty(ci, device=x.device) if affine else None
    part = torch.empty(2 * plan.ranges * ci, device=x.device) if affine else None
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(gy.data_ptr(), y.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
             wt.data_ptr(), x.data_ptr() if affine else None, ptr(inv),
             ptr(shift), dx.data_ptr(), ptr(dinv), ptr(dshift), ptr(part),
             *(() if kind is None else (kind,)), b, t, h, wd, ci, co,
             plan.tiles_per_range, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "fp32 data gather")
    return dx, dinv, dshift


def _data_f32_errors(x, w, inv, shift, y, gy, gs1, gs2, kind="spatial"):
    """A function of a (dx, dinv, dshift) giving max |dx - ref| over
    chip_smoke.py's fp32 dx limit (1e-5 of |ge| (*) |w| mirrored, through
    the mask and |inv|, plus 1e-30) and the largest relative error of dinv
    and dshift."""
    ref = conv_bn.conv_unit_bwd_data_reference(x, w, inv, shift, y, gy, gs1,
                                               gs2, kind=kind)
    kern, pad = conv_bn._torch_kernel(w.abs(), kind)
    ge = conv_bn._gy_eff(gy, y, gs1, gs2).abs().permute(0, 4, 1, 2, 3)
    lim = F.conv3d(ge, kern.flip(2, 3, 4).transpose(0, 1), padding=pad
                   ).permute(0, 2, 3, 4, 1)
    if inv is not None:
        lim = lim * ((x * inv + shift) > 0) * inv.abs()
    lim = lim * 1e-5 + 1e-30

    def errors(got):
        out = {"dx_over_limit": ((got[0] - ref[0]).abs() / lim).max().item()}
        if inv is not None:
            for k, name in ((1, "dinv"), (2, "dshift")):
                out[f"{name}_rel"] = ((got[k] - ref[k]).abs().max()
                                      / ref[k].abs().max()).item()
        return out
    return errors


def check_data_f32() -> None:
    """ptxas' resource lines of the walk and its split sum, then the walk
    against the plain version (TF32 off), with and without the prologue, at
    SDF_SMALL, the train step's four spatial units (32 clips) and SFF_WIDE:
    the wrapper (and whether a second call repeats dx, dinv and dshift bit
    for bit), every layout that fits through the C entry (the plan's split
    for it, and the plan's layout with one split), and the per-tap
    gather."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resources("spatial_data_f32")
    cuda_lib.build(["conv_bn_f32"])
    lib = cuda_lib.library("conv_bn_f32")
    main, gather = getattr(lib, SDF_ENTRY), getattr(lib, GATHER_DATA_F32_ENTRY)
    g = torch.Generator(device=dev).manual_seed(29)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in SDF_SMALL + SHAPES["spatial"] + SFF_WIDE:
        x, w, inv, shift, y, gy, gs1, gs2 = sdf_inputs(xs, co, dev, g)
        plan = conv_bn.f32_spatial_data_plan(*xs, co, sms)
        row = {"x": list(xs), "co": co,
               "plan": None if plan is None else plan._asdict()}
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            args = (x, w, *a, y, gy, gs1, gs2)
            got = conv_bn.conv_unit_bwd_data(*args, kind="spatial")
            again = conv_bn.conv_unit_bwd_data(*args, kind="spatial")
            torch.cuda.synchronize()
            err = _data_f32_errors(*args)
            key = "affine" if affine else "plain"
            row[key] = {"wrapper": err(got),
                        "repeats": all(p is None or torch.equal(p, q)
                                       for p, q in zip(got, again))}
            for name, layout in SDF_LAYOUTS.items():
                out = launch_sdf(main, *args, layout=layout)
                torch.cuda.synchronize()
                row[key][name] = None if out is None else err(out)
                del out
            out = launch_data_gather_f32(gather, *args)
            torch.cuda.synchronize()
            row[key]["gather"] = err(out)
            del got, again, out, err
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        del x, y, gy
        torch.cuda.empty_cache()


def sweep_data_f32(reps: int, parent: Optional[str]) -> None:
    """The walk at the train step's four spatial units (32 clips) and
    SFF_WIDE, with and without the prologue, every time a device time: in
    alternating rounds the wrapper, the planner's layout through the C entry
    twice (their gap is the spread of identical launches), every layout that
    fits (SDF_LAYOUTS), the per-tap gather through this source's entry and,
    with ``parent``, through that source's, and cuDNN's fp32
    ``conv3d_input`` on ge already formed (TF32 off); then the ablation
    builds (-DSDF_ABLATE) and a device copy of gy, y and x. The bound counts
    the operations the function needs (``conv_bn.tap_pairs``)."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.build(["conv_bn_f32"])
    lib = cuda_lib.library("conv_bn_f32")
    main, gather = getattr(lib, SDF_ENTRY), getattr(lib, GATHER_DATA_F32_ENTRY)
    src = str(cuda_lib.CSRC / "conv_bn_f32.cu")
    sig = cuda_lib.SIGNATURES["conv_bn_f32"]
    defines = {f"sdf_{name}": f"SDF_ABLATE={k}"
               for name, k in SDF_ABLATIONS.items()}
    built = build_variants(defines, SDF_ENTRY, {name: src for name in defines},
                           sig[SDF_ENTRY])
    old = None
    if parent:
        old = build_variants({"parent_f32": ""}, GATHER_DATA_F32_ENTRY,
                             {"parent_f32": parent},
                             PARENT_DATA_F32_SIGNATURE)["parent_f32"]
    g = torch.Generator(device=dev).manual_seed(29)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in SHAPES["spatial"] + SFF_WIDE:
        ci = xs[-1]
        x, w, inv, shift, y, gy, gs1, gs2 = sdf_inputs(xs, co, dev, g)
        plan = conv_bn.f32_spatial_data_plan(*xs, co, sms)
        m = x.numel() // ci
        flops = 2 * conv_bn.tap_pairs("spatial", *xs[:4]) * ci * co
        kern, pad = conv_bn._torch_kernel(w, "spatial")
        kern = kern.contiguous(memory_format=torch.channels_last_3d)
        xshape = (xs[0], ci) + tuple(xs[1:4])
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            args = (x, w, *a, y, gy, gs1, gs2)
            gn = conv_bn._gy_eff(gy, y, gs1, gs2).permute(0, 4, 1, 2, 3)
            entry = lambda: launch_sdf(main, *args)
            fns = {"wrapper": lambda: conv_bn.conv_unit_bwd_data(
                       *args, kind="spatial"),
                   "entry": entry, "entry_again": entry}
            for name, layout in SDF_LAYOUTS.items():
                if launch_sdf(main, *args, layout=layout) is not None:
                    fns[name] = lambda layout=layout: launch_sdf(
                        main, *args, layout=layout)
            fns["gather"] = lambda: launch_data_gather_f32(gather, *args)
            if old is not None:
                fns["parent"] = lambda: launch_data_gather_f32(old, *args,
                                                               kind=0)
            fns["cudnn_conv3d_input"] = lambda: torch.nn.grad.conv3d_input(
                xshape, kern, gn, padding=pad)
            row = {"kind": "spatial_data_f32", "x": list(xs), "co": co,
                   "affine": affine, "plan": plan._asdict(),
                   "alternating_ms": alternating(fns, reps)}
            row["ms"] = row["alternating_ms"]["wrapper"][0]
            row["identical_launches_gap_ms"] = abs(
                row["alternating_ms"]["entry"][0]
                - row["alternating_ms"]["entry_again"][0])
            for name, fn in built.items():
                row[f"{name[4:]}_ms"] = timed(
                    lambda: launch_sdf(fn, *args), reps, queued=True)
            bx, by, bg = torch.empty_like(x), torch.empty_like(y), torch.empty_like(gy)
            row["copy_gy_y_x_ms"] = timed(
                lambda: (bx.copy_(x), by.copy_(y), bg.copy_(gy)), reps,
                queued=True)
            nbytes = 4 * (2 * m * co + 9 * ci * co + m * ci + 2 * co
                          + (m * ci + 2 * ci if affine else 0))
            row["bound_ms"] = max(nbytes / HBM, flops / PEAK_FP32) * 1e3
            row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_FP32 \
                else "operations"
            row["tflops"] = {k: flops / v[0] / 1e9
                             for k, v in row["alternating_ms"].items()}
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            del gn, bx, by, bg
            torch.cuda.empty_cache()
        del x, y, gy
        torch.cuda.empty_cache()


# --- the fp32 temporal data gradient: the frame walk -------------------------

# small shapes (x shape, C_out) of the walk: clips of one frame at C_out 40
# (chunks of 16, 16 and 8); five 7x7 clips across strips, the last strip
# partial, at C_in 200 (a masked N tile in every layout); 1x1 clips several
# a strip; 10x10 clips at C_in 152; the stage-4 width at two clips (the
# filter streamed)
TDF_SMALL = (((3, 1, 7, 7, 24), 40), ((5, 3, 7, 7, 200), 40),
             ((3, 2, 1, 1, 16), 72), ((2, 3, 10, 10, 152), 40),
             ((2, 2, 7, 7, 1152), 512))
TDF_ABLATIONS = {"no_forming": 1, "no_products": 2, "no_copies": 4,
                 "no_epilogue": 8, "walk_only": 15, "x_from_global": 16}
TDF_ENTRY = "m3f_temporal_data_f32"
# every N tile the plan can take, and the plan's with the filter resident
# and streamed: (N tile, resident); None the plan's
TDF_LAYOUTS = {**{f"layout_{nb}": (nb, None) for nb in conv_bn._TDF_N_TILES},
               "resident": (None, True), "streamed": (None, False)}


def tdf_inputs(xs, co, dev, g):
    """fp32 x, w [3, C_in, C_out], inv, shift, y, gy, gs1, gs2."""
    x, inv, shift, y, gy, gs1, gs2 = sff_inputs(xs, co, dev, g)
    ci = xs[-1]
    w = (torch.rand(3, ci, co, device=dev, generator=g) * 2 - 1) / (3 * ci) ** 0.5
    return x, w, inv, shift, y, gy, gs1, gs2


def launch_tdf(fn, x, w, inv, shift, y, gy, gs1, gs2, layout=None):
    """One call of a build's ``m3f_temporal_data_f32`` with the planner's
    layout or ``layout`` = (N tile, filter resident; None: the plan's),
    the filter's layout forced through the C entry's ``resident`` argument
    (what ``conv_unit_bwd_data`` does for fp32 x, minus its checks); ``inv``
    None leaves the prologue out. None where the C entry refuses the layout
    (a resident filter that does not fit)."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nb, asked = layout or (None, None)
    plan = conv_bn.f32_temporal_data_plan(b, t, h, wd, ci, co, sms,
                                          inv is not None, nb)
    resident = plan.resident if asked is None else asked
    wt = conv_bn.f32_bwd_data_filter(w, "temporal").contiguous()
    dx = torch.empty_like(x)
    affine = inv is not None
    dinv = torch.empty(ci, device=x.device) if affine else None
    dshift = torch.empty(ci, device=x.device) if affine else None
    part = torch.empty(2 * plan.part_rows * ci, device=x.device) if affine else None
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(gy.data_ptr(), y.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
             wt.data_ptr(), x.data_ptr() if affine else None, ptr(inv),
             ptr(shift), dx.data_ptr(), ptr(dinv), ptr(dshift), ptr(part),
             b, t, h, wd, ci, co, plan.n_tile, int(resident),
             plan.units_per_range, cuda_lib.stream_ptr(x))
    if err == CUDA_ERROR_INVALID_VALUE and layout is not None:
        return None
    cuda_lib.check(err, f"fp32 temporal data sweep, {layout}")
    return dx, dinv, dshift


def check_temporal_data_f32(parent: Optional[str]) -> None:
    """ptxas' resource lines of the walk, then the walk against the plain
    version (TF32 off), with and without the prologue, at TDF_SMALL and the
    train step's four temporal units (32 clips): the wrapper (and whether a
    second call repeats dx, dinv and dshift bit for bit), every layout that
    fits through the C entry (TDF_LAYOUTS) and, with ``parent``, an older
    source's per-tap gather."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resources("temporal_data_f32")
    cuda_lib.build(["conv_bn_f32"])
    main = getattr(cuda_lib.library("conv_bn_f32"), TDF_ENTRY)
    old = None
    if parent:
        old = build_variants({"parent_f32": ""}, GATHER_DATA_F32_ENTRY,
                             {"parent_f32": parent},
                             PARENT_DATA_F32_SIGNATURE)["parent_f32"]
    g = torch.Generator(device=dev).manual_seed(31)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in TDF_SMALL + SHAPES["temporal"]:
        x, w, inv, shift, y, gy, gs1, gs2 = tdf_inputs(xs, co, dev, g)
        row = {"x": list(xs), "co": co,
               "plan": conv_bn.f32_temporal_data_plan(*xs, co, sms)._asdict()}
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            args = (x, w, *a, y, gy, gs1, gs2)
            got = conv_bn.conv_unit_bwd_data(*args, kind="temporal")
            again = conv_bn.conv_unit_bwd_data(*args, kind="temporal")
            torch.cuda.synchronize()
            err = _data_f32_errors(*args, kind="temporal")
            key = "affine" if affine else "plain"
            row[key] = {"wrapper": err(got),
                        "repeats": all(p is None or torch.equal(p, q)
                                       for p, q in zip(got, again))}
            for name, layout in TDF_LAYOUTS.items():
                out = launch_tdf(main, *args, layout=layout)
                torch.cuda.synchronize()
                row[key][name] = None if out is None else err(out)
                del out
            if old is not None:
                out = launch_data_gather_f32(old, *args, kind=1)
                torch.cuda.synchronize()
                row[key]["parent"] = err(out)
                del out
            del got, again, err
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        del x, y, gy
        torch.cuda.empty_cache()


def sweep_temporal_data_f32(reps: int, parent: Optional[str]) -> None:
    """The walk at the train step's four temporal units (32 clips, with the
    prologue, as the train step runs them), every time a device time: in
    alternating rounds the wrapper, the planner's layout through the C entry
    twice (their gap is the spread of identical launches), every layout
    that fits (TDF_LAYOUTS), with ``parent`` an older source's per-tap
    gather, and cuDNN's fp32 ``conv3d_input`` on ge already formed (TF32
    off); then the ablation builds (-DTDF_ABLATE) and a device copy of gy,
    y and x. The bound counts the operations the function needs
    (``conv_bn.tap_pairs``)."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.build(["conv_bn_f32"])
    main = getattr(cuda_lib.library("conv_bn_f32"), TDF_ENTRY)
    src = str(cuda_lib.CSRC / "conv_bn_f32.cu")
    sig = cuda_lib.SIGNATURES["conv_bn_f32"]
    defines = {f"tdf_{name}": f"TDF_ABLATE={k}"
               for name, k in TDF_ABLATIONS.items()}
    built = build_variants(defines, TDF_ENTRY, {name: src for name in defines},
                           sig[TDF_ENTRY])
    old = None
    if parent:
        old = build_variants({"parent_f32": ""}, GATHER_DATA_F32_ENTRY,
                             {"parent_f32": parent},
                             PARENT_DATA_F32_SIGNATURE)["parent_f32"]
    g = torch.Generator(device=dev).manual_seed(31)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in SHAPES["temporal"]:
        ci = xs[-1]
        x, w, inv, shift, y, gy, gs1, gs2 = tdf_inputs(xs, co, dev, g)
        plan = conv_bn.f32_temporal_data_plan(*xs, co, sms)
        m = x.numel() // ci
        flops = 2 * conv_bn.tap_pairs("temporal", *xs[:4]) * ci * co
        kern, pad = conv_bn._torch_kernel(w, "temporal")
        kern = kern.contiguous(memory_format=torch.channels_last_3d)
        xshape = (xs[0], ci) + tuple(xs[1:4])
        args = (x, w, inv, shift, y, gy, gs1, gs2)
        gn = conv_bn._gy_eff(gy, y, gs1, gs2).permute(0, 4, 1, 2, 3)
        entry = lambda: launch_tdf(main, *args)
        fns = {"wrapper": lambda: conv_bn.conv_unit_bwd_data(
                   *args, kind="temporal"),
               "entry": entry, "entry_again": entry}
        for name, layout in TDF_LAYOUTS.items():
            if launch_tdf(main, *args, layout=layout) is not None:
                fns[name] = lambda layout=layout: launch_tdf(
                    main, *args, layout=layout)
        if old is not None:
            fns["parent"] = lambda: launch_data_gather_f32(old, *args, kind=1)
        fns["cudnn_conv3d_input"] = lambda: torch.nn.grad.conv3d_input(
            xshape, kern, gn, padding=pad)
        row = {"kind": "temporal_data_f32", "x": list(xs), "co": co,
               "affine": True, "plan": plan._asdict(),
               "alternating_ms": alternating(fns, reps)}
        row["ms"] = row["alternating_ms"]["wrapper"][0]
        row["identical_launches_gap_ms"] = abs(
            row["alternating_ms"]["entry"][0]
            - row["alternating_ms"]["entry_again"][0])
        for name, fn in built.items():
            row[f"{name[4:]}_ms"] = timed(
                lambda: launch_tdf(fn, *args), reps, queued=True)
        bx, by, bg = torch.empty_like(x), torch.empty_like(y), torch.empty_like(gy)
        row["copy_gy_y_x_ms"] = timed(
            lambda: (bx.copy_(x), by.copy_(y), bg.copy_(gy)), reps,
            queued=True)
        nbytes = 4 * (2 * m * co + 3 * ci * co + 2 * m * ci + 2 * co + 2 * ci)
        row["bound_ms"] = max(nbytes / HBM, flops / PEAK_FP32) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_FP32 \
            else "operations"
        row["tflops"] = {k: flops / v[0] / 1e9
                         for k, v in row["alternating_ms"].items()}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        del gn, bx, by, bg, x, y, gy
        torch.cuda.empty_cache()


# --- the fp32 temporal filter gradient: the frame walk -----------------------

# small shapes (x shape, C_out) of the walk: clips of one frame across a
# strip; 7x7 clips across strips, the last strip partial, at C_in 200 (a
# partial channel block in every layout) and C_out 40 (a masked N tile);
# 1x1 clips several a strip; 10x10 clips at C_in 152 and C_out 128 (two N
# tiles); the stage-4 width at two clips
TFF_SMALL = (((3, 1, 7, 7, 24), 40), ((6, 2, 7, 7, 200), 40),
             ((3, 2, 1, 1, 16), 72), ((3, 5, 10, 10, 152), 128),
             ((2, 2, 7, 7, 1152), 512))
TFF_ABLATIONS = {"no_forming": 1, "no_products": 2, "no_copies": 4,
                 "no_epilogue": 8, "walk_only": 15, "sums_in_order": 64,
                 "no_copies_sums_in_order": 68}
TFF_ENTRY = "m3f_temporal_filter_f32"
# every layout the plan can take: (channel block, strip)
TFF_LAYOUTS = {f"layout_{cb}x{st}": (cb, st) for cb, st in conv_bn._TFF_LAYOUTS}


def launch_tff(fn, x, inv, shift, y, gy, gs1, gs2, layout=None, per=None):
    """One call of a build's ``m3f_temporal_filter_f32`` with the planner's
    layout or ``layout`` = (channel block, strip) (what
    ``conv_unit_bwd_filter`` does for fp32 x, minus its checks), in the
    plan's slices or in slices of ``per`` strips; ``inv`` None leaves the
    prologue out."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_bn.f32_temporal_filter_plan(b, t, h, wd, ci, co, sms, layout)
    if per:
        plan = plan._replace(units_per_slice=per,
                             slices=-(-plan.units // per))
    dw = torch.empty(3 * ci, co, device=x.device)
    part = torch.empty(plan.slices * 3 * ci * co, device=x.device) \
        if plan.slices > 1 else None
    ptr = lambda v: None if v is None else v.data_ptr()
    err = fn(x.data_ptr(), gy.data_ptr(), y.data_ptr(), gs1.data_ptr(),
             gs2.data_ptr(), ptr(inv), ptr(shift), dw.data_ptr(), ptr(part),
             b, t, h, wd, ci, co, plan.ci_blk, plan.strip,
             plan.units_per_slice, plan.slices, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"fp32 temporal filter sweep, {layout}")
    return dw


def _tff_pers(plan) -> list:
    """Strips a slice to time beside the plan's: slice counts from 1 to 8
    and 1/4 to 2 times the plan's that give at least a block a SM (132), as
    distinct strips a slice."""
    counts = set(range(1, 9)) | {max(1, round(plan.slices * f))
                                 for f in (0.25, 0.5, 0.75, 1.5, 2)}
    tiles = plan.ci_blocks * plan.n_tiles
    pers = {-(-plan.units // n) for n in counts
            if n <= plan.units and n * tiles >= 132}
    return sorted(pers - {plan.units_per_slice}, reverse=True)


def _abs_dw_temporal(xh, ge):
    """sum over positions of |x^| * |ge| per filter element [3, C_in, C_out]."""
    ci, co = xh.shape[-1], ge.shape[-1]
    dk = torch.nn.grad.conv3d_weight(
        xh.abs().permute(0, 4, 1, 2, 3), (co, ci, 3, 1, 1),
        ge.abs().permute(0, 4, 1, 2, 3), padding=(1, 0, 0))
    return dk[:, :, :, 0, 0].permute(2, 1, 0)


def check_temporal_filter_f32(parent: Optional[str]) -> None:
    """ptxas' resource lines of the walk, then the walk against the plain
    version (TF32 off), with and without the prologue, at TFF_SMALL and the
    train step's four temporal units (32 clips): the wrapper (and whether a
    second call repeats dw bit for bit), every layout through the C entry
    (TFF_LAYOUTS) and, with ``parent``, an older source's per-tap gather;
    each as max |dw - ref| over max |ref| and over chip_smoke.py's dw
    limit."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resources("temporal_filter_f32")
    lib = cuda_lib.build(["conv_bn_f32"])["conv_bn_f32"]
    for kernel, counts in ffma_bank_conflicts(
            lib, "temporal_filter_f32_kernel").items():
        print(json.dumps({"kernel": kernel, "sass": counts}), flush=True)
    main = getattr(cuda_lib.library("conv_bn_f32"), TFF_ENTRY)
    old = None
    if parent:
        old = build_variants({"parent_f32": ""}, GATHER_FILTER_F32_ENTRY,
                             {"parent_f32": parent},
                             PARENT_FILTER_F32_SIGNATURE)["parent_f32"]
    g = torch.Generator(device=dev).manual_seed(37)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in TFF_SMALL + SHAPES["temporal"]:
        x, inv, shift, y, gy, gs1, gs2 = sff_inputs(xs, co, dev, g)
        row = {"x": list(xs), "co": co,
               "plan": conv_bn.f32_temporal_filter_plan(*xs, co, sms)._asdict()}
        for affine in (True, False):
            a = (inv, shift) if affine else (None, None)
            args = (x, *a, y, gy, gs1, gs2)
            got = conv_bn.conv_unit_bwd_filter(*args, kind="temporal")
            again = conv_bn.conv_unit_bwd_filter(*args, kind="temporal")
            torch.cuda.synchronize()
            ref = conv_bn.conv_unit_bwd_filter_reference(*args, kind="temporal")
            absw = _abs_dw_temporal(conv_bn._prologue(x, *a),
                                    conv_bn._gy_eff(gy, y, gs1, gs2))
            err = lambda d: {"over_max_ref": ((d.reshape(ref.shape) - ref).abs().max()
                                              / ref.abs().max()).item(),
                             "over_limit": _dw_over_limit(d, ref, absw)}
            key = "affine" if affine else "plain"
            row[key] = {"wrapper": err(got), "repeats": torch.equal(got, again)}
            for name, layout in TFF_LAYOUTS.items():
                out = launch_tff(main, *args, layout=layout)
                torch.cuda.synchronize()
                row[key][name] = err(out)
                del out
            if old is not None:
                out = launch_filter_gather_f32(old, *args, kind=1)
                torch.cuda.synchronize()
                row[key]["parent"] = err(out)
                del out
            del got, again, ref, absw
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        del x, y, gy
        torch.cuda.empty_cache()


def sweep_temporal_filter_f32(reps: int, parent: Optional[str]) -> None:
    """The walk at the train step's four temporal units (32 clips, with the
    prologue, as the train step runs them), every time a device time: in
    alternating rounds the wrapper, the planner's layout through the C entry
    twice (their gap is the spread of identical launches), every layout
    (TFF_LAYOUTS), the planner's layout in the slice counts of
    ``_tff_pers``, with ``parent`` an older source's per-tap gather, and
    cuDNN's fp32 ``conv3d_weight`` on x̂ and ge already formed (TF32 off);
    then the ablation builds (-DTFF_ABLATE) and a device copy of x, gy and
    y. The bound counts the operations the function needs
    (``conv_bn.tap_pairs``)."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.build(["conv_bn_f32"])
    main = getattr(cuda_lib.library("conv_bn_f32"), TFF_ENTRY)
    src = str(cuda_lib.CSRC / "conv_bn_f32.cu")
    sig = cuda_lib.SIGNATURES["conv_bn_f32"]
    defines = {f"tff_{name}": f"TFF_ABLATE={k}"
               for name, k in TFF_ABLATIONS.items()}
    built = build_variants(defines, TFF_ENTRY, {name: src for name in defines},
                           sig[TFF_ENTRY])
    old = None
    if parent:
        old = build_variants({"parent_f32": ""}, GATHER_FILTER_F32_ENTRY,
                             {"parent_f32": parent},
                             PARENT_FILTER_F32_SIGNATURE)["parent_f32"]
    g = torch.Generator(device=dev).manual_seed(37)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, co in SHAPES["temporal"]:
        ci = xs[-1]
        x, inv, shift, y, gy, gs1, gs2 = sff_inputs(xs, co, dev, g)
        plan = conv_bn.f32_temporal_filter_plan(*xs, co, sms)
        m = x.numel() // ci
        flops = 2 * conv_bn.tap_pairs("temporal", *xs[:4]) * ci * co
        args = (x, inv, shift, y, gy, gs1, gs2)
        xn = conv_bn._prologue(x, inv, shift).permute(0, 4, 1, 2, 3)
        gn = conv_bn._gy_eff(gy, y, gs1, gs2).permute(0, 4, 1, 2, 3)
        entry = lambda: launch_tff(main, *args)
        fns = {"wrapper": lambda: conv_bn.conv_unit_bwd_filter(
                   *args, kind="temporal"),
               "entry": entry, "entry_again": entry}
        for name, layout in TFF_LAYOUTS.items():
            fns[name] = lambda layout=layout: launch_tff(main, *args,
                                                         layout=layout)
        for per in _tff_pers(plan):
            fns[f"slices_{-(-plan.units // per)}"] = \
                lambda per=per: launch_tff(main, *args, per=per)
        if old is not None:
            fns["parent"] = lambda: launch_filter_gather_f32(old, *args, kind=1)
        fns["cudnn_conv3d_weight"] = lambda: torch.nn.grad.conv3d_weight(
            xn, (co, ci, 3, 1, 1), gn, padding=(1, 0, 0))
        row = {"kind": "temporal_filter_f32", "x": list(xs), "co": co,
               "affine": True, "plan": plan._asdict(),
               "alternating_ms": alternating(fns, reps)}
        row["ms"] = row["alternating_ms"]["wrapper"][0]
        row["identical_launches_gap_ms"] = abs(
            row["alternating_ms"]["entry"][0]
            - row["alternating_ms"]["entry_again"][0])
        for name, fn in built.items():
            row[f"{name[4:]}_ms"] = timed(lambda: launch_tff(fn, *args), reps,
                                          queued=True)
        bx, by, bg = torch.empty_like(x), torch.empty_like(y), torch.empty_like(gy)
        row["copy_x_gy_y_ms"] = timed(
            lambda: (bx.copy_(x), by.copy_(y), bg.copy_(gy)), reps,
            queued=True)
        nbytes = 4 * (m * ci + 2 * m * co + 3 * ci * co + 2 * co + 2 * ci)
        row["bound_ms"] = max(nbytes / HBM, flops / PEAK_FP32) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_FP32 \
            else "operations"
        row["tflops"] = {k: flops / v[0] / 1e9
                         for k, v in row["alternating_ms"].items()}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        del xn, gn, bx, by, bg, x, y, gy
        torch.cuda.empty_cache()


# --- the log-mel frontend ---------------------------------------------------

def sweep_mel(reps: int, check_only: bool) -> None:
    """The mel kernel at the serving path's shapes (128 rows of 7995
    samples at the static hop, 128 of 10005 at a per-row hop of 640) with
    n_fft 1024 and n_fft = win_length = 400, and at the static rows with
    the other radices (320, 480, 448 radix 7, 998 one stage of 499, 401
    odd, 4096, and with the FFT buffers and tables in device memory 20001
    odd and the largest n_fft its plan takes, on 8 rows of n_fft samples),
    against the plain version; ptxas' resource lines; unless
    ``check_only``, the serving-shape calls and ``torch.stft`` + the mel
    matmul (the static rows) timed in turn as device time (each call
    queued behind a spin), 5 rounds of ``reps``, and the plain version."""
    import dataclasses
    from m3f_torch.config import MelConfig
    from m3f_torch.ops import melspec
    dev = resolve_device("cuda")
    resources("mel")
    cfg = MelConfig()
    cfg400 = dataclasses.replace(cfg, n_fft=400, win_length=400)
    g = torch.Generator(device=dev).manual_seed(14)
    wav = torch.randn(128, 7995, device=dev, generator=g) * 0.3
    wav_d = torch.randn(128, 10005, device=dev, generator=g) * 0.3
    hops = torch.full((128,), 640, dtype=torch.int32, device=dev)
    bf = torch.bfloat16

    def pair(c, w, **kw):
        return (lambda: melspec.log_mel_spectrogram(w, c, bf, **kw),
                lambda: melspec.log_mel_spectrogram_reference(w, c, bf, **kw))
    dyn = {"hop": hops, "n_frames_out": 16}
    calls = {"static": pair(cfg, wav), "dynamic_hop": pair(cfg, wav_d, **dyn),
             "n_fft_400": pair(cfg400, wav),
             "n_fft_400_dynamic_hop": pair(cfg400, wav_d, **dyn)}
    for n in (320, 480, 448, 998, 401, 4096, 20001, melspec.largest_n_fft()):
        c = dataclasses.replace(cfg, n_fft=n, win_length=n)
        # 8 rows past n_fft 8192 (FFT buffers in device memory), whose plain
        # version's frames would take gigabytes
        w = wav if n < 7995 else torch.randn(128 if n <= 8192 else 8, n,
                                             device=dev, generator=g)
        calls[f"n_fft_{n}"] = pair(c, w)

    def library(c):
        win = torch.hann_window(c.win_length, periodic=True, device=dev)
        fb = torch.from_numpy(melspec.mel_filterbank(c)).to(dev)

        def call():
            spec = torch.stft(wav, c.n_fft, c.hop_length, window=win,
                              center=True, pad_mode="reflect",
                              return_complex=True)
            power = spec.real ** 2 + spec.imag ** 2
            return torch.log(power.transpose(1, 2) @ fb + c.log_eps).to(bf)
        return call
    libs = {"static": library(cfg), "n_fft_400": library(cfg400)}
    timed_rows = ("static", "dynamic_hop", "n_fft_400", "n_fft_400_dynamic_hop")
    for name, (kern, plain) in calls.items():
        before = cuda_lib.launches["melspec"]
        err = (kern().float() - plain().float()).abs().max().item()
        row = {"kind": "mel", "rows": name,
               "launches": cuda_lib.launches["melspec"] - before,
               "max_abs_err_bf16": err, "repeats": torch.equal(kern(), kern())}
        if not check_only and name in timed_rows:
            rounds = {"ms": [], "library_ms": []}
            for _ in range(5):
                rounds["ms"].append(timed(kern, reps, queued=True))
                if name in libs:
                    rounds["library_ms"].append(timed(libs[name], reps,
                                                      queued=True))
            row.update({k: statistics.median(v) for k, v in rounds.items() if v})
            row["spread_ms"] = max(rounds["ms"]) - min(rounds["ms"])
            row["plain_ms"] = timed(plain, reps, queued=True)
        print(json.dumps(row), flush=True)


# --- the GRU recurrence ----------------------------------------------------

# (B, T, H, D): the serving path's recurrence (16 sequences of 128 steps)
# and the train step's (8 of 64, the fp32 carries kept)
GRU_SHAPES = {"serve": (16, 128, 256, 2), "train": (8, 64, 256, 2)}
# off the tiling: a batch tile half full and H not a multiple of 32, a second
# tile of one row, one block of 8 units, one direction, a cluster of 16
GRU_SMALL = ((5, 9, 72, 2), (5, 9, 72, 1), (17, 3, 64, 2), (17, 3, 64, 1),
             (1, 2, 8, 2), (1, 2, 8, 1), (4, 6, 512, 2))
# (x dtype, W dtype): the "xla" backend's bf16 W, the "pallas" backend's
# fp32 W, and fp32 throughout
GRU_DTYPES = {"bf16": (torch.bfloat16, torch.bfloat16),
              "fp32_w": (torch.bfloat16, torch.float32),
              "fp32": (torch.float32, torch.float32)}
GRU_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}   # as chip_smoke.py
GRU_ABLATIONS = {"no_products": 1, "no_exchange": 2, "walk_only": 5,
                 "block_barrier": 8, "no_out_stores": 16, "no_xp_copies": 32}


def gru_cuts(plan) -> Dict[str, tuple]:
    """(cluster, units, ksplit) of each layout the sweep holds or times: the
    planner's cluster with K in 1, 2 and 4 parts, and clusters of 16 blocks
    of 16 units (K in 1 and 2 parts)."""
    cuts = {f"ksplit{k}": (plan.cluster, plan.units, k) for k in (1, 2, 4)}
    cuts.update({f"cluster16_ksplit{k}": (16, 16, k) for k in (1, 2)})
    return cuts


def gru_inputs(shape, dtypes, dev, g):
    b, t, h, d = shape
    xp = torch.randn(b, t, d, 3 * h, device=dev, generator=g).to(dtypes[0])
    w = (torch.randn(d, h, 3 * h, device=dev, generator=g) / h ** 0.5
         ).to(dtypes[1])
    bias = torch.randn(d, 3 * h, device=dev, generator=g) * 0.1
    return xp, w, bias


# the C signature of an older source's stream entry ``m3f_gru_fwd`` (no
# carried state)
PARENT_GRU_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


def launch_gru(fn, xp, w, bias, cut=None, carries=False, cluster=True,
               parent=False):
    """One call of a build's ``m3f_gru_cluster_fwd`` with the planner's cut
    or ``cut`` = (cluster, units, ksplit) in its place, or (``cluster``
    False) of a stream entry point (``m3f_gru_stream_fwd``, or with
    ``parent`` an earlier source's ``m3f_gru_fwd``, which takes no carried
    state). None when the entry point refuses the cut."""
    b, t, d, h3 = xp.shape
    h = h3 // 3
    out = torch.empty(b, t, d, h, dtype=xp.dtype, device=xp.device)
    hs = torch.empty(b, t, d, h, dtype=torch.float32, device=xp.device) \
        if carries else None
    state = () if parent else (None, None)      # h0, final carry
    args = (xp.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if hs is None else hs.data_ptr(), *state, b, t, h, d,
            int(xp.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16))
    if cluster:
        plan = gru.gru_plan(b, t, h, d, w.dtype == torch.bfloat16)
        err = fn(*args, *(cut or (plan.cluster, plan.units, plan.ksplit)),
                 cuda_lib.stream_ptr(xp))
        if err == 1 and cut:
            return None                  # cudaErrorInvalidValue: no such cut
    else:
        err = fn(*args, cuda_lib.stream_ptr(xp))
    cuda_lib.check(err, f"gru sweep, cut {cut}")
    return out


def check_gru() -> None:
    """ptxas' resource lines, then the recurrence against the plain version
    (``gru_scan_reference``) at the small shapes, the serving shape and the
    train shape (with the fp32 carries), for each dtype pair: through the
    wrapper on the planner's route (and whether a second call repeats the
    output bit for bit), forced onto the stream route, and, where the
    cluster route fits, at every layout of ``gru_cuts`` the entry point
    takes."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    resources("gru")
    cuda_lib.build(["gru"])
    entry = cuda_lib.library("gru").m3f_gru_cluster_fwd
    g = torch.Generator(device=dev).manual_seed(16)
    shapes = [(s, None) for s in GRU_SMALL] + list(
        (s, k) for k, s in GRU_SHAPES.items())
    for shape, name in shapes:
        for dname, dtypes in GRU_DTYPES.items():
            xp, w, bias = gru_inputs(shape, dtypes, dev, g)
            carries = name == "train"
            plan = gru.gru_plan(shape[0], shape[1], shape[2], shape[3],
                                dtypes[1] == torch.bfloat16)
            tol = GRU_TOL[dtypes[0]]
            ref = gru.gru_scan_reference(xp, w, bias, carries)
            before = dict(cuda_lib.launches)
            got = gru._gru_forward(xp, w, bias, carries)
            again = gru._gru_forward(xp, w, bias, carries)
            route = [k for k in ("gru", "gru_stream")
                     if cuda_lib.launches[k] > before[k]]
            stream = gru._gru_forward(xp, w, bias, carries, route="stream")
            torch.cuda.synchronize()
            err = lambda a, r: (a.float() - r.float()).abs().max().item()
            if carries:
                row_err = {"out": err(got[0], ref[0]), "hs": err(got[1], ref[1]),
                           "stream_out": err(stream[0], ref[0]),
                           "stream_hs": err(stream[1], ref[1])}
                repeats = all(torch.equal(a, b) for a, b in zip(got, again))
            else:
                row_err = {"out": err(got, ref), "stream_out": err(stream, ref)}
                repeats = torch.equal(got, again)
            for cname, cut in (gru_cuts(plan).items() if plan.fits else ()):
                got_cut = launch_gru(entry, xp, w, bias, cut=cut)
                torch.cuda.synchronize()
                if got_cut is not None:
                    row_err[cname + "_out"] = err(
                        got_cut, ref[0] if carries else ref)
            print(json.dumps({
                "kind": "gru", "shape": list(shape), "dtypes": dname,
                "route": route, "plan": plan._asdict(), "max_abs_err": row_err,
                "tol": tol, "within": all(v is None or v <= tol
                                          for v in row_err.values()),
                "repeats": repeats}), flush=True)
            del xp, w, bias, ref, got, again, stream
        torch.cuda.empty_cache()


def sweep_gru(reps: int, parent: Optional[str]) -> None:
    """At the serving and train shapes, bf16 and fp32 W (x in bf16), every
    time a device time: in alternating rounds the wrapper (the planner's
    route, the train shape with carries), the cluster entry twice (the gap
    between the two is the spread of identical launches), the stream route,
    every layout of ``gru_cuts``, ``--parent``'s ``m3f_gru_fwd`` and,
    with bf16 W, ``nn.GRU`` (bf16, input 768, its projection included) and
    the port's layer (``x @ W_ih + b_ih`` then the kernel) on the same
    input; then the ablation builds (``-DGRU_ABLATE``): without the
    products (1), without the exchange (2: each block reads its own h only),
    the walk alone (5: exchange and cluster barrier, the chain's floor), a
    block barrier in place of the cluster barrier (8), without the output
    stores (16) and without the xp copies (32); their outputs are wrong,
    they are timed only. Per-step µs = ms / T."""
    dev = resolve_device("cuda")
    cuda_lib.build(["gru"])
    entry = cuda_lib.library("gru").m3f_gru_cluster_fwd
    src = str(cuda_lib.CSRC / "gru.cu")
    built = build_variants(
        {f"gru_{n}": f"GRU_ABLATE={k}" for n, k in GRU_ABLATIONS.items()},
        "m3f_gru_cluster_fwd", {f"gru_{n}": src for n in GRU_ABLATIONS},
        cuda_lib.SIGNATURES["gru"]["m3f_gru_cluster_fwd"])
    old = None
    if parent:
        old = build_variants({"gru_parent": ""}, "m3f_gru_fwd",
                             {"gru_parent": parent}, PARENT_GRU_SIGNATURE
                             )["gru_parent"]
    g = torch.Generator(device=dev).manual_seed(17)
    for name, shape in GRU_SHAPES.items():
        b, t, h, d = shape
        carries = name == "train"
        for dname in ("bf16", "fp32_w"):
            dtypes = GRU_DTYPES[dname]
            xp, w, bias = gru_inputs(shape, dtypes, dev, g)
            plan = gru.gru_plan(b, t, h, d, dtypes[1] == torch.bfloat16)
            run = lambda fn=entry, **kw: launch_gru(fn, xp, w, bias,
                                                    carries=carries, **kw)
            fns = {"wrapper": lambda: gru._gru_forward(xp, w, bias, carries),
                   "entry": run, "entry_again": run,
                   "stream": lambda: gru._gru_forward(xp, w, bias, carries,
                                                      route="stream")}
            for cname, cut in gru_cuts(plan).items():
                if run(cut=cut) is not None:
                    fns[cname] = lambda cut=cut: run(cut=cut)
            if old is not None:
                fns["parent"] = lambda: run(old, cluster=False, parent=True)
            if dname == "bf16":
                ref = torch.nn.GRU(768, h, batch_first=True,
                                   bidirectional=d == 2).to(dev, dtypes[0])
                ref.flatten_parameters()
                x_in = torch.randn(b, t, 768, device=dev, generator=g
                                   ).to(dtypes[0])
                w_ih = (torch.randn(768, d * 3 * h, device=dev, generator=g)
                        / 768 ** 0.5).to(dtypes[0])
                b_ih = torch.zeros(d * 3 * h, device=dev, dtype=dtypes[0])

                def nn_gru():
                    with torch.no_grad():
                        return ref(x_in)

                def layer():
                    return gru._gru_forward(
                        (x_in @ w_ih + b_ih).reshape(b, t, d, 3 * h), w, bias,
                        carries)
                fns.update({"nn_gru": nn_gru, "layer": layer})
            row = {"kind": "gru", "shape": name, "x": [b, t, h, d],
                   "dtypes": dname, "carries": carries,
                   "plan": plan._asdict()}
            row["alternating_ms"] = alternating(fns, reps)
            row["ms"] = row["alternating_ms"]["wrapper"][0]
            row["entry_ms"] = row["alternating_ms"]["entry"][0]
            row["identical_launches_gap_ms"] = abs(
                row["entry_ms"] - row["alternating_ms"]["entry_again"][0])
            for aname, fn in built.items():
                row[f"{aname[4:]}_ms"] = timed(lambda: run(fn), reps,
                                               queued=True)
            row["per_step_us"] = {
                k: row[k + "_ms"] * 1e3 / t
                for k in ("entry", *GRU_ABLATIONS)}
            row["chain_floor_ms"] = row["walk_only_ms"]
            wb = 2 if dtypes[1] == torch.bfloat16 else 4
            nbytes = (xp.numel() * xp.element_size() + w.numel() * wb
                      + bias.numel() * 4 + b * t * d * h * xp.element_size()
                      + (b * t * d * h * 4 if carries else 0))
            flops = 2 * d * t * b * h * 3 * h
            peak = PEAK_BF16 if wb == 2 else PEAK_FP32
            row["bound_ms"] = max(nbytes / HBM, flops / peak) * 1e3
            row["bound_by"] = "bytes" if nbytes / HBM >= flops / peak \
                else "operations"
            print(json.dumps(row), flush=True)
            del xp, w, bias
            torch.cuda.empty_cache()

# The packed-layout conv (rows 9 and 12): the probe's full shape, COUT 144
# and 128, and COUT 152 / 192 (one pass of N 192 on 64 positions, the
# planner's, against two of N 128 on 128); off the tiling (chip_smoke.py's shapes): CIN 16 / COUT 24 (one N
# pass of 32, 8 rows masked), CIN 24 / COUT 152 (boxes past CIN read zeros,
# W streamed), COUT 264 (two N passes) over 140 units (a partial last wave);
# small: CIN 8, W 10 (lane tail), CIN 136 (three boxes of channels a tap),
# COUT 200 (two passes of N 128: a pass of 256 fits no ring)
PK_SHAPES = {"cout144": packed_conv.ProbeShape(),
             "cout128": packed_conv.ProbeShape(COUT=128),
             "cout152": packed_conv.ProbeShape(COUT=152),
             "cout192": packed_conv.ProbeShape(COUT=192)}
PK_SMALL = (packed_conv.ProbeShape(B=1, T=2, H=10, W=10, CIN=8, COUT=16, CHUNK=128),
            packed_conv.ProbeShape(B=2, T=3, H=20, W=20, CIN=16, COUT=24, CHUNK=128),
            packed_conv.ProbeShape(B=1, T=2, H=12, W=12, CIN=24, COUT=152, CHUNK=256),
            packed_conv.ProbeShape(B=5, T=7, H=20, W=20, CIN=32, COUT=264, CHUNK=128),
            packed_conv.ProbeShape(B=1, T=3, H=9, W=7, CIN=136, COUT=40, CHUNK=128),
            packed_conv.ProbeShape(B=3, T=2, H=9, W=15, CIN=48, COUT=200, CHUNK=128))
PK_ABLATIONS = {"no_products": 1, "no_mask": 2, "no_y_stores": 4,
                "one_x_slab": 8}
PK_TOL_REL = 1e-5        # fp32 y: 1e-5 of |W_cm|@|P| plus 1e-6; bf16 y one
PK_TOL_ABS = 1e-6        # bf16 ulp on top (as chip_smoke.py)
# the first design's C entry (an earlier packed_conv.cu, --parent)
PK_PARENT_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def pk_inputs(shape, dev, g):
    """x_cm random everywhere (margins and tail read as given), w_cm /
    sqrt(K), bf16."""
    x = torch.randn(shape.BT, shape.CIN, shape.HWM, device=dev, generator=g
                    ).to(torch.bfloat16)
    w = (torch.randn(shape.COUT, shape.K, device=dev, generator=g)
         / shape.K ** 0.5).to(torch.bfloat16)
    return x, w


def pk_within(got, x, w, shape) -> Dict[str, float]:
    """max |y - plain| and its ratio to the limit (fp32 y: 1e-5 of
    |W_cm|@|P| + 1e-6; bf16 y: one bf16 ulp of the fp32 value on top)."""
    ref = packed_conv.packed_conv_reference(x, w, shape, out_f32=True)
    lim = PK_TOL_REL * torch.matmul(w.float().abs(), packed_conv.im2col(
        x, shape).float().abs()) + PK_TOL_ABS
    if got.dtype == torch.bfloat16:
        a = ref.abs().clamp_min(2.0 ** -126)
        lim = lim + torch.exp2(torch.floor(torch.log2(a)) - 7)
        ref = ref.to(torch.bfloat16).float()
    d = (got.float() - ref).abs()
    return {"max_abs_err": d.max().item(), "err_over_limit": (d / lim).max().item()}


def pk_resources() -> None:
    """What ptxas says of every build of packed_conv.cu (this source and
    each -DPK_ABLATE timing build): registers, spills, shared memory of
    each kernel, and its warnings (a wgmma pipeline it serialised)."""
    src = str(cuda_lib.CSRC / "packed_conv.cu")
    builds = {"kernel": [], **{n: [f"-DPK_ABLATE={k}"] for n, k in PK_ABLATIONS.items()}}
    procs = {n: subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", *d, "-o",
         "/dev/null", src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for n, d in builds.items()}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {n}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "packed" in line:
                name = line.split("'")[1]
                print(json.dumps({"build": n, "kernel": name[name.index("packed"):][:48],
                                  "ptxas": [l.strip() for l in lines[i + 1:i + 4]]}),
                      flush=True)
            elif "Performance Loss" in line:
                print(json.dumps({"build": n, "ptxas_warning": line.strip()[:160],
                                  "kernel": line.split("'")[-2][-48:]}), flush=True)


def check_packed() -> None:
    """ptxas' lines of every build, then the conv walk against the plain
    version at the small, edge and full shapes, for bf16 y, fp32 y and the
    chunked walk, at the planner's layout through the wrapper (and whether a
    second call repeats y bit for bit) and at every layout of LAYOUTS the
    shape fits; then a view at an odd offset, which must raise."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    pk_resources()
    cuda_lib.build(["packed_conv"])
    entry = cuda_lib.library("packed_conv").m3f_packed_conv_tma
    g = torch.Generator(device=dev).manual_seed(21)
    for shape in PK_SMALL + tuple(PK_SHAPES.values()):
        x, w = pk_inputs(shape, dev, g)
        for mode in packed_conv.CONV_MODES:
            if mode == "packed_conv_chunked":
                call = lambda: packed_conv.packed_conv_chunked(x, w, shape)
            else:
                f32 = mode == "packed_conv_f32"
                call = lambda f32=f32: packed_conv.packed_conv(x, w, shape, f32)
            got, again = call(), call()
            torch.cuda.synchronize()
            plan = packed_conv.packed_plan(shape, mode)
            row = {"kind": "packed", "shape": str(shape), "mode": mode,
                   "plan": {"bn": plan.bn, "np": plan.np, "stages": plan.stages,
                            "smem": plan.smem, "grid": plan.grid},
                   "wrapper": pk_within(got, x, w, shape),
                   "repeats": torch.equal(got, again)}
            name = "packed_conv_chunked" if mode == "packed_conv_chunked" else "packed_conv"
            for bn in packed_conv.LAYOUTS:
                lp = packed_conv.packed_plan(shape, mode, bn=bn)
                if lp.fits:
                    y = packed_conv.call_tma(entry, name, shape, x, w, lp)
                    torch.cuda.synchronize()
                    row[f"bn{bn}"] = pk_within(y, x, w, shape)
            row["within"] = all(v["err_over_limit"] <= 1.0 for v in row.values()
                                if isinstance(v, dict) and "err_over_limit" in v)
            print(json.dumps(row), flush=True)
            del got, again
        del x, w
        torch.cuda.empty_cache()
    print(json.dumps({"kind": "packed", "odd_offset_view_within": odd_offset(
        PK_SMALL[1], dev, g, ("packed_conv", "packed_conv_chunked"))}), flush=True)


def odd_offset(shape, dev, g, names) -> Dict[str, dict]:
    """Each of ``names`` on an input one element off 16 bytes (x_cm, or
    p_const for ablate_matmul) against its plain version on the same
    values; the control, y from the storage's aligned start (the inputs
    shifted by one element), must fall outside the same check."""
    x, w = pk_inputs(shape, dev, g)
    p = torch.randn(shape.K, shape.HWP, device=dev, generator=g).to(torch.bfloat16)
    out = {}
    for name in names:
        a = p if name == "ablate_matmul" else x
        flat = torch.empty(a.numel() + 1, device=dev, dtype=torch.bfloat16)
        odd = flat[1:].view(a.shape)
        odd.copy_(a)
        fn = getattr(packed_conv, name)
        got, shifted = fn(odd, w, shape), fn(flat[:-1].view(a.shape), w, shape)
        out[name] = {"base_mod_16": odd.data_ptr() % 16,
                     "within": pa_within(name, got, odd, w, shape),
                     "control_within": pa_within(name, shifted, odd, w, shape)}
    return out


def pa_within(name: str, got, a, w, shape) -> bool:
    """y of kernel ``name`` within its limit of the plain version on ``a``,
    ``w``: the ablate_slabs copy bit for bit, ablate_matmul one bf16 ulp
    of the fp32 product plus PK_TOL_REL of |W_cm|@|p_const| and PK_TOL_ABS,
    the conv ``pk_within``'s limit."""
    if name == "ablate_slabs":
        return torch.equal(got.view(torch.int16), packed_conv.ablate_slabs_reference(
            a, w, shape).view(torch.int16))
    if name == "ablate_matmul":
        ref = torch.matmul(w.float(), a.float())
        lim = PK_TOL_REL * torch.matmul(w.float().abs(), a.float().abs()) \
            + PK_TOL_ABS + torch.exp2(torch.floor(torch.log2(
                ref.abs().clamp_min(2.0 ** -126))) - 7)
        return bool(((got.float() - ref).abs() <= lim).all())
    return pk_within(got, a, w, shape)["err_over_limit"] <= 1.0


def sweep_packed(reps: int, parent: Optional[str]) -> None:
    """At the probe's full shape (COUT 144, 128, 152 and 192), every time
    a device time (``timed`` queued behind a spin): in alternating rounds
    the wrapper's rows 9 (bf16 y), 12, 10 and 11, both layouts through the
    C entry (128 positions a tile and 64, with the fewest N passes each
    fits), row 9 with fp32 y, ``--parent``'s rows 9, 12, 10 and 11 (the
    first design), ``F.conv2d``
    channels-last, ``torch.matmul`` at the GEMM shape (channels-major,
    ``[COUT, K] x [K, HWP]`` per image, as row 11's library call, and
    positions-major ``[BT*HWP, K] x [K, COUT]``), and a device copy of x
    and y; then the timing builds ``-DPK_ABLATE=``: 1 no products (TMA, mask
    and stores: the byte floor), 2 no mask pass, 4 no y stores, 8 one x slab
    for all nine taps (the cost of the nine L2 reads of x), at both
    layouts. Their outputs are wrong; they are timed only."""
    dev = resolve_device("cuda")
    cuda_lib.build(["packed_conv"])
    entry = cuda_lib.library("packed_conv").m3f_packed_conv_tma
    src = str(cuda_lib.CSRC / "packed_conv.cu")
    built = build_variants(
        {f"pk_{n}": f"PK_ABLATE={k}" for n, k in PK_ABLATIONS.items()},
        "m3f_packed_conv_tma", {f"pk_{n}": src for n in PK_ABLATIONS},
        cuda_lib.SIGNATURES["packed_conv"]["m3f_packed_conv_tma"])
    old = None
    if parent:
        old = build_variants({"pk_parent": ""}, "m3f_packed_conv",
                             {"pk_parent": parent}, PK_PARENT_SIG)["pk_parent"]
    g = torch.Generator(device=dev).manual_seed(22)
    for name, shape in PK_SHAPES.items():
        x, w = pk_inputs(shape, dev, g)
        layouts = {f"bn{bn}": packed_conv.packed_plan(shape, "packed_conv", bn=bn)
                   for bn in packed_conv.LAYOUTS}
        layouts = {k: v for k, v in layouts.items() if v.fits}
        p = torch.randn(shape.K, shape.HWP, device=dev, generator=g
                        ).to(torch.bfloat16)
        fns = {"row9": lambda: packed_conv.packed_conv(x, w, shape),
               "row12": lambda: packed_conv.packed_conv_chunked(x, w, shape),
               "row9_f32": lambda: packed_conv.packed_conv(x, w, shape, True),
               "row10": lambda: packed_conv.ablate_slabs(x, w, shape),
               "row11": lambda: packed_conv.ablate_matmul(p, w, shape)}
        for lname, lp in layouts.items():
            fns[lname] = lambda lp=lp: packed_conv.call_tma(
                entry, "packed_conv", shape, x, w, lp)
            lc = packed_conv.packed_plan(shape, "packed_conv_chunked", bn=lp.bn)
            fns[lname + "_chunked"] = lambda lc=lc: packed_conv.call_tma(
                entry, "packed_conv_chunked", shape, x, w, lc)
        if old is not None:
            def parent_call(mode, a):
                y = torch.empty(shape.BT, shape.COUT, shape.HWP, device=dev,
                                dtype=torch.bfloat16)
                cuda_lib.check(old(a.data_ptr(), w.data_ptr(), y.data_ptr(), mode,
                                   shape.BT, shape.CIN, shape.COUT, shape.W,
                                   shape.HWP, shape.MARGIN,
                                   shape.CHUNK if mode == 4 else 0,
                                   cuda_lib.stream_ptr(x)), "parent packed conv")
                return y
            fns["parent_row9"] = lambda: parent_call(0, x)
            fns["parent_row12"] = lambda: parent_call(4, x)
            fns["parent_row10"] = lambda: parent_call(2, x)
            fns["parent_row11"] = lambda: parent_call(3, p)
        hw = shape.MARGIN, shape.MARGIN + shape.HW
        x_nd = x[:, :, hw[0]:hw[1]].reshape(shape.BT, shape.CIN, shape.H, shape.W) \
            .contiguous(memory_format=torch.channels_last)
        w_nd = w.reshape(shape.COUT, 3, 3, shape.CIN).permute(0, 3, 1, 2) \
            .contiguous(memory_format=torch.channels_last)
        p_bt = p.expand(shape.BT, -1, -1)
        p_pm = torch.randn(shape.BT * shape.HWP, shape.K, device=dev, generator=g
                           ).to(torch.bfloat16)
        y = torch.empty(shape.BT, shape.COUT, shape.HWP, device=dev,
                        dtype=torch.bfloat16)
        xc, yc = torch.empty_like(x), torch.empty_like(y)
        fns.update({
            "conv2d": lambda: F.conv2d(x_nd, w_nd, padding=1),
            "matmul_cm": lambda: torch.matmul(w, p_bt),
            "matmul_pm": lambda: torch.matmul(p_pm, w.t()),
            "copy_x_y": lambda: (xc.copy_(x), yc.copy_(y))})
        row = {"kind": "packed", "shape": name, "x": [shape.BT, shape.CIN,
                                                      shape.HWM],
               "cout": shape.COUT,
               "plans": {k: {"bn": v.bn, "np": v.np, "passes": len(v.passes),
                             "stages": v.stages, "smem": v.smem, "grid": v.grid}
                         for k, v in layouts.items()}}
        row["alternating_ms"] = alternating(fns, reps)
        for aname, fn in built.items():
            for lname, lp in layouts.items():
                row[f"{aname[3:]}_{lname}_ms"] = timed(
                    lambda: packed_conv.call_tma(fn, "packed_conv", shape, x, w, lp),
                    reps, queued=True)
        flops = 2 * shape.BT * shape.HWP * shape.K * shape.COUT
        nbytes = x.numel() * 2 + w.numel() * 2 + y.numel() * 2
        row["bound_ms"] = max(nbytes / HBM, flops / PEAK_BF16) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM >= flops / PEAK_BF16 \
            else "operations"
        row["copy_bytes_per_s"] = 2 * (x.numel() + y.numel()) * 2 / (
            row["alternating_ms"]["copy_x_y"][0] / 1e3)
        row["tflops"] = {k: flops / v[0] / 1e9
                         for k, v in row["alternating_ms"].items()
                         if k.startswith(("row", "bn", "parent", "conv2d"))
                         and not k.endswith("row10")}
        print(json.dumps(row), flush=True)
        del x, w, p, x_nd, w_nd, p_bt, p_pm, y, xc, yc
        torch.cuda.empty_cache()


# The ablations (rows 10 and 11, ablate_slabs_kernel and
# ablate_matmul_kernel): the conv's shapes, every layout of
# packed_conv.MATMUL_LAYOUTS (row 11) and every ring depth (row 10) that fits
PA_ABLATIONS = {"no_products": 1, "no_mask": 2, "no_y_stores": 4,
                "unread_rows_not_formed": 8}
PA_BUILDS = {"no_products": "ablate_matmul", "no_mask": "ablate_slabs",
             "no_y_stores": None, "unread_rows_not_formed": "ablate_slabs"}
# the first design's C entry (an earlier packed_conv.cu's m3f_packed_conv,
# modes 2 and 3, --parent)
PA_PARENT_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def pa_layouts(shape, name) -> Dict[str, "packed_conv.AblationPlan"]:
    """Every layout of ``name`` that fits ``shape``: row 11 each of
    MATMUL_LAYOUTS (the fewest N passes it fits), row 10 the planner's
    windows in rings of 2-5 slots, and one window a dy (its deepest ring)."""
    if name == "ablate_matmul":
        plans = {f"imgs{m}": packed_conv.ablation_plan(shape, name, imgs=m)
                 for m in packed_conv.MATMUL_LAYOUTS}
    else:
        plans = {f"stages{st}": packed_conv.ablation_plan(shape, name, stages=st)
                 for st in range(2, 6)}
        plans["windows3"] = packed_conv.ablation_plan(shape, name, windows=3)
    return {k: v for k, v in plans.items() if v.fits}


def _plan_row(plan) -> dict:
    return {k: getattr(plan, k) for k in ("bn", "np", "imgs", "yt", "windows", "stages",
                                          "smem", "items", "grid")}


def pa_resources() -> None:
    """What ptxas says of every build of packed_conv.cu's ablation kernels
    (this source and each -DPA_ABLATE timing build): registers, spills,
    shared memory, and its warnings (a wgmma pipeline it serialised)."""
    src = str(cuda_lib.CSRC / "packed_conv.cu")
    builds = {"kernel": [], **{n: [f"-DPA_ABLATE={k}"] for n, k in PA_ABLATIONS.items()}}
    procs = {n: subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", *d, "-o",
         "/dev/null", src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for n, d in builds.items()}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {n}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "ablat" in line:
                name = line.split("'")[1]
                print(json.dumps({"build": n, "kernel": name[name.index("ablat"):][:48],
                                  "ptxas": [l.strip() for l in lines[i + 1:i + 4]]}),
                      flush=True)
            elif "Performance Loss" in line and "ablat" in line:
                print(json.dumps({"build": n, "ptxas_warning": line.strip()[:160],
                                  "kernel": line.split("'")[-2][-48:]}), flush=True)


def check_packed_ablate() -> None:
    """ptxas' lines of every build, then rows 10 and 11 against their plain
    versions at the small, edge and full shapes: through the wrapper (and
    whether a second call repeats y bit for bit) and at every layout that
    fits through the C entry, row 10 bit for bit; then an input at an odd
    offset, which must give the plain version's y."""
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    pa_resources()
    cuda_lib.build(["packed_conv"])
    entry = cuda_lib.library("packed_conv").m3f_packed_ablate
    g = torch.Generator(device=dev).manual_seed(23)
    for shape in PK_SMALL + tuple(PK_SHAPES.values()):
        x, w = pk_inputs(shape, dev, g)
        p = torch.randn(shape.K, shape.HWP, device=dev, generator=g).to(torch.bfloat16)
        for name in packed_conv.ABLATIONS:
            a = p if name == "ablate_matmul" else x
            fn = getattr(packed_conv, name)
            got, again = fn(a, w, shape), fn(a, w, shape)
            torch.cuda.synchronize()
            row = {"kind": "packed_ablate", "shape": str(shape), "name": name,
                   "plan": _plan_row(packed_conv.ablation_plan(shape, name)),
                   "wrapper": pa_within(name, got, a, w, shape),
                   "repeats": torch.equal(got, again)}
            for lname, lp in pa_layouts(shape, name).items():
                y = packed_conv.call_ablation(entry, shape, a, w, lp)
                torch.cuda.synchronize()
                row[lname] = pa_within(name, y, a, w, shape)
            row["within"] = all(v for k, v in row.items() if k == "wrapper"
                                or k.startswith(("imgs", "stages", "windows")))
            print(json.dumps(row), flush=True)
            del got, again
        del x, w, p
        torch.cuda.empty_cache()
    print(json.dumps({"kind": "packed_ablate", "odd_offset_view_within": odd_offset(
        PK_SMALL[1], dev, g, packed_conv.ABLATIONS)}), flush=True)


def sweep_packed_ablate(reps: int, parent: Optional[str]) -> None:
    """At the probe's full shape (COUT 144, 128, 152 and 192), every time
    a device time (``timed`` queued behind a spin): in alternating rounds
    rows 10 and 11 through the wrappers, every layout that fits through the
    C entry, ``--parent``'s rows 10 and 11 (an earlier packed_conv.cu's
    ``m3f_packed_conv``), ``torch.matmul`` at row 11's product batched over
    BT (its library call) and a device copy of x and y (row 10's bytes);
    then the timing builds ``-DPA_ABLATE=``: 1 no products (row 11: loads,
    staging and stores, the byte floor), 2 no mask (row 10), 4 no y stores
    (both rows, the products kept live), 8 rows >= COUT not formed (row
    10: what forming the rows nobody reads costs), at the planner's
    layouts. Their outputs are wrong; they are timed only."""
    dev = resolve_device("cuda")
    cuda_lib.build(["packed_conv"])
    entry = cuda_lib.library("packed_conv").m3f_packed_ablate
    src = str(cuda_lib.CSRC / "packed_conv.cu")
    built = build_variants(
        {f"pa_{n}": f"PA_ABLATE={k}" for n, k in PA_ABLATIONS.items()},
        "m3f_packed_ablate", {f"pa_{n}": src for n in PA_ABLATIONS},
        cuda_lib.SIGNATURES["packed_conv"]["m3f_packed_ablate"])
    old = None
    if parent:
        old = build_variants({"pa_parent": ""}, "m3f_packed_conv",
                             {"pa_parent": parent}, PA_PARENT_SIG)["pa_parent"]
    g = torch.Generator(device=dev).manual_seed(24)
    for sname, shape in PK_SHAPES.items():
        x, w = pk_inputs(shape, dev, g)
        p = torch.randn(shape.K, shape.HWP, device=dev, generator=g).to(torch.bfloat16)
        args = {"ablate_slabs": x, "ablate_matmul": p}
        row10, row11 = (f"row{r}" for r in (10, 11))
        fns = {row10: lambda: packed_conv.ablate_slabs(x, w, shape),
               row11: lambda: packed_conv.ablate_matmul(p, w, shape)}
        plans = {}
        for name, a in args.items():
            for lname, lp in pa_layouts(shape, name).items():
                key = f"{'row10' if name == 'ablate_slabs' else 'row11'}_{lname}"
                plans[key] = _plan_row(lp)
                fns[key] = lambda lp=lp, a=a: packed_conv.call_ablation(
                    entry, shape, a, w, lp)
        if old is not None:
            def parent_call(mode, a):
                y = torch.empty(shape.BT, shape.COUT, shape.HWP, device=dev,
                                dtype=torch.bfloat16)
                cuda_lib.check(old(a.data_ptr(), w.data_ptr(), y.data_ptr(), mode,
                                   shape.BT, shape.CIN, shape.COUT, shape.W,
                                   shape.HWP, shape.MARGIN, cuda_lib.stream_ptr(x)),
                               "parent ablation")
                return y
            fns["parent_row10"] = lambda: parent_call(2, x)
            fns["parent_row11"] = lambda: parent_call(3, p)
        p_bt = p.expand(shape.BT, -1, -1)
        y = torch.empty(shape.BT, shape.COUT, shape.HWP, device=dev,
                        dtype=torch.bfloat16)
        xc, yc = torch.empty_like(x), torch.empty_like(y)
        fns.update({"matmul_cm": lambda: torch.matmul(w, p_bt),
                    "copy_x_y": lambda: (xc.copy_(x), yc.copy_(y))})
        row = {"kind": "packed_ablate", "shape": sname, "cout": shape.COUT,
               "plans": plans, "alternating_ms": alternating(fns, reps)}
        for aname, fn in built.items():
            for name in packed_conv.ABLATIONS:
                if PA_BUILDS[aname[3:]] not in (None, name):
                    continue
                lp = packed_conv.ablation_plan(shape, name)
                row[f"{aname[3:]}_{name}_ms"] = timed(
                    lambda: packed_conv.call_ablation(fn, shape, args[name], w, lp),
                    reps, queued=True)
        flops = 2 * shape.BT * shape.HWP * shape.K * shape.COUT
        slab_bytes = (x.numel() + y.numel()) * 2
        mm_bytes = (p.numel() + w.numel() + y.numel()) * 2
        row["bound_ms"] = {"row10": slab_bytes / HBM * 1e3,
                           "row11": max(mm_bytes / HBM, flops / PEAK_BF16) * 1e3}
        row["copy_bytes_per_s"] = 2 * slab_bytes / (
            row["alternating_ms"]["copy_x_y"][0] / 1e3)
        row["tflops"] = {k: flops / v[0] / 1e9 for k, v in row["alternating_ms"].items()
                         if k.startswith(("row11", "parent_row11", "matmul"))}
        print(json.dumps(row), flush=True)
        del x, w, p, p_bt, y, xc, yc
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", choices=("spatial", "temporal", "temporal_data",
                                       "spatial_data", "spatial_fwd",
                                       "spatial_fwd_f32", "temporal_fwd_f32",
                                       "spatial_filter_f32",
                                       "spatial_data_f32",
                                       "temporal_data_f32",
                                       "temporal_filter_f32",
                                       "temporal_fwd", "mel", "gru",
                                       "packed", "packed_ablate"),
                    default="spatial")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--check", action="store_true",
                    help="ptxas' resource lines and one comparison per shape")
    ap.add_argument("--parent", default=None,
                    help="spatial_fwd_f32 / temporal_fwd_f32: a "
                         "conv_bn_f32.cu whose fp32 forward of that kind "
                         "(m3f_conv_unit_fwd_f32, the per-tap gather) is "
                         "timed beside the walk, or with --check whose walk "
                         "(the same C entry) must give the same bits; "
                         "spatial_filter_f32: a "
                         "conv_bn_f32.cu whose spatial filter gradient "
                         "(m3f_conv_unit_bwd_filter_f32, the per-tap gather) "
                         "is; spatial_data_f32: a conv_bn_f32.cu whose "
                         "spatial data gradient (m3f_conv_unit_bwd_data_f32, "
                         "the per-tap gather) is; temporal_data_f32: a "
                         "conv_bn_f32.cu whose temporal data gradient (the "
                         "per-tap gather, which took the kind) is, with "
                         "--check held against the plain version too; "
                         "temporal_filter_f32: a conv_bn_f32.cu whose "
                         "temporal filter gradient (the per-tap gather, "
                         "which took the kind) is, likewise; "
                         "spatial_fwd / temporal_fwd: a conv_bn.cu whose "
                         "forward of that kind (the per-tap gather, C entry "
                         "before the walk) is timed beside the kernel; gru: "
                         "a gru.cu whose m3f_gru_fwd is; packed: a "
                         "packed_conv.cu whose m3f_packed_conv (rows 9 and "
                         "12, the first design) is; packed_ablate: a "
                         "packed_conv.cu whose m3f_packed_conv (rows 10 and "
                         "11, modes 2 and 3) is")
    opts = ap.parse_args(argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if opts.kind == "temporal_data":
        check_data() if opts.check else sweep_data(opts.reps)
    elif opts.kind == "spatial_fwd":
        check_spatial_fwd() if opts.check \
            else sweep_spatial_fwd(opts.reps, opts.parent)
    elif opts.kind == "spatial_filter_f32":
        check_filter_f32() if opts.check \
            else sweep_filter_f32(opts.reps, opts.parent)
    elif opts.kind == "spatial_data_f32":
        check_data_f32() if opts.check \
            else sweep_data_f32(opts.reps, opts.parent)
    elif opts.kind == "temporal_data_f32":
        check_temporal_data_f32(opts.parent) if opts.check \
            else sweep_temporal_data_f32(opts.reps, opts.parent)
    elif opts.kind == "temporal_filter_f32":
        check_temporal_filter_f32(opts.parent) if opts.check \
            else sweep_temporal_filter_f32(opts.reps, opts.parent)
    elif opts.kind in ("spatial_fwd_f32", "temporal_fwd_f32"):
        kind = opts.kind[:-len("_fwd_f32")]
        check_fwd_f32(kind, opts.parent) if opts.check \
            else sweep_fwd_f32(kind, opts.reps, opts.parent)
    elif opts.kind == "temporal_fwd":
        check_temporal_fwd() if opts.check \
            else sweep_temporal_fwd(opts.reps, opts.parent)
    elif opts.kind == "mel":
        sweep_mel(opts.reps, opts.check)
    elif opts.kind == "gru":
        check_gru() if opts.check else sweep_gru(opts.reps, opts.parent)
    elif opts.kind == "packed":
        check_packed() if opts.check else sweep_packed(opts.reps, opts.parent)
    elif opts.kind == "packed_ablate":
        check_packed_ablate() if opts.check \
            else sweep_packed_ablate(opts.reps, opts.parent)
    elif opts.kind == "spatial_data":
        check_spatial_data() if opts.check else sweep_spatial_data(opts.reps)
    elif opts.check:
        check(opts.kind)
    else:
        sweep(opts.kind, opts.reps)


if __name__ == "__main__":
    main()
