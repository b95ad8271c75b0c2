"""Packed-layout (channels-major) 3x3 conv of the layout probe: the plain
PyTorch versions and the CUDA kernels.

Counterpart of the four Pallas kernels of ``scripts/probe_packed_conv.py``
(``packed_conv``, ``ablate_slabs``, ``ablate_matmul``,
``packed_conv_chunked``); the kernels are ``csrc/packed_conv.cu``. The conv
(``packed_conv``, ``packed_conv_chunked``) is a TMA-fed ``wgmma`` walk whose
layout ``packed_plan`` picks; the two ablations are TMA-fed walks too
(``ablate_matmul`` a ``wgmma`` GEMM on a resident P^T tile, ``ablate_slabs``
the masked im2col formed in shared memory) whose layouts ``ablation_plan``
picks. On the card an input whose base is off 16 bytes is copied to
aligned storage first (``_aligned``), never refused.

Layout: an image's positions ``p = y·W + x`` ride the minor axis. ``x_cm``
[BT, CIN, HWM] holds each channel's HW positions at ``MARGIN`` (the margins
and the HW..HWP tail are read as given, whatever they hold); ``w_cm`` [COUT,
K] holds the 3x3 filter with ``k = tap·CIN + c`` in ``TAPS`` order. The im2col
matrix of one image is ``P[K, HWP]`` whose row block ``tap`` is the slab
``x[:, MARGIN + s : MARGIN + s + HWP]``, ``s = dy·W + dx``, with the columns
``p % W == 0`` multiplied by 0 in the ``dx = -1`` slabs and ``p % W == W-1``
in the ``dx = +1`` slabs (the x-edge wrap). Then

    packed_conv          y[b] = W_cm @ P[b]   fp32 accumulation, bf16 or fp32 y
    packed_conv_chunked  the same, bf16 y, built in CHUNK-position pieces
    ablate_slabs         y[b] = P[b][:COUT]   (the im2col alone)
    ablate_matmul        y[b] = bf16(W_cm @ p_const) for every b (the product
                         alone, on one resident P)

over all HWP columns: the tail HW..HWP is real output (its dy = -1 taps read
the last image row). The shape is a ``ProbeShape`` parameter, so the same
code runs at the probe's full size and small.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from m3f_torch.ops import cuda_lib

TAPS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


@dataclasses.dataclass(frozen=True)
class ProbeShape:
    """The probe's shape; the defaults are the fusion model's stage-1
    spatial conv ``[32,16,56,56,64] -> 144`` (probe_packed_conv.py:42-50)."""
    B: int = 32
    T: int = 16
    H: int = 56
    W: int = 56
    CIN: int = 64
    COUT: int = 144
    MARGIN: int = 128
    CHUNK: int = 640

    @property
    def BT(self) -> int:
        return self.B * self.T

    @property
    def HW(self) -> int:
        return self.H * self.W

    @property
    def HWP(self) -> int:
        """HW rounded up to 128 positions."""
        return ((self.HW + 127) // 128) * 128

    @property
    def HWM(self) -> int:
        return self.HWP + 2 * self.MARGIN

    @property
    def K(self) -> int:
        return len(TAPS) * self.CIN


def pack_x(x_ndhwc: np.ndarray, shape: ProbeShape) -> np.ndarray:
    """[B,T,H,W,C] -> channels-major [BT, C, HWM] fp32 with zero margins."""
    xt = x_ndhwc.reshape(shape.BT, shape.HW, shape.CIN).transpose(0, 2, 1)
    out = np.zeros((shape.BT, shape.CIN, shape.HWM), np.float32)
    out[:, :, shape.MARGIN:shape.MARGIN + shape.HW] = xt
    return out


def pack_w(w_hwio: np.ndarray) -> np.ndarray:
    """[3,3,CIN,COUT] -> [COUT, K] with K ordered like TAPS x CIN."""
    rows = [w_hwio[dy + 1, dx + 1] for dy, dx in TAPS]     # [CIN, COUT] each
    return np.concatenate(rows, axis=0).T                   # [COUT, K]


def im2col(x_cm: torch.Tensor, shape: ProbeShape) -> torch.Tensor:
    """The masked im2col matrix of every image, [BT, K, HWP] in x's dtype."""
    col = torch.arange(shape.HWP, device=x_cm.device) % shape.W
    mask = {-1: (col != 0).to(x_cm.dtype), 1: (col != shape.W - 1).to(x_cm.dtype)}
    slabs = []
    for dy, dx in TAPS:
        s = shape.MARGIN + dy * shape.W + dx
        slab = x_cm[:, :, s:s + shape.HWP]
        slabs.append(slab * mask[dx] if dx else slab)
    return torch.cat(slabs, dim=1)


def packed_conv_reference(x_cm: torch.Tensor, w_cm: torch.Tensor,
                          shape: ProbeShape, out_f32: bool = False
                          ) -> torch.Tensor:
    """y [BT, COUT, HWP] = w_cm @ im2col(x_cm) in fp32, bf16 unless
    ``out_f32``. The chunked kernel's plain version too."""
    y = torch.matmul(w_cm.float(), im2col(x_cm, shape).float())
    return y if out_f32 else y.to(torch.bfloat16)


def ablate_slabs_reference(x_cm: torch.Tensor, w_cm: torch.Tensor,
                           shape: ProbeShape) -> torch.Tensor:
    """y [BT, COUT, HWP] = the first COUT rows of each image's im2col."""
    return im2col(x_cm, shape)[:, :shape.COUT].contiguous()


def ablate_matmul_reference(p_const: torch.Tensor, w_cm: torch.Tensor,
                            shape: ProbeShape) -> torch.Tensor:
    """y [BT, COUT, HWP] = bf16(w_cm @ p_const) for every image."""
    y = torch.matmul(w_cm.float(), p_const.float()).to(torch.bfloat16)
    return y.expand(shape.BT, -1, -1).contiguous()


def _check(name: str, shape: ProbeShape, a: torch.Tensor,
           w_cm: torch.Tensor) -> None:
    """What every version takes: tensors of the shape's sizes, the halo
    within the margins, a COUT no wider than K (the slab ablation copies
    COUT rows of P) and, for the chunked kernel, whole chunks (the TPU kernel
    leaves a partial last chunk unwritten)."""
    a_shape = (shape.K, shape.HWP) if name == "ablate_matmul" \
        else (shape.BT, shape.CIN, shape.HWM)
    bad = []
    if (tuple(a.shape), tuple(w_cm.shape)) != (a_shape, (shape.COUT, shape.K)):
        bad.append(f"shapes {tuple(a.shape)}, {tuple(w_cm.shape)}, expected "
                   f"{a_shape}, {(shape.COUT, shape.K)}")
    if shape.W + 1 > shape.MARGIN:
        bad.append(f"MARGIN {shape.MARGIN} < W + 1 = {shape.W + 1}")
    if name == "ablate_slabs" and shape.COUT > shape.K:
        bad.append(f"COUT {shape.COUT} > K {shape.K}")
    if name == "packed_conv_chunked" and shape.HWP % shape.CHUNK:
        bad.append(f"HWP {shape.HWP} not a multiple of CHUNK {shape.CHUNK}")
    if bad:
        raise ValueError(f"{name}: {'; '.join(bad)} ({shape})")


# The conv's walk (packed_tma_kernel in csrc/packed_conv.cu)
TILE_P = 64              # positions of a consumer warpgroup's tile (wgmma M)
WROW = 88                # positions of an x window: 64 + up to 7 + 2 + 1
ROW = 128                # bytes of a 128-byte-swizzled W row (64 bf16)
BOX_C = 64               # channels of an x window and of a W tile (one
#                          128-byte swizzled row of W)
TMA_ALIGN = 8            # elements: the copy engine takes a box only at an
#                          innermost coordinate on 16 bytes (measured on the
#                          H100: any other offset is an illegal instruction)
WIDTHS = (32, 64, 128, 144, 192)   # the kernel's wgmma N instantiations (a
#                                      pass of 256 fits no layout's ring)
MAX_STAGES = 4           # ring slots
SMEM_LIMIT = 232_448     # shared memory a block can use on an H100
SMS = 132                # H100 SXM multiprocessors: the persistent grid
ENCODE_FAILED = 0x10000  # m3f_packed_conv_tma: + the CUresult of a refused map
CONV_MODES = ("packed_conv", "packed_conv_f32", "packed_conv_chunked")
# tile positions in the order the planner tries them, W streamed beside the
# windows in both: two consumer warpgroups on 128 positions (at the probe's
# shape 0.50 ms against 0.61 for one warpgroup on 64, whose epilogue and
# fragment loads the tensor cores wait for: filter_sweep --kind packed,
# PERF.md), then one on 64 (a pass of N 192 fits only its ring)
LAYOUTS = (128, 64)


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


class PackedPlan(NamedTuple):
    """The walk's cut of one conv call (``packed_plan``)."""
    mode: str
    bn: int              # positions a tile: 64 per consumer warpgroup
    warpgroups: int
    np: int              # wgmma N of a pass, one of WIDTHS
    passes: Tuple[Tuple[int, int], ...]   # (first channel, channels) a pass
    k_pad: int           # K per tap: CIN in boxes of 64 channels, zeros past CIN
    kc: int              # channel boxes a tap
    k16: Tuple[int, ...]  # wgmma k-steps of 16 channels in each box
    stages: int
    regions: Dict[str, Tuple[int, int]]   # name: (byte offset, bytes)
    smem: int            # dynamic shared memory asked for (with the 1024 slack)
    stage_tx: int        # bytes one ring slot's barrier waits for: a
    #                      (dy, channel box) of a tile
    unit: str            # "tile" or "chunk"
    tiles_per_unit: int
    units: int
    grid: int
    boxes: Dict[str, Tuple[Tuple[int, int, int], int]]  # (box, swizzle bytes)
    fits: bool

    def blocks_units(self, block: int) -> range:
        """The units block ``block`` takes, in order (round-robin)."""
        return range(block, self.units, self.grid)

    def unit_tiles(self, unit: int, shape: "ProbeShape") -> list:
        """(image, first position) of each tile of ``unit``, in order."""
        per_image = shape.HWP // (self.tiles_per_unit * self.bn)
        b, t0 = divmod(unit, per_image)
        return [(b, (t0 * self.tiles_per_unit + t) * self.bn)
                for t in range(self.tiles_per_unit)]


def window_start(shape: ProbeShape, p0: int, dy: int) -> int:
    """First position of the x window of (tile at p0, dy): 8-aligned (the
    copy engine's innermost coordinate falls on 16 bytes), at or before
    MARGIN + p0 + dy*W - 1, WROW long, so it holds the three dx taps."""
    return (shape.MARGIN + p0 + dy * shape.W - 1) // TMA_ALIGN * TMA_ALIGN


def _regions(np_: int, wgs: int, stages: int,
             y_size: int) -> Tuple[Dict[str, Tuple[int, int]], int]:
    """Byte regions from the 1024-aligned base, as the kernel lays them out
    (the B ring [stage][dx], the y staging tiles, the x window ring
    [stage][warpgroup], the barriers) and the shared memory asked for."""
    sizes = [("b", stages * 3 * np_ * ROW),
             ("y", wgs * np_ * TILE_P * y_size),
             ("x", stages * wgs * BOX_C * WROW * 2),
             ("bars", 2 * stages * 8)]
    regions, off = {}, 0
    for name, size in sizes:
        regions[name] = (off, size)
        off += size
    return regions, off + 1024


def packed_plan(shape: ProbeShape, mode: str, bn: Optional[int] = None,
                sms: int = SMS) -> PackedPlan:
    """The conv walk's cut of ``shape`` for ``mode`` (one of CONV_MODES):
    the fewest N passes (each the narrowest of WIDTHS that covers COUT in
    that many passes) for which a layout fits, K per tap in boxes of BOX_C
    channels (the copy engine fills channels past CIN with zeros), and the
    first layout of LAYOUTS (``bn`` where given) whose ring of at least 2 slots (at most MAX_STAGES; a slot is
    one (dy, channel box) of a tile) fits SMEM_LIMIT; a persistent grid of
    min(sms, units) blocks, a unit being a tile (or, for the chunked
    kernel, CHUNK positions of one image, its tiles in order). ``fits`` is
    False when no layout fits."""
    if mode not in CONV_MODES:
        raise ValueError(f"packed_plan: mode {mode!r}, expected one of {CONV_MODES}")
    chunked = mode == "packed_conv_chunked"
    y_size = 4 if mode == "packed_conv_f32" else 2
    kc = -(-shape.CIN // BOX_C)
    layouts = [b for b in LAYOUTS if bn in (None, b)]
    if not layouts:
        raise ValueError(f"packed_plan: no layout of {LAYOUTS} has bn {bn}")
    plan = None
    npasses = -(-shape.COUT // WIDTHS[-1])
    while plan is None or not plan.fits:
        need = _round_up(-(-shape.COUT // npasses), 8)
        if need < WIDTHS[0] and plan is not None:
            break                           # narrower passes fit no better
        np_ = next(w for w in WIDTHS if w >= need)
        passes = tuple((i * np_, min(np_, shape.COUT - i * np_))
                       for i in range(npasses))
        for b in layouts:
            plan = _layout(shape, mode, chunked, y_size, kc, np_, passes, b, sms)
            if plan.fits:
                break
        npasses += 1
    return plan


def _layout(shape: ProbeShape, mode: str, chunked: bool, y_size: int, kc: int,
            np_: int, passes: tuple, b: int, sms: int) -> PackedPlan:
    """``packed_plan``'s cut with N passes of ``np_`` on ``b`` positions a
    tile."""
    whole = shape.HWP % b == 0 and (not chunked or shape.CHUNK % b == 0)
    for st in range(MAX_STAGES, 1, -1):
        regions, smem = _regions(np_, b // TILE_P, st, y_size)
        stages = st
        if smem <= SMEM_LIMIT:
            break
    tiles_per_unit = shape.CHUNK // b if chunked else 1
    units = shape.BT * (shape.HWP // (tiles_per_unit * b)) if whole else 0
    return PackedPlan(
        mode=mode, bn=b, warpgroups=b // TILE_P, np=np_,
        passes=passes, k_pad=kc * BOX_C, kc=kc, k16=(BOX_C // 16,) * kc,
        stages=stages, regions=regions, smem=smem,
        stage_tx=(b // TILE_P) * BOX_C * WROW * 2 + 3 * np_ * ROW,
        unit="chunk" if chunked else "tile",
        tiles_per_unit=tiles_per_unit, units=units, grid=max(1, min(sms, units)),
        boxes={"x": ((WROW, BOX_C, 1), 0), "w": ((BOX_C, 1, np_), 128),
               "y": ((TILE_P, np_, 1), 0 if y_size == 4 else 128)},
        fits=whole and smem <= SMEM_LIMIT)


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its base address lies on 16 bytes, else a fresh
    contiguous copy on the same device (the allocator places it on 512 bytes
    on the card). The copy engine takes a tensor map only at a 16-byte
    aligned base: a view at an odd element offset goes through the same
    kernel on aligned storage, never to the plain version."""
    if t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def call_tma(fn, name: str, shape: ProbeShape, x_cm: torch.Tensor,
             w_cm: torch.Tensor, plan: PackedPlan) -> torch.Tensor:
    """One call of an ``m3f_packed_conv_tma`` entry point (this source's, or
    a timing build's) with ``plan`` -> y [BT, COUT, HWP]; raises on a refused
    launch or a tensor map the CUDA driver cannot encode. Counts nothing.
    Asserts 16-byte aligned bases (the wrappers hand it ``_aligned``
    tensors)."""
    if not plan.fits:
        raise ValueError(f"{name}: no layout of packed_plan fits {shape} "
                         f"(smem {plan.smem} of {SMEM_LIMIT}, {plan})")
    for what, t in (("x_cm", x_cm), ("w_cm", w_cm)):
        assert t.data_ptr() % 16 == 0, \
            f"{name}: {what}'s base address {t.data_ptr():#x} is not on 16 bytes"
    out_f32 = plan.mode == "packed_conv_f32"
    y = torch.empty(shape.BT, shape.COUT, shape.HWP, device=x_cm.device,
                    dtype=torch.float32 if out_f32 else torch.bfloat16)
    with torch.cuda.device(x_cm.device):
        err = fn(x_cm.data_ptr(), w_cm.data_ptr(), y.data_ptr(), int(out_f32),
                 shape.BT, shape.CIN, shape.COUT, shape.W, shape.HWP, shape.MARGIN,
                 shape.CHUNK if plan.unit == "chunk" else 0, plan.bn,
                 plan.stages, plan.np, plan.grid,
                 cuda_lib.stream_ptr(x_cm))
    _check_err(err, name)
    return y


def _check_err(err: int, name: str) -> None:
    if err >= ENCODE_FAILED:
        raise RuntimeError(f"{name}: the CUDA driver refused a tensor map (CUresult "
                           f"{err - ENCODE_FAILED}; base addresses and strides "
                           f"must be 16-byte aligned)")
    cuda_lib.check(err, f"{name} kernel")


def _card_inputs(name: str, shape: ProbeShape, a: torch.Tensor,
                 w_cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The card path's guard (bf16 tensors on one CUDA device, CIN and
    MARGIN multiples of 8: 16-byte strides and window starts) -> both
    tensors contiguous on 16-byte aligned storage."""
    cuda_lib.require_cuda(name, a, w_cm)
    if a.dtype != torch.bfloat16 or w_cm.dtype != torch.bfloat16 \
            or shape.CIN % 8 or shape.MARGIN % 8:
        raise ValueError(
            f"{name} kernel takes bf16 inputs with CIN and MARGIN multiples "
            f"of 8; got {a.dtype}, {w_cm.dtype}, {shape}")
    return _aligned(a.contiguous()), _aligned(w_cm.contiguous())


def _launch_conv(name: str, shape: ProbeShape, x_cm: torch.Tensor,
                 w_cm: torch.Tensor, out_f32: bool = False) -> torch.Tensor:
    """One launch of the conv walk (``packed_plan``'s layout) -> y."""
    x_cm, w_cm = _card_inputs(name, shape, x_cm, w_cm)
    mode = "packed_conv_f32" if out_f32 else name
    plan = packed_plan(shape, mode, sms=_sm_count(x_cm.device))
    y = call_tma(cuda_lib.library("packed_conv").m3f_packed_conv_tma, name, shape,
                 x_cm, w_cm, plan)
    cuda_lib.launches[name] += 1
    return y


# The ablations (rows 10 and 11; ablate_slabs_kernel and
# ablate_matmul_kernel in csrc/packed_conv.cu, entry m3f_packed_ablate)
ABLATIONS = ("ablate_slabs", "ablate_matmul")
ABL_MODES = {"ablate_slabs": 2, "ablate_matmul": 3}
# row 11: two consumer warpgroups split the images of a 64-position tile
# (the 128-position layouts, and one warpgroup alone, lost at every
# measured shape: PERF.md); the layouts, in the order the planner tries
# them, are the images of a work item, two or one a warpgroup. Each keeps
# the block's P^T tile resident and streams W, each W box read by both.
MATMUL_WGS = 2
MATMUL_LAYOUTS = (4, 2)
P_BOX = 64 * 64 * 2      # bytes of a P^T box: 64 k rows of 64 positions
ACC_MAX = 256            # a warpgroup's images x N (its fp32 accumulators a
#                          thread) at most: ptxas keeps a block of two to 168
#                          registers a thread, and 2 x 144 spilled there
ABL_MAX_STAGES = 8       # ring slots of both ablations
SLAB_BN = 128            # positions of a row 10 tile
SLAB_ROW = 144           # positions of a row 10 x window of one dy: 128 + up
#                          to 7 + 2, and the funnel's word past them, on 8
SLAB_FORMERS = 256       # row 10's forming threads (then one producer warp)
Y_ROWS_MAX = 256         # rows of a TMA box


class AblationPlan(NamedTuple):
    """An ablation kernel's cut of one call (``ablation_plan``)."""
    name: str
    bn: int              # positions a tile
    threads: int
    np: int              # row 11: wgmma N of a pass, one of WIDTHS (row 10: 0)
    passes: Tuple[Tuple[int, int], ...]   # row 11: (first channel, channels)
    imgs: int            # images a work item (row 10: 1)
    yt: int              # row 11: staging tiles a warpgroup (row 10: 0)
    windows: int         # row 10: x windows a (tile, channel box), 1 or 3
    kb: int              # row 11: 64-k boxes of K; row 10: channel boxes a tap
    box_c: int           # channels (row 11: k rows) of a box
    stages: int          # ring slots: W boxes (row 11), x windows (row 10)
    resident: str        # what stays in shared memory across a block's items
    regions: Dict[str, Tuple[int, int]]   # name: (byte offset, bytes)
    smem: int            # dynamic shared memory asked for (with the 1024 slack)
    stage_tx: int        # bytes one ring slot's barrier waits for
    tiles: int           # position tiles an image
    groups: int          # work items a tile (row 11) or an image (row 10)
    items: int
    per: int             # items a block: a contiguous range
    grid: int
    boxes: Dict[str, Tuple[Tuple[int, int, int], int]]  # (box, swizzle bytes)
    fits: bool

    def blocks_items(self, block: int) -> range:
        """The work items block ``block`` takes, in order."""
        return range(block * self.per, min((block + 1) * self.per, self.items))

    def item_tiles(self, item: int, shape: "ProbeShape") -> list:
        """(image, first position) of each tile of y that ``item`` writes:
        row 11's items are tile-major (a tile, then a group of images), row
        10's image-major (an image, then a tile)."""
        if self.name == "ablate_slabs":
            b, t = divmod(item, self.tiles)
            return [(b, t * self.bn)]
        t, g = divmod(item, self.groups)
        return [(b, t * self.bn)
                for b in range(g * self.imgs, min((g + 1) * self.imgs, shape.BT))]


def _spread(items: int, sms: int) -> Tuple[int, int]:
    """(items a block, blocks): contiguous ranges over at most ``sms``
    blocks, none empty."""
    per = -(-items // max(1, sms)) if items else 1
    return per, max(1, -(-items // per))


def _pack_regions(sizes) -> Tuple[Dict[str, Tuple[int, int]], int]:
    regions, off = {}, 0
    for name, size in sizes:
        regions[name] = (off, size)
        off += size
    return regions, off + 1024


def slab_window_start(shape: ProbeShape, p0: int, dy: int, windows: int) -> int:
    """First position of row 10's x window serving (tile at p0, dy): one
    window for all three dy starts where dy = -1's would."""
    return window_start(shape, p0, -1 if windows == 1 else dy)


def slab_window(shape: ProbeShape) -> Tuple[int, int]:
    """(windows a tile and channel box, positions a window) of row 10: one
    window from dy = -1's start to the dy = +1 tap's funnel words, where it
    fits a box of 256, else one SLAB_ROW window per dy."""
    one = _round_up((-shape.W - 1) % TMA_ALIGN + 2 * shape.W + 137, TMA_ALIGN)
    return (1, one) if one <= 256 else (3, SLAB_ROW)


def ablation_plan(shape: ProbeShape, name: str, sms: int = SMS,
                  imgs: Optional[int] = None,
                  stages: Optional[int] = None,
                  windows: Optional[int] = None) -> AblationPlan:
    """The ablation kernel's cut of ``shape`` (``name`` one of ABLATIONS).

    ablate_matmul: the fewest N passes (the narrowest of WIDTHS covering
    COUT in that many) for which a layout fits, then the first of
    MATMUL_LAYOUTS (``imgs`` where given) whose warpgroups' accumulators
    stay within ACC_MAX and whose resident P^T tile (K in boxes of 64, zeros
    past K), staging tiles (one per image of a warpgroup where they fit,
    else one) and W ring of at least 2 slots (the deepest that fits, at
    most ABL_MAX_STAGES) fit SMEM_LIMIT. ablate_slabs: 128-position
    tiles, min(64, CIN) channels a box, x windows of ``slab_window``
    (``windows`` 3 forces one a dy), the staging tile of rows < COUT (in
    boxes of at most 256 rows), a scratch tile for the rows formed and not
    stored, and the deepest ring (``stages`` where given) that fits. Both:
    a grid of at most ``sms`` blocks, each a contiguous range of work
    items. ``fits`` is False when no layout fits."""
    if name not in ABLATIONS:
        raise ValueError(f"ablation_plan: name {name!r}, expected one of {ABLATIONS}")
    if name == "ablate_slabs":
        return _slab_plan(shape, sms, stages, windows)
    layouts = [m for m in MATMUL_LAYOUTS if imgs in (None, m)]
    if not layouts:
        raise ValueError(f"ablation_plan: no layout of {MATMUL_LAYOUTS} has {imgs} images")
    plan = None
    npasses = -(-shape.COUT // WIDTHS[-1])
    while plan is None or not plan.fits:
        need = _round_up(-(-shape.COUT // npasses), 8)
        if need < WIDTHS[0] and plan is not None:
            break                           # narrower passes fit no better
        np_ = next(w for w in WIDTHS if w >= need)
        passes = tuple((i * np_, min(np_, shape.COUT - i * np_))
                       for i in range(npasses))
        for m in layouts:
            plan = _matmul_layout(shape, np_, passes, m, sms, stages)
            if plan.fits:
                break
        npasses += 1
    return plan


def _matmul_layout(shape: ProbeShape, np_: int, passes: tuple, m: int, sms: int,
                   stages: Optional[int]) -> AblationPlan:
    """Row 11's cut with N passes of ``np_`` and ``m`` images a work item."""
    per_wg = m // MATMUL_WGS             # images of one warpgroup
    kb = -(-shape.K // BOX_C)
    for yt in dict.fromkeys((per_wg, 1)):
        for st in ([stages] if stages else range(ABL_MAX_STAGES, 1, -1)):
            regions, smem = _pack_regions([("p", kb * P_BOX),
                                           ("w", st * np_ * ROW),
                                           ("y", MATMUL_WGS * yt * np_ * TILE_P * 2),
                                           ("bars", (2 * st + 2) * 8)])
            if smem <= SMEM_LIMIT:
                break
        if smem <= SMEM_LIMIT:
            break
    tiles = shape.HWP // TILE_P
    groups = -(-shape.BT // m)
    items = tiles * groups
    per, grid = _spread(items, sms)
    return AblationPlan(
        name="ablate_matmul", bn=TILE_P, threads=MATMUL_WGS * 128 + 32, np=np_,
        passes=passes, imgs=m, yt=yt, windows=0, kb=kb, box_c=BOX_C, stages=st,
        resident="p_const", regions=regions, smem=smem, stage_tx=np_ * ROW,
        tiles=tiles, groups=groups, items=items, per=per, grid=grid,
        boxes={"p": ((TILE_P, BOX_C, 1), 128), "w": ((BOX_C, np_, 1), 128),
               "y": ((TILE_P, np_, 1), 128)},
        fits=(smem <= SMEM_LIMIT and 2 <= st <= ABL_MAX_STAGES
              and per_wg * np_ <= ACC_MAX and kb * P_BOX < 1 << 20))


def _slab_plan(shape: ProbeShape, sms: int, stages: Optional[int],
               windows: Optional[int]) -> AblationPlan:
    """Row 10's cut: see ``ablation_plan``."""
    box_c = min(BOX_C, shape.CIN)
    kc = -(-shape.CIN // box_c)
    ny = -(-shape.COUT // Y_ROWS_MAX)
    y_rows = _round_up(-(-shape.COUT // ny), 8)
    wins, wrow = (3, SLAB_ROW) if windows == 3 else slab_window(shape)
    slot = box_c * wrow * 2
    for st in ([stages] if stages else range(ABL_MAX_STAGES, 1, -1)):
        regions, smem = _pack_regions([("y", ny * y_rows * SLAB_BN * 2),
                                       ("scratch", BOX_C * SLAB_BN * 2),
                                       ("x", st * slot),
                                       ("bars", 2 * st * 8)])
        if smem <= SMEM_LIMIT:
            break
    tiles = shape.HWP // SLAB_BN
    items = shape.BT * tiles
    per, grid = _spread(items, sms)
    return AblationPlan(
        name="ablate_slabs", bn=SLAB_BN, threads=SLAB_FORMERS + 32, np=0,
        passes=(), imgs=1, yt=0, windows=wins, kb=kc, box_c=box_c, stages=st,
        resident="none",
        regions=regions, smem=smem, stage_tx=slot, tiles=tiles, groups=tiles,
        items=items, per=per, grid=grid,
        boxes={"x": ((wrow, box_c, 1), 0), "y": ((SLAB_BN, y_rows, 1), 0)},
        fits=(shape.HWP % SLAB_BN == 0 and shape.COUT <= shape.K
              and smem <= SMEM_LIMIT and 2 <= st <= ABL_MAX_STAGES
              and windows in (None, 3, wins)))


def call_ablation(fn, shape: ProbeShape, a: torch.Tensor, w_cm: torch.Tensor,
                  plan: AblationPlan) -> torch.Tensor:
    """One call of an ``m3f_packed_ablate`` entry point (this source's, or a
    timing build's) with ``plan`` -> y [BT, COUT, HWP] bf16; raises on a
    layout that does not fit, a refused launch or a tensor map the CUDA
    driver cannot encode. Counts nothing."""
    if not plan.fits:
        raise ValueError(f"{plan.name}: no layout of ablation_plan fits {shape} "
                         f"(smem {plan.smem} of {SMEM_LIMIT}, {plan})")
    for what, t in (("a", a), ("w_cm", w_cm)):
        assert t.data_ptr() % 16 == 0, \
            f"{plan.name}: {what}'s base address {t.data_ptr():#x} is not on 16 bytes"
    y = torch.empty(shape.BT, shape.COUT, shape.HWP, device=a.device,
                    dtype=torch.bfloat16)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), w_cm.data_ptr(), y.data_ptr(), ABL_MODES[plan.name],
                 shape.BT, shape.CIN, shape.COUT, shape.W, shape.HWP, shape.MARGIN,
                 plan.stages, plan.np, plan.imgs, plan.yt, plan.windows,
                 plan.grid, cuda_lib.stream_ptr(a))
    _check_err(err, plan.name)
    return y


def _launch(name: str, shape: ProbeShape, a: torch.Tensor,
            w_cm: torch.Tensor) -> torch.Tensor:
    """One launch of ablation kernel ``name`` (``ablation_plan``'s layout)
    -> y [BT, COUT, HWP] bf16."""
    a, w_cm = _card_inputs(name, shape, a, w_cm)
    plan = ablation_plan(shape, name, sms=_sm_count(a.device))
    y = call_ablation(cuda_lib.library("packed_conv").m3f_packed_ablate, shape, a,
                      w_cm, plan)
    cuda_lib.launches[name] += 1
    return y


def packed_conv(x_cm: torch.Tensor, w_cm: torch.Tensor, shape: ProbeShape,
                out_f32: bool = False) -> torch.Tensor:
    """y [BT, COUT, HWP] of the packed conv (module doc): the plain version
    on the CPU, one launch of the conv walk on the card."""
    _check("packed_conv", shape, x_cm, w_cm)
    if x_cm.device.type == "cpu":
        return packed_conv_reference(x_cm, w_cm, shape, out_f32)
    return _launch_conv("packed_conv", shape, x_cm, w_cm, out_f32)


def packed_conv_chunked(x_cm: torch.Tensor, w_cm: torch.Tensor,
                        shape: ProbeShape) -> torch.Tensor:
    """The packed conv with bf16 y; on the card the conv walk with whole
    CHUNKs of one image as its units (their tiles in order, the TPU kernel's
    grid step); the plain version on the CPU."""
    _check("packed_conv_chunked", shape, x_cm, w_cm)
    if x_cm.device.type == "cpu":
        return packed_conv_reference(x_cm, w_cm, shape)
    return _launch_conv("packed_conv_chunked", shape, x_cm, w_cm)


def ablate_slabs(x_cm: torch.Tensor, w_cm: torch.Tensor,
                 shape: ProbeShape) -> torch.Tensor:
    """The im2col build without the product; y = the first COUT rows of P
    (the kernel builds every row of its P tile and stores these)."""
    _check("ablate_slabs", shape, x_cm, w_cm)
    if x_cm.device.type == "cpu":
        return ablate_slabs_reference(x_cm, w_cm, shape)
    return _launch("ablate_slabs", shape, x_cm, w_cm)


def ablate_matmul(p_const: torch.Tensor, w_cm: torch.Tensor,
                  shape: ProbeShape) -> torch.Tensor:
    """The product without the im2col: y[b] = bf16(w_cm @ p_const), which
    the kernel recomputes for every image b."""
    _check("ablate_matmul", shape, p_const, w_cm)
    if p_const.device.type == "cpu":
        return ablate_matmul_reference(p_const, w_cm, shape)
    return _launch("ablate_matmul", shape, p_const, w_cm)
