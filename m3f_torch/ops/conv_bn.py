"""Fused conv + BatchNorm unit: the plain PyTorch versions and the CUDA
kernels, forward and backward.

Counterpart of ``m3f/pytorch_tpu/ops/pallas/conv_bn.py`` (``conv_unit``,
``conv_unit_fwd``, ``conv_unit_reference``, ``_spatial_bwd``,
``_temporal_bwd``, ``_xla_bwd``); the kernels are ``csrc/conv_bn.cu``. One
unit is

    prologue:  x̂ = relu(x·inv + shift)   (previous BN + ReLU in the compute
                                          dtype; identity without inv/shift)
    conv:      y = x̂ ⊛ W                 (1,3,3) "spatial" or (3,1,1)
                                          "temporal", stride 1, pad 1
    epilogue:  s1 = Σy, s2 = Σy²          (fp32 per channel, over the rounded y)

x is [B, T, H, W, C_in] for both kinds; w is the reference's layout,
[3, 3, C_in, C_out] (spatial) or [3, C_in, C_out] (temporal), cast to x's
dtype.

The backward folds the cotangents (gy, gs1, gs2) into
``ge = gy + bf16(gs1 + 2·f32(y)·gs2)`` and computes, as the reference's
Pallas backward does, ``dx`` in x's dtype (through the ReLU mask and inv
when the unit has the prologue, with fp32 ``dinv = Σ x·dxa`` and
``dshift = Σ dxa``) and ``dw`` in fp32 straight from the accumulator.
``conv_unit`` is the differentiable unit (a ``torch.autograd.Function``):
both halves are kernels on the card and plain versions on the CPU.

x is bf16 or fp32, and both halves have kernels for both (the reference's
Pallas units run in the dtype of x): ``csrc/conv_bn.cu`` for bf16,
``csrc/conv_bn_f32.cu`` for fp32 (the forward, ``f32_temporal_fwd_plan`` /
``f32_spatial_fwd_plan`` / ``f32_fwd_plan``; the data
gradient, ``f32_temporal_data_plan`` / ``f32_spatial_data_plan`` /
``f32_bwd_data_plan``; the filter gradient, ``f32_spatial_filter_plan``
/ ``f32_bwd_filter_plan``), so an fp32 unit trains on the card as a bf16
one does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from m3f_torch.nn import full_fp32
from m3f_torch.ops import cuda_lib


def _torch_kernel(w: torch.Tensor, kind: str) -> Tuple[torch.Tensor, tuple]:
    """Reference-layout unit weight → (F.conv3d weight [Co, Ci, kt, kh, kw],
    padding)."""
    if kind == "spatial":
        return w.permute(3, 2, 0, 1)[:, :, None], (0, 1, 1)
    if kind == "temporal":
        return w.permute(2, 1, 0)[:, :, :, None, None], (1, 0, 0)
    raise ValueError(f"unknown conv unit kind {kind!r} (spatial | temporal)")


def conv_unit_reference(x: torch.Tensor, w: torch.Tensor,
                        inv: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None, *, kind: str
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain composition: affine + ReLU, ``F.conv3d`` on a channels-last
    view, then the fp32 channel sums of the rounded output."""
    dtype = x.dtype
    if inv is not None:
        x = torch.clamp_min(x * inv.to(dtype) + shift.to(dtype), 0)
    kernel, pad = _torch_kernel(w.to(dtype), kind)
    with full_fp32():                   # an fp32 conv stays fp32 (no TF32)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                     kernel.contiguous(memory_format=torch.channels_last_3d),
                     padding=pad).permute(0, 2, 3, 4, 1)
    yf = y.float()
    axes = (0, 1, 2, 3)
    return y, yf.sum(axes), (yf * yf).sum(axes)


def tap_pairs(kind: str, b: int, t: int, h: int, w: int) -> int:
    """The (output position, tap) pairs of a unit over x [b, t, h, w, ·]
    whose input lies inside the clip: 3T - 2 a column of frames for the
    temporal kind, (3H - 2)(3W - 2) an image for the spatial kind. The
    unit's function needs 2·C_in·C_out operations a pair (the zero padding
    needs none): the operation count of its bound."""
    if kind == "temporal":
        return b * h * w * (3 * t - 2)
    return b * t * (3 * h - 2) * (3 * w - 2)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round8(n: int) -> int:
    return _cdiv(n, 8) * 8


def _zero_pad(t: Optional[torch.Tensor], *sizes: int) -> Optional[torch.Tensor]:
    """``t`` zero-padded at the end of its last ``len(sizes)`` axes up to
    ``sizes`` (None stays None)."""
    if t is None:
        return None
    pad = []
    for axis, n in zip(range(-1, -len(sizes) - 1, -1), reversed(sizes)):
        pad += [0, n - t.shape[axis]]
    return F.pad(t, pad) if any(pad) else t


def pad_channels(x, w, inv, shift, *co_side):
    """The kernels take C_in and C_out in multiples of 8: a unit's tensors
    zero-padded up to them. x, inv and shift (and w's C_in axis) pad along
    C_in, w's C_out axis and ``co_side`` (y, gy [..., C_out]; gs1, gs2
    [C_out]) along C_out. inv = shift = 0 forms x̂ = relu(0·0 + 0) = 0 on
    the padded input channels, and gy = y = gs1 = gs2 = 0 gives ge = 0 on
    the padded output channels, so neither adds to a real output; ``w`` may
    be None (the filter gradient takes none)."""
    ci = x.shape[-1]
    co = (w if w is not None else co_side[0]).shape[-1]
    ci8, co8 = _round8(ci), _round8(co)
    return (_zero_pad(x, ci8), _zero_pad(w, ci8, co8), _zero_pad(inv, ci8),
            _zero_pad(shift, ci8), *(_zero_pad(v, co8) for v in co_side))


def cut_channels(t: Optional[torch.Tensor], *sizes: int
                 ) -> Optional[torch.Tensor]:
    """A padded unit's output cut back: the leading ``sizes`` of its last
    ``len(sizes)`` axes (None stays None)."""
    if t is None:
        return None
    return t[(..., *(slice(0, n) for n in sizes))]


def conv_unit_fwd(x: torch.Tensor, w: torch.Tensor,
                  inv: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None, *, kind: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused (affine + ReLU →) conv → channel sums; returns (y, s1, s2).

    Plain composition on the CPU; on the card one kernel launch (plus a
    fixed-order reduction of its per-block sums): for bf16 activations the
    row walk (spatial, ``spatial_fwd_plan``) or the frame walk (temporal,
    ``temporal_fwd_plan``), for fp32 the fp32 walks
    (``f32_spatial_fwd_plan``, ``f32_temporal_fwd_plan``).
    Channel counts that are not multiples of 8 run zero-padded
    (``pad_channels``)."""
    if x.device.type == "cpu":
        return conv_unit_reference(x, w, inv, shift, kind=kind)
    tensors = (x, w) + ((inv, shift) if inv is not None else ())
    cuda_lib.require_cuda("conv_unit_fwd", *tensors)
    b, t, h, wd, ci = x.shape
    co = w.shape[-1]
    want_w = (3, 3, ci, co) if kind == "spatial" else (3, ci, co)
    if kind not in ("spatial", "temporal") or tuple(w.shape) != want_w \
            or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"conv_unit_fwd kernel takes bf16 or fp32 x [B,T,H,W,Ci] and w "
            f"{want_w}; got kind={kind!r} x {tuple(x.shape)} {x.dtype}, w "
            f"{tuple(w.shape)}")
    if ci % 8 or co % 8:
        y, s1, s2 = conv_unit_fwd(*pad_channels(x, w, inv, shift), kind=kind)
        return cut_channels(y, co), cut_channels(s1, co), cut_channels(s2, co)
    if x.dtype == torch.float32:
        return _conv_unit_fwd_f32(x, w, inv, shift, kind)
    x = x.contiguous()
    taps = 9 if kind == "spatial" else 3
    # [Co, taps·Ci] with k = tap·Ci + ci: the kernel's K-major B operand
    wk = w.to(torch.bfloat16).movedim(-1, 0).reshape(co, taps * ci).contiguous()
    if inv is not None:
        inv = inv.float().contiguous()
        shift = shift.float().contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if kind == "spatial":
        plan = spatial_fwd_plan(b, t, h, wd, ci, co, sms)
        bn, per, rows = plan.n_tile, plan.images_per_range, plan.part_rows
        tiling = (plan.step, int(plan.resident), 0)
    else:
        plan = temporal_fwd_plan(b, t, h, wd, ci, co, sms)
        bn, per, rows = plan.n_tile, plan.units_per_block, plan.part_rows
        tiling = (plan.strip, int(plan.resident), plan.k_chunk)
    y = torch.empty(b, t, h, wd, co, dtype=x.dtype, device=x.device)
    s1 = torch.empty(co, dtype=torch.float32, device=x.device)
    s2 = torch.empty(co, dtype=torch.float32, device=x.device)
    part = torch.empty(2 * rows * co, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = cuda_lib.library("conv_bn").m3f_conv_unit_fwd(
            x.data_ptr(), wk.data_ptr(),
            None if inv is None else inv.data_ptr(),
            None if shift is None else shift.data_ptr(),
            y.data_ptr(), s1.data_ptr(), s2.data_ptr(), part.data_ptr(),
            0 if kind == "spatial" else 1, b, t, h, wd, ci, co, bn, per,
            *tiling, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"conv_unit_fwd {kind} kernel")
    cuda_lib.launches["conv_" + kind] += 1
    return y, s1, s2


# The fp32 spatial forward's per-tap gather (conv_f32_kernel in
# conv_bn_f32.cu; the route of images too wide for the row walk): tiles of
# 64 positions x 64 output channels, a block walking a range of position
# tiles
_F32_BM = 64
_F32_BN = 64
_F32_BLOCKS_PER_SM = 8     # target blocks a multiprocessor (about two waves)


class F32FwdPlan(NamedTuple):
    """How the fp32 forward cuts its work: ``m_tiles`` tiles of 64 of the
    M = B·T·H·W positions, ``n_tiles`` tiles of 64 output channels;
    ``ranges`` of ``tiles_per_range`` consecutive position tiles, one block
    a range and output-channel tile (``blocks``), each range one partial row
    of s1 / s2."""
    m_tiles: int
    n_tiles: int
    tiles_per_range: int
    ranges: int
    blocks: int


def f32_fwd_plan(b: int, t: int, h: int, w: int, co: int,
                 sms: int) -> F32FwdPlan:
    """The fp32 forward's tiling on a card of ``sms`` multiprocessors:
    about _F32_BLOCKS_PER_SM blocks a multiprocessor, at most one a
    position tile."""
    m_tiles = _cdiv(b * t * h * w, _F32_BM)
    n_tiles = _cdiv(co, _F32_BN)
    want = max(1, min(m_tiles, _F32_BLOCKS_PER_SM * sms // n_tiles))
    per = _cdiv(m_tiles, want)
    ranges = _cdiv(m_tiles, per)
    return F32FwdPlan(m_tiles, n_tiles, per, ranges, ranges * n_tiles)


# The fp32 spatial forward's row walk (spatial_fwd_f32_kernel in
# conv_bn_f32.cu): step/8 x n_tile/8 threads, each 8 pixels x 8 output
# channels, take a step of `step` output pixels x `n_tile` output channels,
# K in chunks of `k_chunk` input channels for all nine taps; at most 8 warps
# a block (9 cap a thread's registers at 168), so tiles of 144 take steps of
# 112 (252 threads), tiles of 128 steps of 128 (256)
_SWF_STEPS = {144: 112, 128: 128}   # N tile -> output pixels a step (8·NPG)
_SWF_VMAX = 8              # x vectors a thread copies a chunk (SWF_VMAX)
_SWF_N_TILES = (144, 128)  # output channels a block, preferred on a tie
_SWF_K_CHUNKS = (16, 8)    # input channels a chunk, preferred first


def _spatial_fwd_f32_smem(w: int, rows: int, k_chunk: int, n_tile: int) -> int:
    """A block's shared memory (swf_smem in conv_bn_f32.cu): two x chunk
    buffers of ``rows`` rows of w + 2 pixels at a stride of k_chunk + 4
    floats, two filter chunks [9·k_chunk, n_tile]."""
    return 4 * (2 * rows * (w + 2) * (k_chunk + 4) + 2 * 9 * k_chunk * n_tile)


class F32SpatialFwdPlan(NamedTuple):
    """How the fp32 spatial forward's row walk cuts its work: ranges of
    ``images_per_range`` whole (b, t) images, each walked as one stream of
    output pixels in steps of ``step`` by ``threads`` threads, K in chunks
    of ``k_chunk`` input channels for all nine taps over buffers of
    ``buf_rows`` rows (the rows one step reads); ``n_tiles`` tiles of
    ``n_tile`` output channels (x̂ is formed once per tile and step);
    ``blocks`` = ``ranges`` x ``n_tiles``, each range one partial row of
    s1 / s2 (``part_rows``); ``smem_bytes`` of shared memory a block."""
    step: int
    n_tile: int
    k_chunk: int
    threads: int
    buf_rows: int
    images: int
    images_per_range: int
    ranges: int
    n_tiles: int
    blocks: int
    part_rows: int
    smem_bytes: int

    def images_of(self, r: int) -> range:
        """The images (b * T + t) of range ``r``, as the kernel takes them."""
        return range(r * self.images_per_range,
                     min(self.images, (r + 1) * self.images_per_range))


def f32_spatial_fwd_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                         sms: int, n_tile: Optional[int] = None,
                         k_chunk: Optional[int] = None
                         ) -> Optional[F32SpatialFwdPlan]:
    """The fp32 spatial forward's tiling on a card of ``sms``
    multiprocessors: the N tile of _SWF_N_TILES that pads C_out least (144
    on a tie: every fused width divides by 144 or by 128), then the first
    chunk of _SWF_K_CHUNKS whose step's rows a thread's copies cover and
    whose buffers fit a block's shared memory (else the other N tile); then
    ``sms // n_tiles`` ranges of whole images, at most one per image.
    ``n_tile`` / ``k_chunk`` ask for one layout (the sweep's). None where no
    layout fits: the wrapper then takes the per-tap gather
    (``f32_fwd_plan``)."""
    tiles = sorted(_SWF_N_TILES, key=lambda n: _cdiv(co, n) * n)
    for nb in (n_tile,) if n_tile else tiles:
        step = _SWF_STEPS[nb]
        rows = spatial_ring_rows(h, w, step, 1)
        threads = step // 8 * nb // 8
        for kc in (k_chunk,) if k_chunk else _SWF_K_CHUNKS:
            smem = _spatial_fwd_f32_smem(w, rows, kc, nb)
            if rows * w > _SWF_VMAX * threads // (kc // 4) \
                    or smem > _SMEM_BLOCK_MAX:
                continue
            images = b * t
            n_tiles = _cdiv(co, nb)
            per = _cdiv(images, max(1, min(images, sms // n_tiles)))
            if per * h * w >= 2 ** 31:
                return None
            ranges = _cdiv(images, per)
            return F32SpatialFwdPlan(step, nb, kc, threads, rows, images,
                                     per, ranges, n_tiles, ranges * n_tiles,
                                     ranges, smem)
    return None


# The fp32 temporal forward's frame walk (temporal_fwd_f32_kernel in
# conv_bn_f32.cu): 256 threads, each 4 positions x 8 output channels x 3
# output frames, take a strip of 128 positions x 64 output channels, K in
# chunks of 16 input channels for all three taps
_TWF_NPG = 32              # position groups (TWF_NPG)
_TWF_NCG = 8               # channel groups (TWF_NCG)
_TWF_TILE = (4, 8, 3)      # positions x output channels x output frames a thread
_TWF_STRIP = _TWF_TILE[0] * _TWF_NPG          # positions a strip
_TWF_N_TILE = _TWF_TILE[1] * _TWF_NCG         # output channels a block
_TWF_THREADS = _TWF_NPG * _TWF_NCG
_TWF_K_CHUNK = 16          # input channels a chunk (TWF_KC)


def _temporal_fwd_f32_smem(ci: int, resident: bool) -> int:
    """A block's shared memory (twf_smem in conv_bn_f32.cu): the filter
    (resident [3·C_in in whole chunks, 64], or two streamed chunks [3·16,
    64]) and two x chunk buffers [128, 16 + 4]."""
    cip = _cdiv(ci, _TWF_K_CHUNK) * _TWF_K_CHUNK
    filt = 3 * cip * _TWF_N_TILE if resident \
        else 2 * 3 * _TWF_K_CHUNK * _TWF_N_TILE
    return 4 * (filt + 2 * _TWF_STRIP * (_TWF_K_CHUNK + 4))


class F32TemporalFwdPlan(NamedTuple):
    """How the fp32 temporal forward's frame walk cuts its work: units of
    ``strip`` consecutive positions of the flattened B·H·W axis (a strip
    spans several clips where H·W is small), each walked over T by
    ``threads`` threads, x in chunks of ``k_chunk`` input channels a frame
    formed once into three output-frame accumulators; ``n_tiles`` tiles of
    ``n_tile`` output channels (x̂ is formed once per tile); the filter tile
    ``resident`` in shared memory or streamed with the chunks; ``blocks`` =
    ``ranges`` contiguous ranges of ``units_per_range`` units x ``n_tiles``
    (``_tw_units_per_block``), each range one partial row of s1 / s2
    (``part_rows``); ``smem_bytes`` of shared memory a block;
    ``register_tile`` the sums a thread holds (positions x output channels
    x output frames)."""
    strip: int
    n_tile: int
    k_chunk: int
    threads: int
    register_tile: Tuple[int, int, int]
    resident: bool
    positions: int
    units: int
    units_per_range: int
    ranges: int
    n_tiles: int
    blocks: int
    part_rows: int
    smem_bytes: int

    def units_of(self, r: int) -> range:
        """The units of range ``r``, as the kernel takes them."""
        return range(r * self.units_per_range,
                     min(self.units, (r + 1) * self.units_per_range))

    def positions_of(self, u: int) -> range:
        """The positions b·H·W + p of unit ``u``; the unit walks every
        frame of each."""
        return range(u * self.strip, min(self.positions, (u + 1) * self.strip))


def f32_temporal_fwd_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                          sms: int) -> F32TemporalFwdPlan:
    """The fp32 temporal forward's tiling on a card of ``sms``
    multiprocessors, for every shape: the filter resident where it fits a
    block's shared memory beside the x buffers, else streamed (which always
    fits); ranges of strips by ``_tw_units_per_block`` (one block a SM)."""
    res = _temporal_fwd_f32_smem(ci, True) <= _SMEM_BLOCK_MAX
    positions = b * h * w
    units = _cdiv(positions, _TWF_STRIP)
    n_tiles = _cdiv(co, _TWF_N_TILE)
    per = _tw_units_per_block(units, n_tiles, sms, 1)
    ranges = _cdiv(units, per)
    return F32TemporalFwdPlan(_TWF_STRIP, _TWF_N_TILE, _TWF_K_CHUNK,
                              _TWF_THREADS, _TWF_TILE, res, positions, units,
                              per, ranges, n_tiles, ranges * n_tiles, ranges,
                              _temporal_fwd_f32_smem(ci, res))


def _aligned16(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` contiguous on 16-byte-aligned storage (the kernel's vector
    loads): a copy where its base is off 16 bytes."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _conv_unit_fwd_f32(x, w, inv, shift, kind):
    """The fp32 unit on the card (Ci, Co multiples of 8): one launch of the
    temporal frame walk (temporal_fwd_f32_kernel, ``f32_temporal_fwd_plan``),
    the spatial row walk (spatial_fwd_f32_kernel, ``f32_spatial_fwd_plan``)
    or, where no row-walk layout fits the images, the spatial per-tap gather
    (conv_f32_kernel, ``f32_fwd_plan``), plus the fixed-order sum of its
    partial rows."""
    b, t, h, wd, ci = x.shape
    co = w.shape[-1]
    taps = 9 if kind == "spatial" else 3
    x = _aligned16(x)
    wk = _aligned16(w.float().reshape(taps * ci, co))   # row tap·Ci + ci
    inv = _aligned16(None if inv is None else inv.float())
    shift = _aligned16(None if shift is None else shift.float())
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    frames = walk = gather = None
    if kind == "temporal":
        frames = f32_temporal_fwd_plan(b, t, h, wd, ci, co, sms)
        rows = frames.part_rows
    else:
        walk = f32_spatial_fwd_plan(b, t, h, wd, ci, co, sms)
        gather = f32_fwd_plan(b, t, h, wd, co, sms) if walk is None else None
        rows = walk.part_rows if walk is not None else gather.ranges
    y = torch.empty(b, t, h, wd, co, dtype=torch.float32, device=x.device)
    s1 = torch.empty(co, dtype=torch.float32, device=x.device)
    s2 = torch.empty(co, dtype=torch.float32, device=x.device)
    part = torch.empty(2 * rows * co, dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), wk.data_ptr(),
            None if inv is None else inv.data_ptr(),
            None if shift is None else shift.data_ptr(),
            y.data_ptr(), s1.data_ptr(), s2.data_ptr(), part.data_ptr())
    lib = cuda_lib.library("conv_bn_f32")
    with torch.cuda.device(x.device):
        if frames is not None:
            err = lib.m3f_temporal_fwd_f32(
                *ptrs, b, t, h, wd, ci, co, int(frames.resident),
                frames.units_per_range, cuda_lib.stream_ptr(x))
        elif walk is not None:
            err = lib.m3f_spatial_fwd_f32(
                *ptrs, b, t, h, wd, ci, co, walk.n_tile, walk.k_chunk,
                walk.images_per_range, cuda_lib.stream_ptr(x))
        else:
            err = lib.m3f_conv_unit_fwd_f32(
                *ptrs, b, t, h, wd, ci, co, gather.tiles_per_range,
                cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"conv_unit_fwd {kind} fp32 kernel")
    cuda_lib.launches[f"conv_{kind}_f32"] += 1
    return y, s1, s2


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def _gy_eff(gy: torch.Tensor, y: torch.Tensor, gs1: torch.Tensor,
            gs2: torch.Tensor) -> torch.Tensor:
    """gy + bf16(gs1 + 2·f32(y)·gs2): the sums' cotangents folded into the
    output's, in gy's dtype (two roundings, as the reference)."""
    add = gs1.float() + 2.0 * y.float() * gs2.float()
    return gy + add.to(gy.dtype)


def _prologue(x: torch.Tensor, inv: Optional[torch.Tensor],
              shift: Optional[torch.Tensor]) -> torch.Tensor:
    if inv is None:
        return x
    return torch.clamp_min(x * inv.to(x.dtype) + shift.to(x.dtype), 0)


def _ncdhw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 4, 1, 2, 3)


def conv_unit_bwd_data_reference(x, w, inv, shift, y, gy, gs1, gs2, *,
                                 kind: str):
    """Plain data gradient → (dx, dinv, dshift); dinv, dshift are None
    without the prologue. The transposed conv runs in fp32 on the rounded
    values and dx̂ is rounded to x's dtype once, as the Pallas kernel's
    fp32 accumulator is (the reference's hybrid path rounds in its conv)."""
    dtype = x.dtype
    ge = _gy_eff(gy, y, gs1, gs2).float()
    kernel, pad = _torch_kernel(w.to(dtype).float(), kind)
    # the conv's data gradient is the conv of ge with the flipped, transposed
    # filter at the same padding
    flip = kernel.flip(2, 3, 4).transpose(0, 1)
    with full_fp32():                   # an fp32 conv stays fp32 (no TF32)
        dxh = F.conv3d(_ncdhw(ge), flip, padding=pad).permute(0, 2, 3, 4, 1)
    dxh = dxh.to(dtype)
    if inv is None:
        return dxh, None, None
    xa = x * inv.to(dtype) + shift.to(dtype)
    dxa = torch.where(xa > 0, dxh, torch.zeros_like(dxh))
    axes = tuple(range(x.dim() - 1))
    return (dxa * inv.to(dtype), (x.float() * dxa.float()).sum(axes),
            dxa.float().sum(axes))


def conv_unit_bwd_filter_reference(x, inv, shift, y, gy, gs1, gs2, *,
                                   kind: str) -> torch.Tensor:
    """Plain filter gradient → fp32 dw in the reference layout, from the
    rounded x̂ and ge, accumulated in fp32 (no rounding to the compute
    dtype)."""
    xh = _prologue(x, inv, shift).float()
    ge = _gy_eff(gy, y, gs1, gs2).float()
    ci, co = x.shape[-1], gy.shape[-1]
    ksize, pad = ((1, 3, 3), (0, 1, 1)) if kind == "spatial" \
        else ((3, 1, 1), (1, 0, 0))
    with full_fp32():                   # an fp32 conv stays fp32 (no TF32)
        dk = torch.nn.grad.conv3d_weight(_ncdhw(xh), (co, ci) + ksize,
                                         _ncdhw(ge), padding=pad)  # [Co, Ci, kt, kh, kw]
    if kind == "spatial":
        return dk[:, :, 0].permute(2, 3, 1, 0).contiguous()
    return dk[:, :, :, 0, 0].permute(2, 1, 0).contiguous()


def conv_unit_bwd_reference(x, w, inv, shift, y, gy, gs1, gs2, *, kind: str):
    """Plain backward of the unit → (dx, dw fp32, dinv, dshift)."""
    dx, dinv, dshift = conv_unit_bwd_data_reference(
        x, w, inv, shift, y, gy, gs1, gs2, kind=kind)
    dw = conv_unit_bwd_filter_reference(x, inv, shift, y, gy, gs1, gs2,
                                        kind=kind)
    return dx, dw, dinv, dshift


def _check_unit(name, x, kind, *tensors):
    cuda_lib.require_cuda(name, x, *[t for t in tensors if t is not None])
    if kind not in ("spatial", "temporal") \
            or x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 5:
        raise ValueError(
            f"{name} kernel takes bf16 or fp32 [B,T,H,W,C] tensors; got "
            f"kind={kind!r} x {tuple(x.shape)} {x.dtype}")


_SMEM_BLOCK_MAX = 227 << 10             # a block's shared memory on sm_90

# The spatial forward's row walk (spatial_fwd_kernel in conv_bn.cu): 8 warps
# take a step of `step` output pixels x `n_tile` output channels, K in chunks
# of 16 input channels for all nine taps
_SW_THREADS = 256
_SW_LAYOUTS = ((128, 144), (256, 64))    # (step, N tile), preferred on a tie
_SW_K_CHUNK = 16           # input channels per chunk (SW_KC)
_SW_VMAX = 8               # x vectors a thread copies per chunk (SW_VMAX)
_SW_WM = 4                 # warps along the pixels (SW_WM)


def _spatial_fwd_smem(w: int, ci: int, step: int, n_tile: int, rows: int,
                      resident: bool) -> int:
    """A block's shared memory (spatial_fwd_smem in conv_bn.cu): one region
    for the two x chunk buffers of ``rows`` rows, the y staging and the
    block's sums; the filter tile (resident) or two streamed filter chunks;
    two tap tables; inv / shift."""
    cip = _cdiv(ci, _SW_K_CHUNK) * _SW_K_CHUNK
    bufs = 2 * rows * (w + 2) * (_SW_K_CHUNK + 8) * 2
    stage = step * (n_tile + 8) * 2
    red = 2 * _SW_WM * n_tile * 4
    filt = n_tile * (9 * cip + 8) if resident \
        else 2 * n_tile * (9 * _SW_K_CHUNK + 8)
    return max(bufs, stage, red) + 2 * filt + 24 * step + 4 * cip


class SpatialFwdPlan(NamedTuple):
    """How the spatial forward kernel cuts its work: ranges of
    ``images_per_range`` whole (b, t) images, each walked as one stream of
    output pixels in steps of ``step`` by ``warps`` warps, K in chunks of 16
    input channels for all nine taps over buffers of ``buf_rows`` rows (the
    rows one step reads); ``n_tiles`` tiles of ``n_tile`` output channels
    (x̂ is formed once per tile and step: ``n_tiles`` times per element, a
    step's halo rows once more); the filter tile ``resident`` in shared
    memory or streamed with the chunks; ``blocks`` = ``ranges`` x
    ``n_tiles``, each range one partial row of s1 / s2 (``part_rows``);
    ``smem_bytes`` of shared memory a block."""
    step: int
    n_tile: int
    warps: int
    buf_rows: int
    resident: bool
    images: int
    images_per_range: int
    ranges: int
    n_tiles: int
    blocks: int
    part_rows: int
    smem_bytes: int

    def images_of(self, r: int) -> range:
        """The images (b * T + t) of range ``r``, as the kernel takes them."""
        return range(r * self.images_per_range,
                     min(self.images, (r + 1) * self.images_per_range))


def spatial_fwd_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                     sms: int) -> SpatialFwdPlan:
    """The spatial forward's tiling on a card of ``sms`` multiprocessors: of
    _SW_LAYOUTS whose step's rows a thread's copies cover, the first whose
    buffers fit a block's shared memory with the filter resident, else with
    it streamed, taking on each pass the layout that pads C_out least
    first (the first of _SW_LAYOUTS on a tie); then ``sms // n_tiles``
    ranges of whole images, at most one per image. (At the serving stage 2,
    C_out 288, the resident 64-wide tiles ran 10% faster than streamed
    144-wide ones: PERF.md, PR 10.)"""
    layouts = sorted(_SW_LAYOUTS, key=lambda l: _cdiv(co, l[1]) * l[1])
    for resident in (True, False):
        for step, n_tile in layouts:
            rows = spatial_ring_rows(h, w, step, 1)
            smem = _spatial_fwd_smem(w, ci, step, n_tile, rows, resident)
            if rows * w > _SW_THREADS // 2 * _SW_VMAX \
                    or smem > _SMEM_BLOCK_MAX:
                continue
            images = b * t
            n_tiles = _cdiv(co, n_tile)
            per = _cdiv(images, max(1, min(images, sms // n_tiles)))
            ranges = _cdiv(images, per)
            return SpatialFwdPlan(step, n_tile, _SW_THREADS // 32, rows,
                                  resident, images, per, ranges, n_tiles,
                                  ranges * n_tiles, ranges, smem)
    raise ValueError(
        f"conv_unit_fwd spatial kernel: the rows a step reads, {w} pixels "
        f"each, do not fit a block's copies or shared memory")


# The temporal forward's frame walk (temporal_fwd_kernel in conv_bn.cu):
# warps of 32 x 32 take a strip of `strip` (clip, position) pairs x `n_tile`
# output channels, K in chunks of `k_chunk` input channels for all three taps
_TW_XV = 9                 # x vectors a thread copies a chunk, at most (TW_XV)
_TW_LDY = 40               # a warp's y staging row stride (TW_LDY)
_TW_XS = 2                 # slots of the x (and streamed filter) ring (TW_XS)
# every (strip, N tile) the kernel is built for -> its blocks a SM
_TW_BUILT = {(128, 64): 1, (64, 64): 2}
# (strip, N tile, filter resident), preferred first: two blocks a SM of 64 x
# 64 where the filter and the rings fit half a SM (stage 1: 6% faster than
# one block of 128 x 64 at 128 clips, 4% at 32, timed in turn, PERF.md),
# else one of 128 x 64 with the filter resident, else streamed
_TW_CHOICES = ((64, 64, True), (128, 64, True), (128, 64, False))
_SMEM_SM = 228 << 10       # a multiprocessor's shared memory on sm_90, of
#                            which each block reserves 1 KB


def _temporal_fwd_smem(strip: int, n_tile: int, k_chunk: int, chunks: int,
                       resident: bool) -> int:
    """A block's shared memory (temporal_fwd_smem in conv_bn.cu): the filter
    tile (resident) or a ring of filter chunks, the ring of x chunks, each
    warp's y staging, inv / shift."""
    filt = n_tile * (3 * chunks * k_chunk + 8) if resident \
        else _TW_XS * n_tile * (3 * k_chunk + 8)
    ring = _TW_XS * strip * (k_chunk + 8)
    stage = (strip // 32) * (n_tile // 32) * 32 * _TW_LDY
    return 2 * (filt + ring + stage) + 4 * chunks * k_chunk


def _tw_units_per_block(units: int, n_tiles: int, sms: int,
                        per_sm: int) -> int:
    """Units a range, for ``units`` x ``n_tiles`` blocks of equal work on
    ``sms`` multiprocessors of ``per_sm`` blocks each: the fewest
    unit-times to the last block's end (waves x units a range), on a tie
    the most units a range (each range is a block per N tile, which loads
    its filter tile and writes a partial row). Measured on an H100
    (filter_sweep.py --kind temporal_fwd, PERF.md): stage 4 at 128 clips
    (49 units x 8 N tiles) takes 49 ranges of one unit, 392 blocks in three
    waves, 21% faster than 13 ranges of four (104 blocks, 28 SMs idle,
    four unit-times); at the tie of 32 clips stage 3 (49 units x 4), 25
    ranges of two (100 blocks, one wave) ran 2% faster than 49 of one
    (196 blocks, two waves)."""
    slots = per_sm * sms
    per_wave = max(1, slots // n_tiles)        # ranges a wave holds
    if units <= per_wave:
        return 1
    best = None
    for waves in range(1, _cdiv(units, per_wave) + 1):
        per = _cdiv(units, waves * per_wave)
        key = (_cdiv(_cdiv(units, per) * n_tiles, slots) * per, -per)
        best = min(best or key, key)
    return -best[1]


class TemporalFwdPlan(NamedTuple):
    """How the temporal forward kernel cuts its work: units of ``strip``
    consecutive (clip, position) pairs of the flattened B·H·W axis (a strip
    spans several clips where H·W is small), each walked over T by
    ``warps`` warps, x in ``chunks`` chunks of ``k_chunk`` input channels a
    frame, one in flight; ``n_tiles`` tiles of ``n_tile``
    output channels (x̂ is formed once per tile: ``n_tiles`` times per
    element); the filter tile ``resident`` in shared memory or streamed with
    the chunks; ``blocks`` = ``ranges`` contiguous ranges of
    ``units_per_block`` units x ``n_tiles`` (``_tw_units_per_block``),
    each range one partial row of s1 / s2 (``part_rows``); ``smem_bytes`` of
    shared memory a block."""
    strip: int
    n_tile: int
    warps: int
    resident: bool
    k_chunk: int
    chunks: int
    positions: int
    units: int
    units_per_block: int
    ranges: int
    n_tiles: int
    blocks: int
    part_rows: int
    smem_bytes: int

    def units_of(self, r: int) -> range:
        """The units of range ``r``, as the kernel takes them."""
        return range(r * self.units_per_block,
                     min(self.units, (r + 1) * self.units_per_block))

    def positions_of(self, u: int) -> range:
        """The (clip, position) pairs b·H·W + p of unit ``u``; the unit
        walks every frame of each."""
        return range(u * self.strip, min(self.positions, (u + 1) * self.strip))


def temporal_fwd_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                      sms: int, layout: Optional[Tuple[int, int, bool]] = None
                      ) -> TemporalFwdPlan:
    """The temporal forward's tiling on a card of ``sms`` multiprocessors:
    the first of _TW_CHOICES with a chunking that fits a block's share of
    shared memory (_TW_BUILT: blocks a SM), the fewest chunks a frame (a
    thread copies at most _TW_XV x vectors a chunk); then the ranges of
    units (``_tw_units_per_block``). ``layout`` = (strip, N tile, resident)
    asks for one of _TW_BUILT (the sweep's)."""
    if layout and tuple(layout[:2]) not in _TW_BUILT:
        raise ValueError(f"conv_unit_fwd temporal kernel: no layout {layout}")
    cip = _cdiv(ci, 16) * 16
    for strip, n_tile, resident in [layout] if layout else _TW_CHOICES:
        per_sm = _TW_BUILT[(strip, n_tile)]
        threads = strip * n_tile // 32
        smem_max = min(_SMEM_BLOCK_MAX, _SMEM_SM // per_sm - 1024)
        kc_max = _TW_XV * threads * 8 // strip // 16 * 16
        for chunks in range(_cdiv(cip, kc_max), cip // 16 + 1):
            kc = _cdiv(_cdiv(cip, chunks), 16) * 16
            if _cdiv(ci, kc) != chunks:
                continue
            smem = _temporal_fwd_smem(strip, n_tile, kc, chunks, resident)
            if smem > smem_max:
                continue
            positions = b * h * w
            units = _cdiv(positions, strip)
            n_tiles = _cdiv(co, n_tile)
            per = _tw_units_per_block(units, n_tiles, sms, per_sm)
            ranges = _cdiv(units, per)
            return TemporalFwdPlan(strip, n_tile, threads // 32, resident,
                                   kc, chunks, positions, units, per, ranges,
                                   n_tiles, ranges * n_tiles, ranges, smem)
    raise ValueError(
        f"conv_unit_fwd temporal kernel: no chunk of {ci} input channels "
        f"fits a block's shared memory beside {co} output channels"
        + (f" in layout {layout}" if layout else ""))


# The temporal data gradient's frame walk (temporal_data_kernel in
# conv_bn.cu): a block of `warps` warps takes `strip` positions x _TD_N_TILE
# input channels per frame
_TD_N_TILE = 144           # input channels per block (every layout's NB)
_TD_LAYOUTS = {64: 8, 32: 6, 16: 6}      # strip -> warps
_TD_K_CHUNK = 64           # output channels per streamed filter chunk (TD_KC)
_TD_W_STAGES = 3           # slots of the streamed filter's ring (TD_WST)
# (strip, filter resident), preferred first: the widest strip that keeps the
# filter in shared memory (C_out up to 96, then 144), then the widest that
# streams it (up to 336, then 752)
_TD_CHOICES = ((64, True), (32, True), (32, False), (16, False))


def _temporal_data_smem(strip: int, co: int, resident: bool, ahead: int) -> int:
    """A block's shared memory (temporal_data_smem in conv_bn.cu): the filter
    tile or its ring, the gy, y and x rings, gs1 / gs2 / inv / shift."""
    cop = _cdiv(co, 16) * 16
    nb = _TD_N_TILE
    filt = nb * (3 * cop + 8) if resident \
        else _TD_W_STAGES * nb * (_TD_K_CHUNK + 8)
    rings = (2 * ahead + 4) * strip * (cop + 8) + (ahead + 2) * strip * (nb + 8)
    return 2 * (filt + rings) + 8 * cop + 4 * nb


class TemporalDataPlan(NamedTuple):
    """How the temporal data-gradient kernel cuts its work: units of one clip
    x one strip of ``strip`` positions, walked over T by ``warps`` warps;
    ``n_tiles`` tiles of ``n_tile`` input channels (ge is formed once per
    tile: ``n_tiles`` times per element); the block's filter tile
    ``resident`` in shared memory or streamed from the L2; ``ahead`` frames
    in flight; ``blocks`` = ``ranges`` contiguous ranges of
    ``units_per_block`` units x ``n_tiles``, one block a multiprocessor,
    each range one partial row of dinv / dshift (``part_rows``);
    ``smem_bytes`` of shared memory a block."""
    strip: int
    n_tile: int
    warps: int
    resident: bool
    ahead: int
    units: int
    units_per_block: int
    ranges: int
    n_tiles: int
    blocks: int
    part_rows: int
    smem_bytes: int

    def units_of(self, r: int) -> range:
        """The units of range ``r`` (unit u is clip u // strips, strip
        u % strips), as the kernel takes them."""
        return range(r * self.units_per_block,
                     min(self.units, (r + 1) * self.units_per_block))


def temporal_data_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                       sms: int) -> TemporalDataPlan:
    """The temporal data gradient's tiling on a card of ``sms``
    multiprocessors: the first of _TD_CHOICES whose rings (two frames ahead,
    else one) fit a block's shared memory, then ``sms // n_tiles`` ranges of
    units, at most one per unit."""
    n_tiles = _cdiv(ci, _TD_N_TILE)
    for strip, resident in _TD_CHOICES:
        for ahead in ((2, 1) if resident else (1,)):
            smem = _temporal_data_smem(strip, co, resident, ahead)
            if smem > _SMEM_BLOCK_MAX:
                continue
            units = b * _cdiv(h * w, strip)
            per = _cdiv(units, max(1, min(units, sms // n_tiles)))
            ranges = _cdiv(units, per)
            return TemporalDataPlan(strip, _TD_N_TILE, _TD_LAYOUTS[strip],
                                    resident, ahead, units, per, ranges,
                                    n_tiles, ranges * n_tiles, ranges, smem)
    raise ValueError(
        f"conv_unit_bwd_data temporal kernel: frame tiles of {co} output "
        f"channels do not fit a block's shared memory ({smem} B)")


# The spatial data gradient's row walk (spatial_data_kernel in conv_bn.cu):
# 8 warps take a step of `step` output pixels x 64 input channels, K in
# chunks of 16 output channels for all nine taps
_SD_THREADS = 256
_SD_N_TILE = 64            # input channels per block
_SD_STEPS = (256, 128)     # output pixels per step, preferred first
_SD_K_CHUNK = 16           # output channels per chunk (SD_KC)
_SD_VMAX = 8               # gy vectors a thread copies per chunk (SD_VMAX)


def _spatial_data_smem(w: int, co: int, step: int, rows: int) -> int:
    """A block's shared memory (spatial_data_smem in conv_bn.cu): two ge and
    one y chunk buffer of ``rows`` rows, two filter chunks, the x / dx tile,
    two tap tables, gs1 / gs2, inv / shift."""
    cop = _cdiv(co, _SD_K_CHUNK) * _SD_K_CHUNK
    buf = rows * (w + 2) * (_SD_K_CHUNK + 8)
    filt = _SD_N_TILE * (9 * _SD_K_CHUNK + 8)
    return (2 * (3 * buf + 2 * filt + step * (_SD_N_TILE + 8)) + 24 * step
            + 8 * cop + 4 * _SD_N_TILE)


class SpatialDataPlan(NamedTuple):
    """How the spatial data-gradient kernel cuts its work: ranges of
    ``images_per_range`` whole (b, t) images, each walked as one stream of
    output pixels in steps of ``step`` by ``warps`` warps, K in chunks of 16
    output channels for all nine taps over buffers of ``buf_rows`` rows (the
    rows one step reads); ``n_tiles`` tiles of ``n_tile`` input channels (ge
    is formed once per tile); ``blocks`` = ``ranges`` x ``n_tiles``, each
    range one partial row of dinv / dshift (``part_rows``); ``smem_bytes``
    of shared memory a block."""
    step: int
    n_tile: int
    warps: int
    buf_rows: int
    images: int
    images_per_range: int
    ranges: int
    n_tiles: int
    blocks: int
    part_rows: int
    smem_bytes: int

    def images_of(self, r: int) -> range:
        """The images (b * T + t) of range ``r``, as the kernel takes them."""
        return range(r * self.images_per_range,
                     min(self.images, (r + 1) * self.images_per_range))


def spatial_data_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                      sms: int) -> SpatialDataPlan:
    """The spatial data gradient's tiling on a card of ``sms``
    multiprocessors: the widest of _SD_STEPS whose buffers fit a block's
    shared memory and whose rows a thread's _SD_VMAX copies a chunk cover,
    then ``sms // n_tiles`` ranges of whole images, at most one per image."""
    smem = rows = None
    for step in _SD_STEPS:
        rows = spatial_ring_rows(h, w, step, 1)
        smem = _spatial_data_smem(w, co, step, rows)
        if smem <= _SMEM_BLOCK_MAX and rows * w <= _SD_THREADS // 2 * _SD_VMAX:
            break
    else:
        raise ValueError(
            f"conv_unit_bwd_data spatial kernel: {rows} rows of {w} pixels do "
            f"not fit a block's copies or shared memory ({smem} B)")
    images = b * t
    n_tiles = _cdiv(ci, _SD_N_TILE)
    per = _cdiv(images, max(1, min(images, sms // n_tiles)))
    ranges = _cdiv(images, per)
    return SpatialDataPlan(step, _SD_N_TILE, _SD_THREADS // 32, rows, images,
                           per, ranges, n_tiles, ranges * n_tiles, ranges,
                           smem)


def conv_unit_bwd_data(x, w, inv, shift, y, gy, gs1, gs2, *, kind: str):
    """Data gradient of the unit → (dx, dinv, dshift): the plain version on
    the CPU, one kernel launch (plus a fixed-order sum of its per-block
    dinv/dshift rows) on the card: for bf16 the row walk (spatial) or the
    frame walk (temporal), for fp32 the fp32 data gradient
    (``_conv_unit_bwd_data_f32``); channel counts that are not multiples of 8 run
    zero-padded (``pad_channels``)."""
    if x.device.type == "cpu":
        return conv_unit_bwd_data_reference(x, w, inv, shift, y, gy, gs1, gs2,
                                            kind=kind)
    b, t, h, wdt, ci = x.shape
    co = gy.shape[-1]
    _check_unit("conv_unit_bwd_data", x, kind, w, inv, shift, y, gy, gs1, gs2)
    want_w = (3, 3, ci, co) if kind == "spatial" else (3, ci, co)
    if tuple(w.shape) != want_w or tuple(y.shape) != tuple(gy.shape) \
            or tuple(gy.shape[:-1]) != (b, t, h, wdt) \
            or y.dtype != x.dtype or gy.dtype != x.dtype:
        raise ValueError(f"conv_unit_bwd_data: w {tuple(w.shape)} (want "
                         f"{want_w}), y {tuple(y.shape)} {y.dtype}, gy "
                         f"{tuple(gy.shape)} {gy.dtype}")
    if ci % 8 or co % 8:
        dx, dinv, dshift = conv_unit_bwd_data(
            *pad_channels(x, w, inv, shift, y, gy, gs1, gs2), kind=kind)
        return (cut_channels(dx, ci), cut_channels(dinv, ci),
                cut_channels(dshift, ci))
    if x.dtype == torch.float32:
        return _conv_unit_bwd_data_f32(x, w, inv, shift, y, gy, gs1, gs2, kind)
    x, y, gy = x.contiguous(), y.contiguous(), gy.contiguous()
    gs1, gs2 = gs1.float().contiguous(), gs2.float().contiguous()
    affine = inv is not None
    if affine:
        inv, shift = inv.float().contiguous(), shift.float().contiguous()
    wf = w.to(torch.bfloat16).contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if kind == "spatial":
        # [Ci, 9·Co] with flipped taps: wf[ci, tap·Co + co] = W[mirror(tap), ci, co]
        wf = wf.flip((0, 1)).movedim(-2, 0).reshape(ci, 9 * co).contiguous()
        plan = spatial_data_plan(b, t, h, wdt, ci, co, sms)
        bn, per, rows = plan.n_tile, plan.images_per_range, plan.part_rows
        tiling = (plan.step, plan.warps, 0, 0)
    else:
        # the temporal kernel reads the filter as it is and flips the taps
        plan = temporal_data_plan(b, t, h, wdt, ci, co, sms)
        bn, per, rows = plan.n_tile, plan.units_per_block, plan.part_rows
        tiling = (plan.strip, plan.warps, int(plan.resident), plan.ahead)
    dx = torch.empty_like(x)
    dinv = dshift = part = None
    if affine:
        dinv = torch.empty(ci, dtype=torch.float32, device=x.device)
        dshift = torch.empty(ci, dtype=torch.float32, device=x.device)
        part = torch.empty(2 * rows * ci, dtype=torch.float32, device=x.device)
    ptr = lambda v: None if v is None else v.data_ptr()
    with torch.cuda.device(x.device):
        err = cuda_lib.library("conv_bn").m3f_conv_unit_bwd_data(
            gy.data_ptr(), y.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
            wf.data_ptr(), x.data_ptr() if affine else None, ptr(inv),
            ptr(shift), dx.data_ptr(), ptr(dinv), ptr(dshift), ptr(part),
            0 if kind == "spatial" else 1, b, t, h, wdt, ci, co, bn, per,
            *tiling, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"conv_unit_bwd_data {kind} kernel")
    cuda_lib.launches[f"conv_{kind}_bwd_data"] += 1
    return dx, dinv, dshift


# fp32 partial-slice buffer of the filter gradient, at most this many bytes
_FILTER_PART_BYTES = 64 << 20


_TEMPORAL_STRIP = 64       # positions of H·W per strip (TF_S in conv_bn.cu)
_TEMPORAL_CO_TILE = 64     # output channels per block (TF_CO)
_TEMPORAL_CI_BLOCKS = (64, 48)   # channel blocks, preferred first on a tie


class TemporalFilterPlan(NamedTuple):
    """How the temporal filter-gradient kernel cuts its work: units of one
    clip × one strip of ``strip`` positions, walked over T; blocks of
    ``ci_blk`` input × ``co_tile`` output channels; ``slices`` contiguous
    ranges of ``units_per_slice`` units, one fp32 partial each
    (``part_bytes``, 0 when one slice writes dw itself)."""
    strip: int
    ci_blk: int
    co_tile: int
    units: int
    units_per_slice: int
    slices: int
    part_bytes: int

    def units_of(self, s: int) -> range:
        """The units of slice ``s`` (unit u is clip u // strips, strip
        u % strips), as the kernel takes them."""
        return range(s * self.units_per_slice,
                     min(self.units, (s + 1) * self.units_per_slice))


def temporal_filter_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                         sms: int) -> TemporalFilterPlan:
    """The temporal filter gradient's tiling on a card of ``sms``
    multiprocessors: the channel block that pads C_in least, then enough
    slices for ~4 waves of blocks, at most one per unit, with a partial
    buffer of at most _FILTER_PART_BYTES."""
    strip = _TEMPORAL_STRIP
    units = b * _cdiv(h * w, strip)
    ci_blk = min(_TEMPORAL_CI_BLOCKS, key=lambda cb: _cdiv(ci, cb) * cb)
    tiles = _cdiv(ci, ci_blk) * _cdiv(co, _TEMPORAL_CO_TILE)
    out_bytes = 4 * 3 * ci * co
    s = max(1, min(units, _cdiv(4 * sms, tiles),
                   _FILTER_PART_BYTES // out_bytes))
    per = _cdiv(units, s)
    slices = _cdiv(units, per)
    # the kernel cuts the units by ceil(units / slices), which gives no
    # empty slice for these slices
    per = _cdiv(units, slices)
    return TemporalFilterPlan(strip, ci_blk, _TEMPORAL_CO_TILE, units, per,
                              slices, slices * out_bytes if slices > 1 else 0)


# The spatial filter gradient's row walk (spatial_filter_kernel in conv_bn.cu):
# a block of ci_blk / 8 warps, each 8 input channels x the tile's output
# channels x nine taps
_SPATIAL_TILES = ((64, 48), (32, 48))   # (channel block, output-channel tile)
_SPATIAL_STEPS = (112, 64, 48, 32, 16)  # output pixels per step, preferred first
_SPATIAL_AHEAD = 3         # steps copied ahead of the products (SF_AHEAD)


def spatial_ring_rows(h: int, w: int, step: int,
                      steps: int = _SPATIAL_AHEAD + 1) -> int:
    """Rows of a row walk's ring (spatial_ring_rows in conv_bn.cu): the image
    rows under ``steps`` steps of ``step`` pixels at the worst alignment, the
    zero rows between the images they touch, and the halo row above and
    below. The filter gradient's x ring holds _SPATIAL_AHEAD + 1 steps."""
    span = steps * step
    dr = (span + w - 2) // w
    return dr + _cdiv(dr, h) + 3


def _spatial_smem(w: int, ci_blk: int, co_tile: int, step: int,
                  rows: int) -> int:
    stages = _SPATIAL_AHEAD + 1
    return (2 * (rows * (w + 2) * (ci_blk + 8)
                 + 2 * stages * step * (co_tile + 8))
            + 4 * stages * 3 * step + 8 * co_tile + 4 * ci_blk)


class SpatialFilterPlan(NamedTuple):
    """How the spatial filter-gradient kernel cuts its work: units of one
    (b, t) image, walked as one stream of output pixels in steps of ``step``
    over a ring of ``ring_rows`` x rows; blocks of ``ci_blk`` input x
    ``co_tile`` output channels for all nine taps (``acc_regs`` fp32
    accumulators a thread, ``threads`` threads, ``smem_bytes`` of shared
    memory: one block a multiprocessor at the train shapes); ``slices``
    contiguous ranges of ``units_per_slice`` images, one fp32 partial each (``part_bytes``, 0 when one slice writes dw itself)."""
    step: int
    ring_rows: int
    ci_blk: int
    co_tile: int
    units: int
    units_per_slice: int
    slices: int
    part_bytes: int
    smem_bytes: int
    threads: int
    acc_regs: int

    def units_of(self, s: int) -> range:
        """The images (b * T + t) of slice ``s``, as the kernel takes them."""
        return range(s * self.units_per_slice,
                     min(self.units, (s + 1) * self.units_per_slice))


def spatial_filter_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                        sms: int) -> SpatialFilterPlan:
    """The spatial filter gradient's tiling on a card of ``sms``
    multiprocessors: the channel tile that pads C_in x C_out least, the
    longest step whose rings fit a block's shared memory, then enough
    slices for ~4 waves of blocks, at most one per image, with a partial
    buffer of at most _FILTER_PART_BYTES."""
    ci_blk, co_tile = min(
        _SPATIAL_TILES,
        key=lambda cbt: _cdiv(ci, cbt[0]) * cbt[0] * _cdiv(co, cbt[1]) * cbt[1])
    threads = 4 * ci_blk
    for step in _SPATIAL_STEPS:
        rows = spatial_ring_rows(h, w, step)
        smem = _spatial_smem(w, ci_blk, co_tile, step, rows)
        if smem <= _SMEM_BLOCK_MAX and step <= threads:
            break
    else:
        raise ValueError(
            f"conv_unit_bwd_filter spatial kernel: an image row of {w} pixels "
            f"does not fit the x ring in a block's shared memory ({smem} B)")
    units = b * t
    tiles = _cdiv(ci, ci_blk) * _cdiv(co, co_tile)
    out_bytes = 4 * 9 * ci * co
    s = max(1, min(units, _cdiv(4 * sms, tiles),
                   _FILTER_PART_BYTES // out_bytes))
    # the kernel cuts the images by ceil(units / slices): no slice is empty
    slices = _cdiv(units, _cdiv(units, s))
    per = _cdiv(units, slices)
    return SpatialFilterPlan(step, rows, ci_blk, co_tile, units, per, slices,
                             slices * out_bytes if slices > 1 else 0, smem,
                             threads, 9 * (co_tile // 16) * 4)


def conv_unit_bwd_filter(x, inv, shift, y, gy, gs1, gs2, *, kind: str
                         ) -> torch.Tensor:
    """Filter gradient of the unit → fp32 dw in the reference layout: the
    plain version on the CPU, one kernel launch (plus a fixed-order sum of
    its slices' partials when there is more than one) on the card, for fp32
    x the fp32 filter gradient (``f32_bwd_filter_plan``); channel counts
    that are not multiples of 8 run zero-padded (``pad_channels``)."""
    if x.device.type == "cpu":
        return conv_unit_bwd_filter_reference(x, inv, shift, y, gy, gs1, gs2,
                                              kind=kind)
    b, t, h, wdt, ci = x.shape
    co = gy.shape[-1]
    _check_unit("conv_unit_bwd_filter", x, kind, inv, shift, y, gy, gs1, gs2)
    if tuple(y.shape) != tuple(gy.shape) or tuple(gy.shape[:-1]) != (b, t, h, wdt) \
            or y.dtype != x.dtype or gy.dtype != x.dtype:
        raise ValueError(f"conv_unit_bwd_filter: y {tuple(y.shape)} {y.dtype}, "
                         f"gy {tuple(gy.shape)} {gy.dtype}, x {tuple(x.shape)}")
    if ci % 8 or co % 8:
        xp, _, invp, shiftp, *rest = pad_channels(x, None, inv, shift, y, gy,
                                                  gs1, gs2)
        return cut_channels(conv_unit_bwd_filter(xp, invp, shiftp, *rest,
                                                 kind=kind), ci, co)
    if x.dtype == torch.float32:
        return _conv_unit_bwd_filter_f32(x, inv, shift, y, gy, gs1, gs2, kind)
    x, y, gy = x.contiguous(), y.contiguous(), gy.contiguous()
    gs1, gs2 = gs1.float().contiguous(), gs2.float().contiguous()
    if inv is not None:
        inv, shift = inv.float().contiguous(), shift.float().contiguous()
    taps = 9 if kind == "spatial" else 3
    k = taps * ci
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if kind == "spatial":
        plan = spatial_filter_plan(b, t, h, wdt, ci, co, sms)
        strip = plan.step
    else:
        plan = temporal_filter_plan(b, t, h, wdt, ci, co, sms)
        strip = plan.strip
    bn, ci_blk, slices = plan.co_tile, plan.ci_blk, plan.slices
    dw = torch.empty(k, co, dtype=torch.float32, device=x.device)
    part = torch.empty(slices * k * co, dtype=torch.float32, device=x.device) \
        if slices > 1 else None
    ptr = lambda v: None if v is None else v.data_ptr()
    with torch.cuda.device(x.device):
        err = cuda_lib.library("conv_bn").m3f_conv_unit_bwd_filter(
            x.data_ptr(), gy.data_ptr(), y.data_ptr(), gs1.data_ptr(),
            gs2.data_ptr(), ptr(inv), ptr(shift), dw.data_ptr(), ptr(part),
            0 if kind == "spatial" else 1, b, t, h, wdt, ci, co, bn, slices,
            ci_blk, strip, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"conv_unit_bwd_filter {kind} kernel")
    cuda_lib.launches[f"conv_{kind}_bwd_filter"] += 1
    return dw.reshape((3, 3, ci, co) if kind == "spatial" else (3, ci, co))


# The fp32 backward's per-tap gathers (bwd_data_f32_kernel, the spatial
# kind's images too wide for the row walk, and bwd_filter_f32_kernel in
# conv_bn_f32.cu): the data gradient tiles as the fp32 forward does, its N
# the input channels; the filter gradient takes tiles of 64 rows of
# K = taps·C_in x 64 output channels over slices of the positions, walked in
# chunks of 16
_F32_KC = 16


def f32_bwd_data_plan(b: int, t: int, h: int, w: int, ci: int,
                      sms: int) -> F32FwdPlan:
    """The fp32 data gradient's tiling: the forward's (``f32_fwd_plan``)
    with the C_in input channels of dx as its N; each range of position
    tiles writes one partial row of dinv / dshift."""
    return f32_fwd_plan(b, t, h, w, ci, sms)


class F32FilterPlan(NamedTuple):
    """How the fp32 filter gradient cuts its work: ``k_tiles`` tiles of 64
    of the K = taps·C_in rows of dw, ``n_tiles`` tiles of 64 output
    channels; the M = B·T·H·W positions in ``chunks`` chunks of 16, cut into
    ``slices`` contiguous ranges of ``chunks_per_slice`` chunks, one block a
    slice and tile (``blocks``), each slice one fp32 partial of dw
    (``part_bytes``, 0 when one slice writes dw itself)."""
    k_tiles: int
    n_tiles: int
    chunks: int
    chunks_per_slice: int
    slices: int
    blocks: int
    part_bytes: int

    def positions_of(self, s: int, m: int) -> range:
        """The positions of slice ``s`` of ``m``, as the kernel takes them."""
        c = self.chunks_per_slice * _F32_KC
        return range(min(m, s * c), min(m, (s + 1) * c))


def f32_bwd_filter_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                        kind: str, sms: int) -> F32FilterPlan:
    """The fp32 filter gradient's tiling on a card of ``sms``
    multiprocessors: enough slices for about _F32_BLOCKS_PER_SM blocks a
    multiprocessor, at most one a chunk, with a partial buffer of at most
    _FILTER_PART_BYTES; no slice is empty."""
    k = (9 if kind == "spatial" else 3) * ci
    k_tiles, n_tiles = _cdiv(k, _F32_BM), _cdiv(co, _F32_BN)
    chunks = _cdiv(b * t * h * w, _F32_KC)
    out_bytes = 4 * k * co
    s = max(1, min(chunks, _cdiv(_F32_BLOCKS_PER_SM * sms, k_tiles * n_tiles),
                   _FILTER_PART_BYTES // out_bytes))
    per = max(1, _cdiv(chunks, s))
    slices = max(1, _cdiv(chunks, per))
    return F32FilterPlan(k_tiles, n_tiles, chunks, per, slices,
                         k_tiles * n_tiles * slices,
                         slices * out_bytes if slices > 1 else 0)


# The fp32 spatial filter gradient's row walk (spatial_filter_f32_kernel in
# conv_bn_f32.cu): 3 x 16/4 x n_tile/8 consumer threads, thread (dh, cg, ng)
# holding the three dw taps of row dh x 4 input channels x 8 output
# channels, and one producer warp take [9·16, n_tile] of dw over a slice of
# whole images, walked in steps of `step` output pixels, two in flight
# (multiplied, and copied and formed) over a ring of x̂ rows that holds
# them; ge is folded once before the walk
_SFF_CB = 16               # input channels a block (SFF_CB)
_SFF_BUF = 2               # steps in flight
_SFF_TILE = (3, 4, 8)      # taps x input channels x output channels a thread
_SFF_N_TILES = (144, 128)  # output channels a block, preferred on a tie
_SFF_STEPS = (128, 64, 32)  # output pixels a step, preferred first


def _spatial_filter_f32_smem(w: int, rows: int, step: int, n_tile: int) -> int:
    """A block's shared memory (sff_smem in conv_bn_f32.cu): the x̂ ring of
    ``rows`` rows of w + 2 pixels at a stride of 16 + 4 floats, _SFF_BUF ge
    buffers [step, n_tile + 4] and _SFF_BUF tables [3, step] of ints."""
    return (4 * (rows * (w + 2) * (_SFF_CB + 4)
                 + _SFF_BUF * step * (n_tile + 4))
            + 4 * _SFF_BUF * 3 * step)


class F32SpatialFilterPlan(NamedTuple):
    """How the fp32 spatial filter gradient's row walk cuts its work:
    blocks of ``ci_blk`` input x ``n_tile`` output channels for all nine
    taps (``threads`` threads: consumers, each ``register_tile`` = taps x
    input channels x output channels of sums, and a producer warp),
    ``ci_blocks`` x ``n_tiles`` of them; ``slices`` contiguous ranges of
    ``images_per_slice`` whole (b, t) images, each walked as one stream of
    output pixels in steps of ``step`` over a ring of ``ring_rows`` x̂
    rows; ``blocks`` = slices x channel blocks x N tiles, each slice one
    fp32 partial of dw (``part_bytes``, 0 when one slice writes dw itself);
    ``smem_bytes`` of shared memory a block; ge folded once before the walk
    into a scratch of ``ge_bytes``."""
    step: int
    n_tile: int
    ci_blk: int
    threads: int
    register_tile: Tuple[int, int, int]
    ring_rows: int
    images: int
    images_per_slice: int
    slices: int
    ci_blocks: int
    n_tiles: int
    blocks: int
    part_bytes: int
    smem_bytes: int
    ge_bytes: int

    def images_of(self, s: int) -> range:
        """The images (b * T + t) of slice ``s``, as the kernel takes them."""
        return range(s * self.images_per_slice,
                     min(self.images, (s + 1) * self.images_per_slice))


def f32_spatial_filter_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                            sms: int, n_tile: Optional[int] = None,
                            step: Optional[int] = None
                            ) -> Optional[F32SpatialFilterPlan]:
    """The fp32 spatial filter gradient's tiling on a card of ``sms``
    multiprocessors: the N tile of _SFF_N_TILES that pads C_out least (144
    on a tie), the first step of _SFF_STEPS whose buffers fit a block's
    shared memory (else the other N tile); then ``sms // tiles`` slices of
    whole images (one wave of blocks), at most one per image, with a partial
    buffer of at most _FILTER_PART_BYTES. ``n_tile`` / ``step`` ask for
    one layout (the sweep's). None where no layout fits: the wrapper then
    takes the per-tap gather (``f32_bwd_filter_plan``)."""
    tiles = sorted(_SFF_N_TILES, key=lambda n: _cdiv(co, n) * n)
    for nb in (n_tile,) if n_tile else tiles:
        consumers = 3 * (_SFF_CB // 4) * (nb // 8)
        threads = (_cdiv(consumers, 32) + 1) * 32
        for st in (step,) if step else _SFF_STEPS:
            rows = spatial_ring_rows(h, w, st, _SFF_BUF)
            smem = _spatial_filter_f32_smem(w, rows, st, nb)
            if smem > _SMEM_BLOCK_MAX:
                continue
            images = b * t
            ci_blocks, n_tiles = _cdiv(ci, _SFF_CB), _cdiv(co, nb)
            out_bytes = 4 * 9 * ci * co
            want = max(1, min(images, sms // (ci_blocks * n_tiles),
                              _FILTER_PART_BYTES // out_bytes))
            per = max(1, _cdiv(images, want))
            if per * h * w >= 2 ** 31:
                return None
            slices = max(1, _cdiv(images, per))
            return F32SpatialFilterPlan(
                st, nb, _SFF_CB, threads, _SFF_TILE, rows, images, per,
                slices, ci_blocks, n_tiles, slices * ci_blocks * n_tiles,
                slices * out_bytes if slices > 1 else 0, smem,
                4 * images * h * w * co)
    return None


# The fp32 spatial data gradient's row walk (spatial_data_f32_kernel in
# conv_bn_f32.cu): step/8 x n_tile/8 threads, each 8 pixels x 8 input
# channels, take a step of `step` output pixels x `n_tile` input channels,
# K in chunks of `k_chunk` output channels for all nine taps, ge folded in
# place once per staged pixel; at most 8 warps a block, so tiles of 64 take
# steps of 256, tiles of 128 steps of 128 (256 threads both). The ranges of
# images and the K splits are chosen by a model of the walk's time: one
# chunk of a full step (2·9·k_chunk·step·n_tile FLOP) at the rate a SM
# reached in this walk for its N tile (measured, PERF.md §6: tiles of 64
# read B in one shared-memory wavefront a load, tiles of 128 in two), and a
# split's extra traffic (its partial dx̂ written and read) at _SDF_SPLIT_BPS
# plus its second launch (_SDF_SPLIT_US)
_SDF_STEPS = {64: 256, 128: 128}    # N tile -> output pixels a step (8·NPG)
_SDF_N_TILES = (64, 128)   # input channels a block, preferred on a tie
_SDF_K_CHUNKS = (16, 8)    # output channels a chunk, preferred first
_SDF_SUM_ROWS = 64         # positions a block of the split sum (SDF_SUM_ROWS)
_SDF_SM_FLOPS = {64: 0.315e12, 128: 0.285e12}   # fp32 FFMA rate of a SM
_SDF_SPLIT_BPS = 2.5e12    # the card's memory rate on the split's partials
_SDF_SPLIT_US = 10.0       # the split sum's launch and its sums' colsum


def _spatial_data_f32_smem(w: int, rows: int, k_chunk: int, n_tile: int) -> int:
    """A block's shared memory (sdf_smem in conv_bn_f32.cu): two gy / ge
    chunk buffers and one y buffer of ``rows`` rows of w + 2 pixels at a
    stride of k_chunk + 4 floats, two filter chunks [9·k_chunk, n_tile]."""
    return 4 * (3 * rows * (w + 2) * (k_chunk + 4) + 2 * 9 * k_chunk * n_tile)


class F32SpatialDataPlan(NamedTuple):
    """How the fp32 spatial data gradient's row walk cuts its work: ranges
    of ``images_per_range`` whole (b, t) images, each walked as one stream
    of output pixels in steps of ``step`` by ``threads`` threads, K in
    ``chunks`` chunks of ``k_chunk`` output channels for all nine taps over
    buffers of ``buf_rows`` rows (the rows one step reads), cut into
    ``k_splits`` splits of ``chunks_per_split``; ``n_tiles`` tiles of
    ``n_tile`` input channels (ge is formed once per tile and step);
    ``blocks`` = ranges x splits x N tiles, one wave. With one split each
    range writes one partial row of dinv / dshift; with more each split
    writes a partial dx̂ [M, C_in] (``part_bytes``) and a second pass sums
    them in split order, one partial row per _SDF_SUM_ROWS positions
    (``part_rows`` either way); ``smem_bytes`` of shared memory a block;
    ``model_us`` the modelled time of the launch."""
    step: int
    n_tile: int
    k_chunk: int
    threads: int
    buf_rows: int
    images: int
    images_per_range: int
    ranges: int
    n_tiles: int
    chunks: int
    k_splits: int
    chunks_per_split: int
    blocks: int
    part_rows: int
    part_bytes: int
    smem_bytes: int
    model_us: float

    def images_of(self, r: int) -> range:
        """The images (b * T + t) of range ``r``, as the kernel takes them."""
        return range(r * self.images_per_range,
                     min(self.images, (r + 1) * self.images_per_range))

    def chunks_of(self, s: int) -> range:
        """The chunks of K split ``s``, as the kernel takes them."""
        return range(s * self.chunks_per_split,
                     min(self.chunks, (s + 1) * self.chunks_per_split))


def f32_spatial_data_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                          sms: int, n_tile: Optional[int] = None,
                          k_chunk: Optional[int] = None,
                          k_splits: Optional[int] = None
                          ) -> Optional[F32SpatialDataPlan]:
    """The fp32 spatial data gradient's tiling on a card of ``sms``
    multiprocessors: for each N tile of _SDF_N_TILES, the first chunk of
    _SDF_K_CHUNKS whose step's rows a thread's copies cover and whose
    buffers fit a block's shared memory; then for each count of K splits
    the most ranges of whole images that keep one wave (``sms`` blocks),
    and of all these the least modelled time (steps of the longest range x
    chunks of a split x a chunk's time, plus a split's traffic), the first
    N tile and then fewer splits on a tie. ``n_tile`` / ``k_chunk`` /
    ``k_splits`` ask for one layout (the sweep's and the tests'). None
    where no layout fits: the wrapper then takes the per-tap gather
    (``f32_bwd_data_plan``)."""
    images, m = b * t, b * t * h * w
    best = None
    for nb in (n_tile,) if n_tile else _SDF_N_TILES:
        step = _SDF_STEPS[nb]
        rows = spatial_ring_rows(h, w, step, 1)
        threads = step // 8 * nb // 8
        for kc in (k_chunk,) if k_chunk else _SDF_K_CHUNKS:
            smem = _spatial_data_f32_smem(w, rows, kc, nb)
            if rows * w > _SWF_VMAX * threads // (kc // 4) \
                    or smem > _SMEM_BLOCK_MAX:
                continue
            n_tiles, chunks = _cdiv(ci, nb), _cdiv(co, kc)
            chunk_us = 2 * 9 * kc * step * nb / _SDF_SM_FLOPS[nb] * 1e6
            for want in (k_splits,) if k_splits else range(1, chunks + 1):
                cps = _cdiv(chunks, want)
                splits = _cdiv(chunks, cps)            # no split empty
                ranges_max = sms // (n_tiles * splits)
                if k_splits is None and ranges_max < 1:
                    break
                per = _cdiv(images, max(1, min(images, ranges_max)))
                if per * h * w >= 2 ** 31:
                    return None
                ranges = _cdiv(images, per)
                us = _cdiv(per * h * w, step) * cps * chunk_us
                if splits > 1:
                    us += (2 * splits * m * ci * 4 / _SDF_SPLIT_BPS * 1e6
                           + _SDF_SPLIT_US)
                key = (us, splits)
                if best is None or key < best[0]:
                    rows_part = ranges if splits == 1 \
                        else _cdiv(m, _SDF_SUM_ROWS)
                    best = (key, F32SpatialDataPlan(
                        step, nb, kc, threads, rows, images, per, ranges,
                        n_tiles, chunks, splits, cps,
                        ranges * splits * n_tiles, rows_part,
                        4 * splits * m * ci if splits > 1 else 0, smem, us))
            break
    return None if best is None else best[1]


# The fp32 temporal data gradient's frame walk (temporal_data_f32_kernel in
# conv_bn_f32.cu): row 4f's walk with ge in place of x̂, each thread 4
# positions x 8 input channels x 3 dx̂ frames, K in chunks of 16 output
# channels for all three taps, ge folded in place once per strip, frame and
# N tile; at most 8 warps a block, so each N tile has its strip
_TDF_LAYOUTS = {64: 128, 144: 56}  # N tile -> strip
# preferred first where they pad C_in alike (measured on an H100,
# filter_sweep.py --kind temporal_data_f32, PERF.md: at the train step's
# stages 3-4 tiles of 64 took 5% less than 144, whose warps read B in three
# wavefronts)
_TDF_N_TILES = (64, 144)
_TDF_TILE = (4, 8, 3)      # positions x input channels x dx̂ frames a thread
_TDF_K_CHUNK = 16          # output channels a chunk (TDF_KC)


def _temporal_data_f32_smem(co: int, n_tile: int, resident: bool,
                            affine: bool) -> int:
    """A block's shared memory (tdf_smem in conv_bn_f32.cu): two gy / ge
    chunk buffers and one y buffer [strip, 16 + 4], with the prologue the
    threads' x slots (two frames of [strip, n_tile]), and the filter
    (resident [3·C_out in whole chunks, n_tile], or two streamed chunks
    [3·16, n_tile])."""
    cop = _cdiv(co, _TDF_K_CHUNK) * _TDF_K_CHUNK
    strip = _TDF_LAYOUTS[n_tile]
    filt = 3 * cop * n_tile if resident else 2 * 3 * _TDF_K_CHUNK * n_tile
    xs = 2 * strip * n_tile if affine else 0
    return 4 * (filt + xs + 3 * strip * (_TDF_K_CHUNK + 4))


class F32TemporalDataPlan(NamedTuple):
    """How the fp32 temporal data gradient's frame walk cuts its work: units
    of ``strip`` consecutive positions of the flattened B·H·W axis (a strip
    spans several clips where H·W is small), each walked over T by
    ``threads`` threads, gy and y in chunks of ``k_chunk`` output channels a
    frame, ge folded once into three dx̂-frame accumulators; ``n_tiles``
    tiles of ``n_tile`` input channels (ge is folded once per tile), each
    thread ``register_tile`` = positions x input channels x dx̂ frames of
    sums (_TDF_TILE); the
    mirrored filter tile ``resident`` in shared memory or streamed with the
    chunks; ``blocks`` = ``ranges`` contiguous ranges of ``units_per_range``
    units x ``n_tiles`` (``_tw_units_per_block``), each range one partial
    row of dinv / dshift (``part_rows``); ``smem_bytes`` of shared memory a
    block."""
    strip: int
    n_tile: int
    k_chunk: int
    threads: int
    register_tile: Tuple[int, int, int]
    resident: bool
    positions: int
    units: int
    units_per_range: int
    ranges: int
    n_tiles: int
    blocks: int
    part_rows: int
    smem_bytes: int

    def units_of(self, r: int) -> range:
        """The units of range ``r``, as the kernel takes them."""
        return range(r * self.units_per_range,
                     min(self.units, (r + 1) * self.units_per_range))

    def positions_of(self, u: int) -> range:
        """The positions b·H·W + p of unit ``u``; the unit walks every
        frame of each."""
        return range(u * self.strip, min(self.positions, (u + 1) * self.strip))


def f32_temporal_data_plan(b: int, t: int, h: int, w: int, ci: int, co: int,
                           sms: int, affine: bool = True,
                           n_tile: Optional[int] = None
                           ) -> F32TemporalDataPlan:
    """The fp32 temporal data gradient's tiling on a card of ``sms``
    multiprocessors, for every shape, with the prologue (``affine``) or
    without: the N tile of _TDF_N_TILES that pads C_in least (on a tie the
    first), the filter resident where it fits a block's shared memory
    beside the buffers, else streamed (which always fits); ranges of strips
    by ``_tw_units_per_block`` (one block a SM). ``n_tile`` asks for one N
    tile (the sweep's and the tests')."""
    nb = n_tile or min(_TDF_N_TILES, key=lambda n: _cdiv(ci, n) * n)
    res = _temporal_data_f32_smem(co, nb, True, affine) <= _SMEM_BLOCK_MAX
    strip = _TDF_LAYOUTS[nb]
    positions = b * h * w
    units = _cdiv(positions, strip)
    n_tiles = _cdiv(ci, nb)
    per = _tw_units_per_block(units, n_tiles, sms, 1)
    ranges = _cdiv(units, per)
    return F32TemporalDataPlan(strip, nb, _TDF_K_CHUNK, strip * nb // 32,
                               _TDF_TILE, res, positions, units, per, ranges,
                               n_tiles, ranges * n_tiles, ranges,
                               _temporal_data_f32_smem(co, nb, res, affine))


def f32_bwd_data_filter(w: torch.Tensor, kind: str) -> torch.Tensor:
    """The fp32 data gradient's B operand, [taps·C_out, C_in]: row
    tap·C_out + co holds W[taps - 1 - tap, :, co] (the taps mirrored, each
    transposed), so the gather at a tap's neighbour meets the mirrored tap."""
    ci, co = w.shape[-2], w.shape[-1]
    taps = 9 if kind == "spatial" else 3
    return w.float().reshape(taps, ci, co).flip(0).transpose(1, 2) \
        .reshape(taps * co, ci)


def _conv_unit_bwd_data_f32(x, w, inv, shift, y, gy, gs1, gs2, kind):
    """The fp32 data gradient on the card (C_in, C_out multiples of 8): the
    temporal frame walk (temporal_data_f32_kernel,
    ``f32_temporal_data_plan``), the spatial row walk
    (spatial_data_f32_kernel, ``f32_spatial_data_plan``, with a K split its
    second pass) or, for images too wide for the row walk, the spatial
    per-tap gather (bwd_data_f32_kernel, ``f32_bwd_data_plan``); plus, with
    the prologue, the fixed-order sum of the partial rows of dinv /
    dshift."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    affine = inv is not None
    gy, y = _aligned16(gy), _aligned16(y)
    gs1, gs2 = _aligned16(gs1.float()), _aligned16(gs2.float())
    wt = _aligned16(f32_bwd_data_filter(w, kind))
    xa = None                           # x only with the prologue
    if affine:
        xa, inv, shift = (_aligned16(x), _aligned16(inv.float()),
                          _aligned16(shift.float()))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    frames = walk = gather = None
    if kind == "temporal":
        frames = f32_temporal_data_plan(b, t, h, wd, ci, co, sms, affine)
        rows = frames.part_rows
    else:
        walk = f32_spatial_data_plan(b, t, h, wd, ci, co, sms)
        gather = f32_bwd_data_plan(b, t, h, wd, ci, sms) if walk is None \
            else None
        rows = walk.part_rows if walk is not None else gather.ranges
    dx = torch.empty(b, t, h, wd, ci, dtype=torch.float32, device=x.device)
    dinv = dshift = part = None
    if affine:
        dinv = torch.empty(ci, dtype=torch.float32, device=x.device)
        dshift = torch.empty(ci, dtype=torch.float32, device=x.device)
        part = torch.empty(2 * rows * ci, dtype=torch.float32, device=x.device)
    ptr = lambda v: None if v is None else v.data_ptr()
    ptrs = (gy.data_ptr(), y.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
            wt.data_ptr(), ptr(xa), ptr(inv), ptr(shift), dx.data_ptr(),
            ptr(dinv), ptr(dshift), ptr(part))
    lib = cuda_lib.library("conv_bn_f32")
    with torch.cuda.device(x.device):
        if frames is not None:
            err = lib.m3f_temporal_data_f32(
                *ptrs, b, t, h, wd, ci, co, frames.n_tile,
                int(frames.resident), frames.units_per_range,
                cuda_lib.stream_ptr(x))
        elif walk is not None:
            dxpart = torch.empty(walk.part_bytes // 4, dtype=torch.float32,
                                 device=x.device) if walk.k_splits > 1 else None
            err = lib.m3f_spatial_data_f32(
                *ptrs, ptr(dxpart), b, t, h, wd, ci, co, walk.n_tile,
                walk.k_chunk, walk.images_per_range, walk.k_splits,
                cuda_lib.stream_ptr(x))
        else:
            err = lib.m3f_conv_unit_bwd_data_f32(
                *ptrs, b, t, h, wd, ci, co, gather.tiles_per_range,
                cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"conv_unit_bwd_data {kind} fp32 kernel")
    cuda_lib.launches[f"conv_{kind}_bwd_data_f32"] += 1
    return dx, dinv, dshift


def _conv_unit_bwd_filter_f32(x, inv, shift, y, gy, gs1, gs2, kind):
    """The fp32 filter gradient on the card (C_in, C_out multiples of 8):
    one launch of the spatial row walk (spatial_filter_f32_kernel,
    ``f32_spatial_filter_plan``) or, for the temporal kind and for images
    too wide for the walk, of the per-tap gather (bwd_filter_f32_kernel,
    ``f32_bwd_filter_plan``), plus, with more than one slice, the sum of
    the slices' partials in slice order."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    x, gy, y = _aligned16(x), _aligned16(gy), _aligned16(y)
    gs1, gs2 = _aligned16(gs1.float()), _aligned16(gs2.float())
    inv = _aligned16(None if inv is None else inv.float())
    shift = _aligned16(None if shift is None else shift.float())
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    walk = f32_spatial_filter_plan(b, t, h, wd, ci, co, sms) \
        if kind == "spatial" else None
    plan = walk or f32_bwd_filter_plan(b, t, h, wd, ci, co, kind, sms)
    k = (9 if kind == "spatial" else 3) * ci
    dw = torch.empty(k, co, dtype=torch.float32, device=x.device)
    part = torch.empty(plan.slices * k * co, dtype=torch.float32,
                       device=x.device) if plan.slices > 1 else None
    ptrs = (x.data_ptr(), gy.data_ptr(), y.data_ptr(), gs1.data_ptr(),
            gs2.data_ptr(), None if inv is None else inv.data_ptr(),
            None if shift is None else shift.data_ptr(), dw.data_ptr(),
            None if part is None else part.data_ptr())
    lib = cuda_lib.library("conv_bn_f32")
    with torch.cuda.device(x.device):
        if walk is not None:
            ge = torch.empty(walk.ge_bytes // 4, dtype=torch.float32,
                             device=x.device)
            err = lib.m3f_spatial_filter_f32(
                *ptrs, ge.data_ptr(), b, t, h, wd, ci, co, walk.n_tile,
                walk.step, walk.images_per_slice, walk.slices,
                cuda_lib.stream_ptr(x))
        else:
            err = lib.m3f_conv_unit_bwd_filter_f32(
                *ptrs, 0 if kind == "spatial" else 1, b, t, h, wd, ci, co,
                plan.chunks_per_slice, plan.slices, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"conv_unit_bwd_filter {kind} fp32 kernel")
    cuda_lib.launches[f"conv_{kind}_bwd_filter_f32"] += 1
    return dw.reshape((3, 3, ci, co) if kind == "spatial" else (3, ci, co))


class _ConvUnit(torch.autograd.Function):
    """The differentiable unit; saves (x, w_c, inv, shift, y) as the
    reference's custom VJP does (``_conv_unit_affine_fwd``)."""

    @staticmethod
    def forward(ctx, x, w, inv, shift, kind):
        w_c = w.to(x.dtype)
        y, s1, s2 = conv_unit_fwd(x, w_c, inv, shift, kind=kind)
        ctx.save_for_backward(x, w_c, inv, shift, y)
        ctx.kind = kind
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, w_c, inv, shift, y = ctx.saved_tensors
        dx, dinv, dshift = conv_unit_bwd_data(x, w_c, inv, shift, y, gy, gs1,
                                              gs2, kind=ctx.kind)
        dw = conv_unit_bwd_filter(x, inv, shift, y, gy, gs1, gs2,
                                  kind=ctx.kind)
        return dx, dw, dinv, dshift, None


def conv_unit(x: torch.Tensor, w: torch.Tensor,
              inv: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None, *, kind: str
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable fused unit → (y, s1, s2). ``w`` is the fp32 parameter
    view (cast to x's dtype inside, so dw comes back fp32); ``inv``/``shift``
    are the previous BatchNorm's fp32 affine, or None. Without autograd
    (eval, ``torch.no_grad``) this is ``conv_unit_fwd`` exactly."""
    tensors = (x, w) + ((inv, shift) if inv is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _ConvUnit.apply(x, w, inv, shift, kind)
    return conv_unit_fwd(x, w.to(x.dtype), inv, shift, kind=kind)
