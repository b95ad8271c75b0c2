"""Fused conv + BatchNorm forward unit: the plain PyTorch version and the
CUDA kernel.

Counterpart of the forward half of ``m3f/pytorch_tpu/ops/pallas/conv_bn.py``
(``conv_unit_fwd``, ``conv_unit_reference``); the kernels are
``csrc/conv_bn.cu``. One unit is

    prologue:  x̂ = relu(x·inv + shift)   (previous BN + ReLU in the compute
                                          dtype; identity without inv/shift)
    conv:      y = x̂ ⊛ W                 (1,3,3) "spatial" or (3,1,1)
                                          "temporal", stride 1, pad 1
    epilogue:  s1 = Σy, s2 = Σy²          (fp32 per channel, over the rounded y)

x is [B, T, H, W, C_in] for both kinds; w is the reference's layout,
[3, 3, C_in, C_out] (spatial) or [3, C_in, C_out] (temporal), cast to x's
dtype. The backward half comes with training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from m3f_torch.ops import cuda_lib

_BM = 128          # output pixels per tile (csrc/conv_bn.cu BM)
_TILES_PER_BLOCK_MAX = 8


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
    y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                 kernel.contiguous(memory_format=torch.channels_last_3d),
                 padding=pad).permute(0, 2, 3, 4, 1)
    yf = y.float()
    axes = (0, 1, 2, 3)
    return y, yf.sum(axes), (yf * yf).sum(axes)


def _tile_n(co: int) -> int:
    """Output-channel tile of the kernel: the widest of 64, 96, 48 that
    divides C_out (no masked columns at the model's widths), else 64."""
    for bn in (64, 96, 48):
        if co % bn == 0:
            return bn
    return 64


def conv_unit_fwd(x: torch.Tensor, w: torch.Tensor,
                  inv: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None, *, kind: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused (affine + ReLU →) conv → channel sums; returns (y, s1, s2).

    Plain composition on the CPU; on the card one kernel launch (plus a
    fixed-order reduction of its per-block sums) for bf16 activations."""
    if x.device.type == "cpu":
        return conv_unit_reference(x, w, inv, shift, kind=kind)
    tensors = (x, w) + ((inv, shift) if inv is not None else ())
    cuda_lib.require_cuda("conv_unit_fwd", *tensors)
    b, t, h, wd, ci = x.shape
    co = w.shape[-1]
    want_w = (3, 3, ci, co) if kind == "spatial" else (3, ci, co)
    if kind not in ("spatial", "temporal") or tuple(w.shape) != want_w \
            or x.dtype != torch.bfloat16 or ci % 8 or co % 8:
        raise ValueError(
            f"conv_unit_fwd kernel takes bf16 x [B,T,H,W,Ci] and w {want_w} "
            f"with Ci, Co multiples of 8; got kind={kind!r} x "
            f"{tuple(x.shape)} {x.dtype}, w {tuple(w.shape)}")
    x = x.contiguous()
    taps = 9 if kind == "spatial" else 3
    # [Co, taps·Ci] with k = tap·Ci + ci: the kernel's K-major B operand
    wk = w.to(torch.bfloat16).movedim(-1, 0).reshape(co, taps * ci).contiguous()
    if inv is not None:
        inv = inv.float().contiguous()
        shift = shift.float().contiguous()
    m = b * t * h * wd
    bn = _tile_n(co)
    tiles_m = -(-m // _BM)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tpb = max(1, min(_TILES_PER_BLOCK_MAX,
                     tiles_m * (-(-co // bn)) // (4 * sms)))
    rows = -(-tiles_m // tpb)
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
            0 if kind == "spatial" else 1, b, t, h, wd, ci, co, bn, tpb,
            cuda_lib.stream_ptr(x))
    cuda_lib.check(err, f"conv_unit_fwd {kind} kernel")
    cuda_lib.launches["conv_" + kind] += 1
    return y, s1, s2
