"""Packed-layout (channels-major) 3x3 conv of the layout probe: the plain
PyTorch versions and the CUDA kernels.

Counterpart of the four Pallas kernels of ``scripts/probe_packed_conv.py``
(``packed_conv``, ``ablate_slabs``, ``ablate_matmul``,
``packed_conv_chunked``); the kernels are ``csrc/packed_conv.cu``.

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

import numpy as np
import torch

from m3f_torch.ops import cuda_lib

TAPS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_BN = 128        # positions per tile of every kernel (BN in packed_conv.cu)


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


# mode of m3f_packed_conv (csrc/packed_conv.cu)
_MODES = {"packed_conv": 0, "packed_conv_f32": 1, "ablate_slabs": 2,
          "ablate_matmul": 3, "packed_conv_chunked": 4}


def _launch(name: str, shape: ProbeShape, a: torch.Tensor, w_cm: torch.Tensor,
            out_f32: bool = False) -> torch.Tensor:
    """One launch of kernel ``name`` -> y [BT, COUT, HWP]. The card path's
    guard: bf16 tensors on one CUDA device and the kernel's alignment
    (16-byte loads of w_cm rows and x_cm windows, whole tiles per chunk)."""
    cuda_lib.require_cuda(name, a, w_cm)
    chunk = shape.CHUNK if name == "packed_conv_chunked" else 0
    if a.dtype != torch.bfloat16 or w_cm.dtype != torch.bfloat16 \
            or shape.CIN % 8 or shape.MARGIN % 8 or chunk % _BN:
        raise ValueError(
            f"{name} kernel takes bf16 inputs with CIN and MARGIN multiples "
            f"of 8 and CHUNK a multiple of {_BN}; got {a.dtype}, {w_cm.dtype}, "
            f"{shape}")
    a, w_cm = a.contiguous(), w_cm.contiguous()
    y = torch.empty(shape.BT, shape.COUT, shape.HWP, device=a.device,
                    dtype=torch.float32 if out_f32 else torch.bfloat16)
    with torch.cuda.device(a.device):
        err = cuda_lib.library("packed_conv").m3f_packed_conv(
            a.data_ptr(), w_cm.data_ptr(), y.data_ptr(),
            _MODES[name + ("_f32" if out_f32 else "")], shape.BT, shape.CIN,
            shape.COUT, shape.W, shape.HWP, shape.MARGIN, chunk,
            cuda_lib.stream_ptr(a))
    cuda_lib.check(err, f"{name} kernel")
    cuda_lib.launches[name] += 1
    return y


def packed_conv(x_cm: torch.Tensor, w_cm: torch.Tensor, shape: ProbeShape,
                out_f32: bool = False) -> torch.Tensor:
    """y [BT, COUT, HWP] of the packed conv (module doc): the plain version
    on the CPU, one kernel launch on the card."""
    _check("packed_conv", shape, x_cm, w_cm)
    if x_cm.device.type == "cpu":
        return packed_conv_reference(x_cm, w_cm, shape, out_f32)
    return _launch("packed_conv", shape, x_cm, w_cm, out_f32)


def packed_conv_chunked(x_cm: torch.Tensor, w_cm: torch.Tensor,
                        shape: ProbeShape) -> torch.Tensor:
    """The packed conv with bf16 y, on the card one block per image and
    CHUNK positions, that chunk's halo window staged in shared memory once
    and the nine taps built from it; the plain version on the CPU."""
    _check("packed_conv_chunked", shape, x_cm, w_cm)
    if x_cm.device.type == "cpu":
        return packed_conv_reference(x_cm, w_cm, shape)
    return _launch("packed_conv_chunked", shape, x_cm, w_cm)


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
