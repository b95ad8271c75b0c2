"""Layer core of the port: channels-last layers with the reference's numerics.

Counterpart of ``m3f/pytorch_tpu/nn.py``.

- **Layouts:** activations are NHWC / NDHWC at every boundary. ``Conv``
  keeps its weight in PyTorch's ``[O, I, *k]`` order in ``channels_last``
  memory format (converted once from the reference's HWIO / DHWIO kernels at
  load, ``train/checkpoint.py``), and runs on a permuted *view* of the
  activation, never a copy.
- **dtypes:** parameters fp32, compute in the activation's dtype (bf16 by
  default); a conv on fp32 input accumulates and returns fp32. On the card
  an fp32 model runs inside ``full_fp32``, so cuDNN's convs and cuBLAS's
  products stay in fp32 and do not drop to TF32.
- **Padding:** ``conv`` pads each spatial axis by a (low, high) pair; an
  asymmetric pair is an explicit zero ``F.pad`` before an unpadded conv.
- **BatchNorm** is the reference's one-pass ``E[x²]−E[x]²`` form clamped at
  0 (optionally two-pass), with the normalize ``x·inv + shift`` done in the
  compute dtype — not ``nn.BatchNorm3d``, whose variance order differs.
  Under a data-parallel train step its sums and count cover the global
  batch (``parallel/mesh.py`` ``all_sum``), as the reference's do with the
  batch sharded over the mesh.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from m3f_torch.parallel.mesh import all_sum, data_size

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA request without a GPU raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain versions")
    return dev


def fan_in_uniform(gen: torch.Generator, shape: Sequence[int],
                   fan_in: int) -> torch.Tensor:
    """torch-style default init U(-1/sqrt(fan_in), +1/sqrt(fan_in)), fp32,
    drawn on the CPU generator ``gen``."""
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.rand(tuple(shape), generator=gen) * 2.0 - 1.0) * bound


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with the reference's ``[in, out]`` kernel."""

    def __init__(self, in_dim: int, out_dim: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(fan_in_uniform(gen, (in_dim, out_dim), in_dim))
        self.bias = nn.Parameter(fan_in_uniform(gen, (out_dim,), in_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


Padding = Union[int, Tuple[int, int]]


def _pairs(padding: Sequence[Padding], nd: int) -> Tuple[Tuple[int, int], ...]:
    """One (low, high) pair per spatial axis; an int pads both sides."""
    pads = tuple((p, p) if isinstance(p, int) else tuple(p)
                 for p in (tuple(padding) or (0,) * nd))
    if len(pads) != nd or any(len(p) != 2 for p in pads):
        raise ValueError(f"padding {padding!r} for a {nd}-D conv: one int or "
                         "(low, high) pair per spatial axis")
    return pads


def conv(x: torch.Tensor, weight: torch.Tensor, strides: Sequence[int] = (),
         padding: Sequence[Padding] = ()) -> torch.Tensor:
    """Channels-last conv of x [N, *spatial, C] with ``weight`` [O, C, *k]
    (cast to x's dtype) → [N, *spatial', O]. ``padding`` is one int or one
    (low, high) pair per spatial axis; where any pair is asymmetric the zero
    padding is an explicit ``F.pad`` and the conv itself pads nothing."""
    nd = weight.dim() - 2
    if nd not in (2, 3):
        raise ValueError(f"conv supports 2-D and 3-D kernels, got {tuple(weight.shape)}")
    pads = _pairs(padding, nd)
    perm_in = (0, nd + 1) + tuple(range(1, nd + 1))
    perm_out = (0,) + tuple(range(2, nd + 2)) + (1,)
    xc = x.permute(perm_in)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        xc = F.pad(xc, [v for lo, hi in reversed(pads) for v in (lo, hi)])
        sym = (0,) * nd
    fn = F.conv3d if nd == 3 else F.conv2d
    y = fn(xc, weight.to(x.dtype), stride=tuple(strides) or (1,) * nd,
           padding=sym)
    return y.permute(perm_out)


class Conv(nn.Module):
    """2-D or 3-D channels-last convolution (no bias, as every conv of the
    model). ``padding`` is one int (symmetric) or (low, high) pair per
    spatial axis (``conv``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, ...], gen: torch.Generator,
                 strides: Tuple[int, ...] = (),
                 padding: Tuple[Padding, ...] = ()):
        super().__init__()
        nd = len(kernel_size)
        if nd not in (2, 3):
            raise ValueError(f"Conv supports 2-D and 3-D kernels, got {kernel_size}")
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides) or (1,) * nd
        self.padding = _pairs(padding, nd)
        fan_in = math.prod(kernel_size) * in_channels
        w = fan_in_uniform(gen, (out_channels, in_channels) + self.kernel_size,
                           fan_in)
        fmt = torch.channels_last_3d if nd == 3 else torch.channels_last
        self.weight = nn.Parameter(w.contiguous(memory_format=fmt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, *spatial, C] → [N, *spatial', O] in x's dtype."""
        return conv(x, self.weight, self.strides, self.padding)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis, reference formulas.

    Eval normalizes with the running statistics; train uses the batch's
    one-pass (or two-pass) statistics and updates the running buffers in
    place with momentum and the unbiased variance, as the reference's
    ``apply`` returns as new state.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, two_pass: bool = False):
        super().__init__()
        self.momentum, self.eps, self.two_pass = momentum, eps, two_pass
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def _update(self, mean: torch.Tensor, var: torch.Tensor, n: float):
        unbiased = var * (n / max(n - 1.0, 1.0))
        m = self.momentum
        self.mean.copy_((1 - m) * self.mean + m * mean)
        self.var.copy_((1 - m) * self.var + m * unbiased)

    def affine(self, mean: torch.Tensor, var: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        inv = torch.rsqrt(var + self.eps) * self.scale      # fp32 [C]
        return inv, self.bias - mean * inv                  # fp32 [C]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float()
            axes = tuple(range(x.ndim - 1))
            n = float(math.prod(x.shape[:-1])) * data_size()
            if self.two_pass:
                mean = all_sum(xf.sum(axes))[0] / n
                d = xf - mean
                var = all_sum((d * d).sum(axes))[0] / n
            else:
                s1, s2 = all_sum(xf.sum(axes), (xf * xf).sum(axes))
                mean = s1 / n
                var = torch.clamp(s2 / n - mean * mean, min=0.0)
            with torch.no_grad():
                self._update(mean, var, n)
        else:
            mean, var = self.mean, self.var
        inv, shift = self.affine(mean, var)
        return x * inv.to(x.dtype) + shift.to(x.dtype)

    def affine_from_stats(self, s1: torch.Tensor, s2: torch.Tensor,
                          count: float, train: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-channel (inv, shift) from a conv epilogue's channel sums
        ``s1 = Σy``, ``s2 = Σy²`` over ``count`` positions (train), or from
        the running statistics (eval, where the sums are not read)."""
        if train:
            s1, s2 = all_sum(s1, s2)
            count = count * data_size()
            mean = s1 / count
            var = torch.clamp(s2 / count - mean * mean, min=0.0)
            with torch.no_grad():
                self._update(mean, var, count)
        else:
            mean, var = self.mean, self.var
        return self.affine(mean, var)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over all spatial axes: [N, *spatial, C] → [N, C]."""
    return x.mean(dim=tuple(range(1, x.ndim - 1)))


_fp32_lock = threading.Lock()
_fp32_depth = 0
_fp32_saved: Tuple[bool, bool] = (True, False)


@contextlib.contextmanager
def full_fp32():
    """cuDNN's convs and cuBLAS's products in full fp32 (no TF32) while
    inside: an fp32 model's forward and backward on the card, whose
    reference rounds nothing to TF32's 10-bit mantissa. PyTorch keeps the two
    switches process-wide, so overlapping scopes from several threads (the
    HTTP server's) share one count: the first to enter turns TF32 off, the
    last to leave restores what was set before. Meanwhile other threads'
    fp32 work runs without TF32 too, never with less precision."""
    global _fp32_depth, _fp32_saved
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _fp32_lock:
        if _fp32_depth == 0:
            _fp32_saved = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = False
            matmul.allow_tf32 = False
        _fp32_depth += 1
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _fp32_saved


def compute_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r} "
                         f"(one of {sorted(DTYPES)})") from None
