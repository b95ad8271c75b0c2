"""R(2+1)D-18 visual backbone over face clips, NDHWC.

Counterpart of ``m3f/pytorch_tpu/models/r2plus1d.py`` (torchvision
``video/resnet.py`` recipe): a (1,7,7) stride-(1,2,2) + (3,1,1) stem, four
stages of BasicBlocks whose convs factorize into spatial (1,3,3) → BN/ReLU →
temporal (3,1,1) with the FLOP-matched midplane count, global or per-frame
spatial pooling.

Routing follows the reference's fused rule: a stride-1 block without a
downsample projection or SE branch runs its four convs as fused conv units
(``ops.conv_bn.conv_unit``: the CUDA kernels on the card, forward and
backward), with each BatchNorm's normalize + ReLU folded into the next
unit's prologue and, in training, its batch statistics taken from the
previous unit's channel sums. The stem, strided convs and downsample
projections stay on ``F.conv3d`` (cuDNN) with ``BatchNorm`` over their
outputs, as the reference leaves them to XLA. Two-pass BatchNorm
(``visual.bn_two_pass``) cannot ride the sums, one-pass by construction, so
it routes every block through the plain composition, as the reference does.

``visual.conv_backend`` does not choose a route in this port: both of the
reference's values ("xla", the plain composition, and "pallas_fused") take
the fused units. In eval they are the same arithmetic (BN normalizes with
the running statistics either way); in training the reference's two
backends agree only up to the fp32 summation order of the BN statistics
(its ``tests/test_conv_bn_fused.py`` holds them to 1e-4 in fp32), and the
tests hold the port's fused route against both. The field stays for config
parity; any other value raises.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from m3f_torch.config import VisualNetConfig
from m3f_torch.nn import BatchNorm, Conv, global_avg_pool, relu
from m3f_torch.ops.conv_bn import conv_unit

# The reference's two conv backends; the port routes both the same way.
CONV_BACKENDS = ("xla", "pallas_fused")


def midplanes(in_c: int, out_c: int, t: int = 3, d: int = 3,
              mode: str = "flops") -> int:
    """Intermediate width of the (2+1)D factorization (torchvision's
    FLOP-matched formula)."""
    if mode != "flops":
        raise NotImplementedError(
            f"mid_mode={mode!r} is not ported yet (ROADMAP: other conv "
            "families and variants)")
    return (t * d * d * in_c * out_c) // (d * d * in_c + t * out_c)


class Conv2Plus1D(nn.Module):
    """spatial (1,3,3) → BN → ReLU → temporal (3,1,1), ``mid`` wide."""

    def __init__(self, in_c: int, out_c: int, mid: int, gen: torch.Generator,
                 stride=(1, 1, 1), bn_two_pass: bool = False):
        super().__init__()
        st, sh, sw = stride
        self.stride = tuple(stride)
        self.spatial = Conv(in_c, mid, (1, 3, 3), gen, strides=(1, sh, sw),
                            padding=(0, 1, 1))
        self.bn_mid = BatchNorm(mid, two_pass=bn_two_pass)
        self.temporal = Conv(mid, out_c, (3, 1, 1), gen, strides=(st, 1, 1),
                             padding=(1, 0, 0))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.temporal(relu(self.bn_mid(self.spatial(x), train)))

    def forward_fused(self, x: torch.Tensor, inv_in=None, shift_in=None,
                      train: bool = False):
        """Stride-1 fused path: spatial unit → mid-BN affine folded into the
        temporal unit's prologue. Returns the temporal conv's output and its
        channel sums (s1, s2)."""
        ws = self.spatial.weight[:, :, 0].permute(2, 3, 1, 0)     # [3,3,ci,mid]
        y1, s1, s2 = conv_unit(x, ws, inv_in, shift_in, kind="spatial")
        inv_m, shift_m = self.bn_mid.affine_from_stats(
            s1, s2, float(math.prod(y1.shape[:-1])), train)
        wt = self.temporal.weight[:, :, :, 0, 0].permute(2, 1, 0)  # [3,mid,co]
        y2, s1b, s2b = conv_unit(y1, wt, inv_m, shift_m, kind="temporal")
        return y2, (s1b, s2b)


class BasicBlock(nn.Module):
    def __init__(self, in_c: int, out_c: int, gen: torch.Generator,
                 stride=(1, 1, 1), bn_two_pass: bool = False):
        super().__init__()
        mid = midplanes(in_c, out_c)
        self.stride = tuple(stride)
        self.conv1 = Conv2Plus1D(in_c, out_c, mid, gen, stride, bn_two_pass)
        self.bn1 = BatchNorm(out_c, two_pass=bn_two_pass)
        self.conv2 = Conv2Plus1D(out_c, out_c, mid, gen, bn_two_pass=bn_two_pass)
        self.bn2 = BatchNorm(out_c, two_pass=bn_two_pass)
        self.has_downsample = self.stride != (1, 1, 1) or in_c != out_c
        if self.has_downsample:
            self.down = Conv(in_c, out_c, (1, 1, 1), gen, strides=self.stride)
            self.bn_down = BatchNorm(out_c, two_pass=bn_two_pass)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = relu(self.bn1(self.conv1(x, train), train))
        y = self.bn2(self.conv2(y, train), train)
        sc = self.bn_down(self.down(x), train) if self.has_downsample else x
        return relu(y + sc)

    def forward_fused(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Identity-shortcut stride-1 block as four fused units; only bn2's
        normalize, the residual add and the ReLU stay elementwise."""
        count = float(math.prod(x.shape[:-1]))
        y, (s1a, s2a) = self.conv1.forward_fused(x, train=train)
        inv1, shift1 = self.bn1.affine_from_stats(s1a, s2a, count, train)
        y2, (s1b, s2b) = self.conv2.forward_fused(y, inv1, shift1, train)
        inv2, shift2 = self.bn2.affine_from_stats(s1b, s2b, count, train)
        y2n = y2 * inv2.to(y2.dtype) + shift2.to(y2.dtype)
        return relu(y2n + x)


class R2Plus1D(nn.Module):
    def __init__(self, cfg: VisualNetConfig, gen: torch.Generator):
        super().__init__()
        for name, value, want in (("conv_mode", cfg.conv_mode, "2plus1d"),
                                  ("se_ratio", cfg.se_ratio, 0),
                                  ("stem_s2d", cfg.stem_s2d, False),
                                  ("mid_mode", cfg.mid_mode, "flops")):
            if value != want:
                raise NotImplementedError(
                    f"visual.{name}={value!r} is not ported yet (ROADMAP: "
                    "other conv families and variants)")
        if cfg.conv_backend not in CONV_BACKENDS:
            raise ValueError(f"unknown visual.conv_backend {cfg.conv_backend!r}; "
                             f"the port knows {CONV_BACKENDS}, both of which "
                             "take the fused units")
        self.cfg = cfg
        two = cfg.bn_two_pass
        self.stem = nn.ModuleDict({
            "conv1": Conv(3, 45, (1, 7, 7), gen, strides=(1, 2, 2),
                          padding=(0, 3, 3)),
            "bn1": BatchNorm(45, two_pass=two),
            "conv2": Conv(45, cfg.stem_channels, (3, 1, 1), gen,
                          padding=(1, 0, 0)),
            "bn2": BatchNorm(cfg.stem_channels, two_pass=two),
        })
        blocks = []
        in_c = cfg.stem_channels
        for si, (out_c, n) in enumerate(zip(cfg.block_channels,
                                            cfg.blocks_per_stage)):
            for bi in range(n):
                stride = (2, 2, 2) if si > 0 and bi == 0 else (1, 1, 1)
                blocks.append(BasicBlock(in_c, out_c, gen, stride, two))
                in_c = out_c
        self.blocks = nn.ModuleList(blocks)

    def forward(self, clips: torch.Tensor, per_frame: bool = False,
                train: bool = False) -> torch.Tensor:
        """clips [B, T, H, W, 3] → [B, C] (global pool) or, ``per_frame``,
        [B, T', C] (spatial pool only). ``train``: BatchNorm on the batch's
        statistics, its running buffers updated in place."""
        s = self.stem
        x = relu(s["bn1"](s["conv1"](clips), train))
        x = relu(s["bn2"](s["conv2"](x), train))
        # the fused units' statistics are one-pass sums, so two-pass BN takes
        # the plain composition
        fused = not self.cfg.bn_two_pass
        for blk in self.blocks:
            x = blk.forward_fused(x, train) if fused and not blk.has_downsample \
                else blk(x, train)
        if per_frame:
            return x.mean(dim=(2, 3))
        return global_avg_pool(x)
