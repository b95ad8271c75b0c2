"""Video ResNet-18 visual backbones over face clips, NDHWC.

Counterpart of ``m3f/pytorch_tpu/models/r2plus1d.py``: the three torchvision
``video/resnet.py`` families (``visual.conv_mode``), four stages of
BasicBlocks, global or per-frame spatial pooling.

- ``2plus1d`` (r2plus1d_18, the default): a (1,7,7) stride-(1,2,2) + (3,1,1)
  stem; every block conv factorizes into spatial (1,3,3) → BN/ReLU →
  temporal (3,1,1) with ``midplanes`` channels between (FLOP-matched, or
  ``mid_mode="lane"``: rounded to a multiple of 128).
- ``3d`` (r3d_18): one (3,7,7) stride-(1,2,2) stem conv, (3,3,3) block
  convs.
- ``mc3`` (mc3_18): the ``3d`` stem and stage 1, then (1,3,3) block convs
  whose stages downsample space only, so time is never strided.

Variants: ``se_ratio`` > 0 adds a squeeze-excitation branch to every block
(after bn2, before the residual add); ``stem_s2d`` runs the stride-(1,2,2)
7x7 stem conv as the same arithmetic on 2x2-packed input
(``space_to_depth_hw``, ``s2d_stem_kernel``: a stride-1 4x4 conv padded
(2, 1) by an explicit ``F.pad``). Parameters keep the checkpoint layout in
every variant.

Routing follows the reference's fused rule: a stride-1 ``2plus1d`` block
without a downsample projection or SE branch runs its four convs as fused
conv units (``ops.conv_bn.conv_unit``: the CUDA kernels on the card,
forward and backward; fp32 activations have forward kernels only), with
each BatchNorm's normalize + ReLU folded into the next unit's prologue and,
in training, its batch statistics taken from the previous unit's channel
sums. The stem, strided convs, downsample projections, SE blocks and the
``3d`` / ``mc3`` families stay on ``F.conv3d`` (cuDNN) with ``BatchNorm``
over their outputs, as the reference leaves them to XLA. Two-pass BatchNorm
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
from m3f_torch.nn import BatchNorm, Conv, Dense, conv, global_avg_pool, relu
from m3f_torch.ops.conv_bn import conv_unit

# The reference's two conv backends; the port routes both the same way.
CONV_BACKENDS = ("xla", "pallas_fused")
CONV_MODES = ("2plus1d", "3d", "mc3")


def midplanes(in_c: int, out_c: int, t: int = 3, d: int = 3,
              mode: str = "flops") -> int:
    """Intermediate width of the (2+1)D factorization.

    ``flops``: torchvision's FLOP-matched formula (checkpoint compatible).
    ``lane``: that value rounded to the nearest multiple of 128 (at least
    128); every such width is a multiple of 8, as the fused units take it.
    """
    mid = (t * d * d * in_c * out_c) // (d * d * in_c + t * out_c)
    if mode == "lane":
        return max(128, ((mid + 63) // 128) * 128)
    if mode != "flops":
        raise ValueError(f"unknown mid_mode {mode!r}")
    return mid


def space_to_depth_hw(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] → [B, T, H/2, W/2, 4C], packing each 2x2 spatial tile
    into channels ordered (py, px, c), the layout ``s2d_stem_kernel``
    matches."""
    b, t, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"stem_s2d needs even spatial dims, got {h}x{w}")
    x = x.reshape(b, t, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t, h // 2, w // 2, 4 * c)


def s2d_stem_kernel(k: torch.Tensor) -> torch.Tensor:
    """Re-tile a [kt, 7, 7, ci, co] (reference layout) stride-2 stem kernel
    for s2d input → [kt, 4, 4, 4·ci, co].

    A 7x7 stride-2 conv with padding 3 equals an 8x8 stride-2 conv whose
    leading row and column are zero; over 2x2-packed input that is a 4x4
    stride-1 conv with channel depth 4·ci and padding (2, 1): tap (ky, py)
    of the packed kernel reads original row 2·ky + py − 1. The same
    products; only the order of the sums changes."""
    kt, kh, kw, ci, co = k.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"s2d stem expects a 7x7 kernel, got {kh}x{kw}")
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 1, 0, 1, 0))
    k = k.reshape(kt, 4, 2, 4, 2, ci, co).permute(0, 1, 3, 2, 4, 5, 6)
    return k.reshape(kt, 4, 4, 4 * ci, co)


def block_kind(cfg: VisualNetConfig, stage: int) -> str:
    """The conv family of stage ``stage``'s blocks: "2plus1d" | "3d" |
    "no_temporal" (mc3 after stage 1). Raises on what the reference
    refuses: an unknown ``conv_mode``, and ``mid_mode`` other than "flops"
    with a plain family (midplanes exist only in the factorized one)."""
    if cfg.mid_mode != "flops" and cfg.conv_mode != "2plus1d":
        raise ValueError(
            f"mid_mode={cfg.mid_mode!r} has no effect with "
            f"conv_mode={cfg.conv_mode!r} (midplanes are a (2+1)D "
            "factorization concept) — drop one of the two")
    if cfg.conv_mode in ("2plus1d", "3d"):
        return cfg.conv_mode
    if cfg.conv_mode == "mc3":
        # mc3_18: full 3d in stage 1, spatial-only convs after
        return "3d" if stage == 0 else "no_temporal"
    raise ValueError(f"unknown conv_mode {cfg.conv_mode!r} "
                     f"(one of {CONV_MODES})")


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
    """Two convs of ``conv_kind`` ("2plus1d" | "3d" (3,3,3) | "no_temporal"
    (1,3,3)), each followed by BatchNorm, an optional SE branch, and a
    projected or identity shortcut."""

    def __init__(self, in_c: int, out_c: int, gen: torch.Generator,
                 stride=(1, 1, 1), bn_two_pass: bool = False,
                 se_ratio: int = 0, mid_mode: str = "flops",
                 conv_kind: str = "2plus1d"):
        super().__init__()
        self.stride = tuple(stride)
        self.conv_kind = conv_kind
        self.se_ratio = se_ratio
        if conv_kind == "2plus1d":
            # one midplane count per block, from (in_c, out_c), shared by
            # both convs (torchvision's recipe; checkpoint compatible)
            mid = midplanes(in_c, out_c, mode=mid_mode)
            conv1 = Conv2Plus1D(in_c, out_c, mid, gen, stride, bn_two_pass)
            conv2 = Conv2Plus1D(out_c, out_c, mid, gen, bn_two_pass=bn_two_pass)
        elif conv_kind in ("3d", "no_temporal"):
            k, pad = (((3, 3, 3), (1, 1, 1)) if conv_kind == "3d"
                      else ((1, 3, 3), (0, 1, 1)))
            conv1 = Conv(in_c, out_c, k, gen, strides=stride, padding=pad)
            conv2 = Conv(out_c, out_c, k, gen, padding=pad)
        else:
            raise ValueError(f"unknown conv_kind {conv_kind!r} "
                             "(2plus1d | 3d | no_temporal)")
        self.conv1 = conv1
        self.bn1 = BatchNorm(out_c, two_pass=bn_two_pass)
        self.conv2 = conv2
        self.bn2 = BatchNorm(out_c, two_pass=bn_two_pass)
        self.has_downsample = self.stride != (1, 1, 1) or in_c != out_c
        if self.has_downsample:
            self.down = Conv(in_c, out_c, (1, 1, 1), gen, strides=self.stride)
            self.bn_down = BatchNorm(out_c, two_pass=bn_two_pass)
        if se_ratio:
            r = max(out_c // se_ratio, 1)
            self.se = nn.ModuleDict({"fc1": Dense(out_c, r, gen),
                                     "fc2": Dense(r, out_c, gen)})

    def _conv(self, layer: nn.Module, x: torch.Tensor, train: bool):
        if isinstance(layer, Conv2Plus1D):
            return layer(x, train)
        return layer(x)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = relu(self.bn1(self._conv(self.conv1, x, train), train))
        y = self.bn2(self._conv(self.conv2, y, train), train)
        if self.se_ratio:
            # squeeze: mean over (T, H, W) in fp32 → [B, C]; excite: the
            # bottleneck MLP → a per-channel sigmoid gate in y's dtype
            w = y.float().mean(dim=(1, 2, 3))
            w = self.se["fc2"](relu(self.se["fc1"](w)))
            y = y * torch.sigmoid(w)[:, None, None, None, :].to(y.dtype)
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
        if cfg.conv_backend not in CONV_BACKENDS:
            raise ValueError(f"unknown visual.conv_backend {cfg.conv_backend!r}; "
                             f"the port knows {CONV_BACKENDS}, both of which "
                             "take the fused units")
        self.cfg = cfg
        two = cfg.bn_two_pass
        if cfg.conv_mode != "2plus1d":
            # torchvision's BasicStem (r3d_18 / mc3_18): ONE (3,7,7) conv
            self.stem = nn.ModuleDict({
                "conv1": Conv(3, cfg.stem_channels, (3, 7, 7), gen,
                              strides=(1, 2, 2), padding=(1, 3, 3)),
                "bn1": BatchNorm(cfg.stem_channels, two_pass=two),
            })
        else:
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
            kind = block_kind(cfg, si)
            for bi in range(n):
                if si > 0 and bi == 0:
                    # no-temporal stages downsample space only (torchvision
                    # Conv3DNoTemporal.get_downsample_stride)
                    stride = (1, 2, 2) if kind == "no_temporal" else (2, 2, 2)
                else:
                    stride = (1, 1, 1)
                blocks.append(BasicBlock(in_c, out_c, gen, stride, two,
                                         se_ratio=cfg.se_ratio,
                                         mid_mode=cfg.mid_mode,
                                         conv_kind=kind))
                in_c = out_c
        self.blocks = nn.ModuleList(blocks)

    def fused(self, blk: BasicBlock) -> bool:
        """Whether ``blk`` runs as fused conv units (the module doc's rule)."""
        return (self.cfg.conv_mode == "2plus1d" and not self.cfg.bn_two_pass
                and not blk.has_downsample and not blk.se_ratio)

    @property
    def fused_blocks(self) -> int:
        """How many blocks run as fused conv units."""
        return sum(self.fused(b) for b in self.blocks)

    def _stem_conv(self, clips: torch.Tensor) -> torch.Tensor:
        w = self.stem["conv1"].weight
        if not self.cfg.stem_s2d:
            return self.stem["conv1"](clips)
        # the same stem conv on 2x2-packed input; the checkpoint-layout
        # kernel is re-tiled on each call
        k = s2d_stem_kernel(w.permute(2, 3, 4, 1, 0))   # [kt,4,4,4ci,co]
        kt = k.shape[0]
        return conv(space_to_depth_hw(clips), k.permute(4, 3, 0, 1, 2),
                    padding=((kt // 2, kt // 2), (2, 1), (2, 1)))

    def forward(self, clips: torch.Tensor, per_frame: bool = False,
                train: bool = False) -> torch.Tensor:
        """clips [B, T, H, W, 3] → [B, C] (global pool) or, ``per_frame``,
        [B, T', C] (spatial pool only): T' = T / 2^(stages-1) for
        ``2plus1d`` / ``3d``, T for ``mc3``. ``train``: BatchNorm on the
        batch's statistics, its running buffers updated in place."""
        s = self.stem
        x = relu(s["bn1"](self._stem_conv(clips), train))
        if "conv2" in s:
            x = relu(s["bn2"](s["conv2"](x), train))
        for blk in self.blocks:
            x = blk.forward_fused(x, train) if self.fused(blk) else blk(x, train)
        if per_frame:
            return x.mean(dim=(2, 3))
        return global_avg_pool(x)
