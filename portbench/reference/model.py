"""The plain reference of the M3T fusion model: float32 PyTorch, layer by
layer, from a dict of weights in the checkpoint's names and layouts.

    video [B, W, L, S, S, 3] uint8 / 255 → R(2+1)D-18 or R3D-18 (torchvision
    ``video/resnet.py``; BatchNorm, ReLU, per-frame spatial mean)
    wav   [B, W, spw] → log-mel (``mel.py``) → four stride-2 3x3 convs with
    BatchNorm and ReLU → mean over the mel axis → Dense
    both nearest-upsampled to L frames a window, concatenated (visual first)
    → bidirectional GRU over the W·L frames (torch ``nn.GRU`` gates r, z, n)
    → Dense → tanh → [B, W, L, 2]

Conv weights are [out, in, *kernel]; a Dense is ``x @ kernel + bias``; a
GRU direction has ``w_ih`` [D, 3H], ``w_hh`` [H, 3H], ``b_ih``, ``b_hh``.
BatchNorm is ``(x - mean) / sqrt(var + 1e-5) * scale + bias`` with the
running statistics, or, with ``train``, the batch's (biased variance).

``Ops`` carries the arithmetic: float32 (the reference), or the control,
which rounds the operands of every convolution and product, forward and
backward, to the precision below the configuration's (FP8 below bf16,
TF32 below fp32).
Nothing here reads or imports the program under test.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.mel import log_mel

BN_EPS = 1e-5
FP8_MAX = 448.0          # largest finite float8 e4m3fn


class Ops:
    """Convolutions and products in float32, or, as a control, with their
    operands rounded first to the precision below the configuration's, in
    the forward and in the backward: ``"fp8"`` (below bf16; the hybrid FP8
    recipe: inputs and weights in e4m3, gradients in e5m2, each tensor at
    a scale of its own) or ``"tf32"`` (below fp32: 10 mantissa bits, round
    to nearest)."""

    def __init__(self, control: str = ""):
        if control not in ("", "fp8", "tf32"):
            raise ValueError(f"unknown control {control!r}")
        self.control = control

    @classmethod
    def below(cls, compute_dtype: str) -> "Ops":
        """The control of a configuration computing in ``compute_dtype``."""
        return cls({"bfloat16": "fp8", "float32": "tf32"}[compute_dtype])

    def round(self, d: torch.Tensor, grad: bool = False) -> torch.Tensor:
        if self.control == "fp8":
            fmt, top = ((torch.float8_e5m2, 57344.0) if grad
                        else (torch.float8_e4m3fn, FP8_MAX))
            scale = d.abs().amax().clamp_min(1e-30) / top
            return (d / scale).to(fmt).float() * scale
        bits = d.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded in the forward; its gradient passes unchanged."""
        if not self.control:
            return x
        d = x.detach()
        return x + (self.round(d) - d)

    def g(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` unchanged; the gradient reaching it rounded."""
        if not self.control or not y.requires_grad:
            return y
        return _RoundGrad.apply(y, self)

    def conv(self, x, w, stride, padding):
        fn = F.conv3d if w.dim() == 5 else F.conv2d
        return self.g(fn(self.q(x), self.q(w), stride=stride, padding=padding))

    def mm(self, a, b):
        return self.g(self.q(a) @ self.q(b))


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, ops):
        ctx.ops = ops
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return ctx.ops.round(grad, grad=True), None


def bn(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str, train: bool,
       record: Optional[dict] = None) -> torch.Tensor:
    """BatchNorm over axis 1; ``record`` (with ``train``) keeps the batch's
    (mean, biased var) under ``name``."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        axes = (0,) + tuple(range(2, x.dim()))
        mean = x.mean(axes)
        var = x.var(axes, unbiased=False)
        if record is not None:
            record[name] = (mean.detach(), var.detach())
    else:
        mean, var = w[name + ".mean"], w[name + ".var"]
    inv = torch.rsqrt(var + BN_EPS) * w[name + ".scale"]
    return (x - mean.view(shape)) * inv.view(shape) + w[name + ".bias"].view(shape)


class Net:
    """The model's forward over the weights ``w`` and the ``model`` section
    of a configuration file. ``train``: BatchNorm on batch statistics;
    ``record``: a dict that receives every BatchNorm's batch statistics;
    ``ckpt``: recompute each residual block in the backward instead of
    keeping its activations (a train step of 128 clips fits the card)."""

    def __init__(self, w: Dict[str, torch.Tensor], model: dict,
                 ops: Optional[Ops] = None, train: bool = False,
                 record: Optional[dict] = None, ckpt: bool = False):
        self.w, self.m = w, model
        self.ops = ops or Ops()
        self.train, self.record, self.ckpt = train, record, ckpt

    def _bn(self, x, name):
        return bn(x, self.w, name, self.train, self.record)

    def _cbr(self, x, name, bn_name, stride, padding, act=True):
        y = self._bn(self.ops.conv(x, self.w[name], stride, padding), bn_name)
        return torch.relu(y) if act else y

    def _run(self, fn, x):
        if self.ckpt and torch.is_grad_enabled():
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)

    # -- visual -------------------------------------------------------------

    def _conv2plus1d(self, x, pre, s):
        y = self._cbr(x, pre + "spatial.weight", pre + "bn_mid", (1, s, s),
                      (0, 1, 1))
        return self.ops.conv(y, self.w[pre + "temporal.weight"], (s, 1, 1),
                             (1, 0, 0))

    def _block(self, x, pre, s):
        if self.m["visual"]["conv_mode"] == "2plus1d":
            y = torch.relu(self._bn(self._conv2plus1d(x, pre + "conv1.", s),
                                    pre + "bn1"))
            y = self._bn(self._conv2plus1d(y, pre + "conv2.", 1), pre + "bn2")
        else:
            y = self._cbr(x, pre + "conv1.weight", pre + "bn1", s, 1)
            y = self._cbr(y, pre + "conv2.weight", pre + "bn2", 1, 1,
                          act=False)
        if pre + "down.weight" in self.w:
            sc = self._cbr(x, pre + "down.weight", pre + "bn_down", s, 0,
                           act=False)
        else:
            sc = x
        return torch.relu(y + sc)

    def _stem(self, x):
        if self.m["visual"]["conv_mode"] == "2plus1d":
            x = self._cbr(x, "visual.stem.conv1.weight", "visual.stem.bn1",
                          (1, 2, 2), (0, 3, 3))
            return self._cbr(x, "visual.stem.conv2.weight", "visual.stem.bn2",
                             1, (1, 0, 0))
        return self._cbr(x, "visual.stem.conv1.weight", "visual.stem.bn1",
                         (1, 2, 2), (1, 3, 3))

    def visual(self, clips: torch.Tensor) -> torch.Tensor:
        """clips [N, L, S, S, 3] uint8 → per-frame features [N, L', C]."""
        v = self.m["visual"]
        x = clips.permute(0, 4, 1, 2, 3).float() / 255.0
        x = self._run(self._stem, x)
        i = 0
        for si, n in enumerate(v["blocks_per_stage"]):
            for bi in range(n):
                s = 2 if si > 0 and bi == 0 else 1
                pre = f"visual.blocks.{i}."
                x = self._run(lambda t, pre=pre, s=s: self._block(t, pre, s), x)
                i += 1
        return x.mean((3, 4)).transpose(1, 2)

    # -- audio --------------------------------------------------------------

    def audio(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [N, spw] → per-frame features [N, F', C]."""
        x = log_mel(wav, self.m["mel"])[:, None]        # [N, 1, frames, mels]
        for i in range(len(self.m["audio"]["channels"])):
            x = self._cbr(x, f"audio.conv.{i}.weight", f"audio.bn.{i}", 2, 1)
        feat = x.mean(3).transpose(1, 2)
        return self.ops.mm(feat, self.w["audio.head.kernel"]) \
            + self.w["audio.head.bias"]

    # -- fusion -------------------------------------------------------------

    def bigru(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, D] → [B, T, 2H]: each layer's forward ‖ backward lane."""
        hid = self.m["gru"]["hidden_size"]
        b, t, _ = x.shape
        for k in range(self.m["gru"]["num_layers"]):
            lanes = []
            for lane in ("fwd", "bwd"):
                pre = f"gru.layers.{k}.{lane}."
                xp = self.ops.mm(x, self.w[pre + "w_ih"]) + self.w[pre + "b_ih"]
                w_hh, b_hh = self.w[pre + "w_hh"], self.w[pre + "b_hh"]
                h = x.new_zeros(b, hid)
                out = [None] * t
                for step in (range(t) if lane == "fwd" else reversed(range(t))):
                    hp = self.ops.mm(h, w_hh) + b_hh
                    xr, xz, xn = xp[:, step].split(hid, -1)
                    hr, hz, hn = hp.split(hid, -1)
                    r = torch.sigmoid(xr + hr)
                    z = torch.sigmoid(xz + hz)
                    n = torch.tanh(xn + r * hn)
                    h = (1.0 - z) * n + z * h
                    out[step] = h
                lanes.append(torch.stack(out, 1))
            x = torch.cat(lanes, -1)
        return x

    def head(self, seq: torch.Tensor) -> torch.Tensor:
        out = self.ops.mm(seq, self.w["head.kernel"]) + self.w["head.bias"]
        return torch.tanh(out)

    def window_features(self, clips: torch.Tensor, wav: torch.Tensor
                        ) -> torch.Tensor:
        """One window each: clips [N, L, S, S, 3] and wav [N, spw] → the
        fused per-frame features [N, L, C_visual + C_audio]."""
        L = clips.shape[1]
        return torch.cat([upsample(self.visual(clips), L),
                          upsample(self.audio(wav), L)], -1)

    def sequences(self, feats: torch.Tensor, W: int) -> torch.Tensor:
        """Fused features [N·W, L, C] of N W-window sequences → the
        per-frame predictions [N, W, L, 2]."""
        nw, L, c = feats.shape
        seq = self.bigru(feats.reshape(nw // W, W * L, c))
        return self.head(seq).reshape(nw // W, W, L, -1)

    def forward(self, video: torch.Tensor, wav: torch.Tensor) -> torch.Tensor:
        """video [B, W, L, S, S, 3] uint8, wav [B, W, spw] → [B, W, L, 2]."""
        b, W = video.shape[:2]
        feats = self.window_features(video.reshape((b * W,) + video.shape[2:]),
                                     wav.reshape(b * W, -1))
        return self.sequences(feats, W)


def upsample(x: torch.Tensor, length: int) -> torch.Tensor:
    """Nearest [N, T', C] → [N, length, C]: frame l takes ⌊l·T'/length⌋."""
    tp = x.shape[1]
    idx = (torch.arange(length, device=x.device) * tp) // length
    return x.index_select(1, idx)


def is_buffer(name: str, names) -> bool:
    """A BatchNorm running statistic (not trained)."""
    base, _, leaf = name.rpartition(".")
    return leaf in ("mean", "var") and base + ".scale" in names
