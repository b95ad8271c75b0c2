"""M3F: late-fusion audio-visual valence-arousal model.

Counterpart of ``m3f/pytorch_tpu/models/m3f.py``:

    video [B, W, L, S, S, 3] uint8 → R(2+1)D → per-frame features
    wav   [B, W, samples]          → log-mel → AudioCNN → per-frame features
    nearest upsample to L frames per window → concat (visual ‖ audio)
    → BiGRU over the W·L frame sequence → Dense (fp32) → tanh
    → [B, W, L, 2] (per_frame) or [B, W, 2]

``forward`` is the eval forward (``apply(..., train=False)``, under
``torch.no_grad``); ``forward_train`` the differentiable train forward
(``train=True``): BatchNorm on batch statistics, its running buffers updated
in place, and with ``model.dropout > 0`` inverted dropout on the fused
features (before the BiGRU) and on the GRU output (before the head), the
two keep masks drawn in that order from the caller's ``torch.Generator``
by ``dropout_mask`` (within a data-parallel step, for the global batch, of
which each rank keeps its rows). The reference's random stream cannot be
matched; its masks can be fed in by replacing ``dropout_mask``. Eval
ignores dropout.
With ``model.compute_dtype="float32"`` on the card both run inside
``precision()`` (``nn.full_fp32``): no TF32 in cuDNN's convs or cuBLAS's
products, as the reference computes them in fp32.

``shard(tp)`` makes the model tensor-parallel over the model axis
(``parallel/mesh.py`` ``TensorParallel``): each sharded parameter becomes
the rank's block, the BiGRU runs column-parallel (``models/gru.py``) and
the fusion head row-parallel: each rank multiplies its feature block of the
fp32 GRU output by its row block of the kernel, the partial products are
summed over the axis and the bias is added once, after the sum (backward:
the output's gradient passes through, and the feature blocks' gradients are
gathered into the GRU output's, which every rank holds whole).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from m3f_torch.config import ModelConfig
from m3f_torch.models.audio import AudioCNN
from m3f_torch.models.gru import BiGRU
from m3f_torch.models.r2plus1d import R2Plus1D
from m3f_torch.nn import Dense, compute_dtype, full_fp32, resolve_device
from m3f_torch.ops.melspec import log_mel_spectrogram
from m3f_torch.parallel.mesh import (TensorParallel, global_rows, model_sum,
                                     take_block)


def upsample_nearest(x: torch.Tensor, length: int) -> torch.Tensor:
    """[B, T', C] → [B, length, C] with idx[l] = ⌊l·T'/length⌋."""
    tp = x.shape[1]
    if tp == length:
        return x
    idx = (torch.arange(length, device=x.device) * tp) // length
    return x.index_select(1, idx)


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Keep mask of inverted dropout: ``rand < 1 - rate``, drawn from
    ``generator`` (a generator on ``device``)."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def _keep_mask(x: torch.Tensor, rate: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """``dropout_mask`` for x's rows: within a data-parallel step drawn for
    the global batch, of which this rank keeps its rows."""
    n, rows = global_rows(x.shape[0])
    return dropout_mask((n,) + tuple(x.shape[1:]), rate, generator,
                        x.device)[rows]


def apply_dropout(x: torch.Tensor, keep: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` in x's dtype, the reference's
    rounding: the divisor is rounded to x's dtype first."""
    div = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / div, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


class M3F(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        """Random fan-in init from ``generator`` (default: seed 0), on
        ``device``; a CUDA device without a GPU raises."""
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        self.audio = AudioCNN(cfg.audio, gen) if cfg.use_audio else None
        self.visual = R2Plus1D(cfg.visual, gen) if cfg.use_video else None
        self.gru = BiGRU(cfg.fused_dim, cfg.gru.hidden_size, gen,
                         cfg.gru.num_layers, backend=cfg.gru.backend,
                         bidirectional=cfg.gru.bidirectional)
        head_in = (2 if cfg.gru.bidirectional else 1) * cfg.gru.hidden_size
        self.head = Dense(head_in, cfg.num_outputs, gen)
        self.head_tp = None      # the model axis when the head is sharded
        self.to(dev)
        self.eval()

    def shard(self, tp: TensorParallel) -> None:
        """Keep only this rank's block of each parameter ``tp`` shards (new
        parameters, in place of the full ones), and run the BiGRU and the
        fusion head tensor-parallel over ``tp.axis``."""
        for name, p in list(self.named_parameters()):
            if tp.sharded(name):
                owner, _, leaf = name.rpartition(".")
                setattr(self.get_submodule(owner), leaf,
                        nn.Parameter(tp.block(name, p.data)))
        if any(n.startswith("gru.") for n in tp.dims):
            self.gru.tp = tp.axis
        if tp.sharded("head.kernel"):
            self.head_tp = tp.axis

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """The fusion head on the fp32 GRU output (row-parallel under
        ``shard``)."""
        if self.head_tp is None:
            return self.head(x)
        part = take_block(x, self.head_tp) @ self.head.kernel
        return model_sum(part, self.head_tp) + self.head.bias

    @torch.no_grad()
    def forward(self, video: Optional[torch.Tensor] = None,
                mel: Optional[torch.Tensor] = None,
                wav: Optional[torch.Tensor] = None,
                hop=None) -> torch.Tensor:
        """Eval forward. ``wav`` [B, W, samples] goes through the log-mel
        frontend (``hop``: per-video mel hop with a max-hop-sized buffer);
        ``mel`` [B, W, F, n_mels] skips it."""
        with self.precision():
            return self._run(video, mel, wav, hop, train=False)

    def forward_train(self, video: Optional[torch.Tensor] = None,
                      mel: Optional[torch.Tensor] = None,
                      wav: Optional[torch.Tensor] = None,
                      hop=None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Differentiable train forward (inputs as ``forward``); with
        ``model.dropout > 0`` its two masks come from ``generator`` (on the
        inputs' device; None: the global stream)."""
        with self.precision():
            return self._run(video, mel, wav, hop, train=True,
                             generator=generator)

    def precision(self):
        """``nn.full_fp32`` for an fp32 model on the card, else nothing: a
        forward (and a train step's backward) inside it keeps fp32 convs
        and products in fp32."""
        if self.dtype == torch.float32 and self.head.kernel.is_cuda:
            return full_fp32()
        return contextlib.nullcontext()

    def _run(self, video, mel, wav, hop, train: bool,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        if self.audio is not None and mel is None and wav is not None:
            mel = log_mel_spectrogram(
                wav, cfg.mel, out_dtype=self.dtype, hop=hop,
                n_frames_out=(cfg.audio.mel_frames_per_window
                              if hop is not None else None))
        per_frame = cfg.per_frame
        if per_frame:
            L = video.shape[2] if video is not None else cfg.frames_per_window
        feats = []
        if self.visual is not None:
            if video is None:
                raise ValueError("model configured with use_video=True needs video")
            b, w = video.shape[:2]
            flat = video.reshape((b * w,) + video.shape[2:])
            if flat.dtype == torch.uint8:
                flat = flat.to(self.dtype) / 255.0
            else:
                flat = flat.to(self.dtype)
            vfeat = self.visual(flat, per_frame=per_frame, train=train)
            if per_frame:
                feats.append(upsample_nearest(vfeat, L).reshape(b, w * L, -1))
            else:
                feats.append(vfeat.reshape(b, w, -1))
        if self.audio is not None:
            if mel is None:
                raise ValueError("model configured with use_audio=True needs "
                                 "wav or mel")
            b, w = mel.shape[:2]
            flat = mel.reshape((b * w,) + mel.shape[2:]).to(self.dtype)
            afeat = self.audio(flat, per_frame=per_frame, train=train)
            if per_frame:
                feats.append(upsample_nearest(afeat, L).reshape(b, w * L, -1))
            else:
                feats.append(afeat.reshape(b, w, -1))
        fused = torch.cat(feats, dim=-1)
        rate = cfg.dropout if train else 0.0
        if rate > 0.0:
            fused = apply_dropout(fused, _keep_mask(fused, rate, generator),
                                  rate)
        seq = self.gru(fused)
        if rate > 0.0:
            seq = apply_dropout(seq, _keep_mask(seq, rate, generator), rate)
        out = self._head(seq.float())
        if cfg.head_activation == "tanh":
            out = torch.tanh(out)
        if per_frame:
            out = out.reshape(out.shape[0], -1, L, out.shape[-1])
        return out
