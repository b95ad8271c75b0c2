"""Audio branch: 2-D CNN over log-mel windows, channels-last.

Counterpart of ``m3f/pytorch_tpu/models/audio.py``: stride-2 3×3 convs with
explicit (1, 1) padding, each followed by BatchNorm and ReLU, then a Dense
head per time step (per-frame mode) or on the pooled feature.
"""

from __future__ import annotations

import torch
from torch import nn

from m3f_torch.config import AudioNetConfig
from m3f_torch.nn import BatchNorm, Conv, Dense, global_avg_pool, relu


class AudioCNN(nn.Module):
    def __init__(self, cfg: AudioNetConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        convs, bns = [], []
        in_c = 1
        for out_c in cfg.channels:
            convs.append(Conv(in_c, out_c, (3, 3), gen, strides=(2, 2),
                              padding=(1, 1)))
            bns.append(BatchNorm(out_c, two_pass=cfg.bn_two_pass))
            in_c = out_c
        self.conv = nn.ModuleList(convs)
        self.bn = nn.ModuleList(bns)
        self.head = Dense(in_c, cfg.feature_dim, gen)

    def forward(self, mel: torch.Tensor, per_frame: bool = False,
                train: bool = False) -> torch.Tensor:
        """mel [B, mel_frames, n_mels] → [B, feature_dim], or with
        ``per_frame`` [B, F', feature_dim] (only the mel axis pooled).
        ``train``: BatchNorm on the batch's statistics."""
        x = mel[..., None]                       # NHWC, C = 1
        for conv, bn in zip(self.conv, self.bn):
            x = relu(bn(conv(x), train))
        feat = x.mean(dim=2) if per_frame else global_avg_pool(x)
        return self.head(feat)
