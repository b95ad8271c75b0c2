"""Bidirectional multi-layer GRU head (torch ``nn.GRU`` equations).

Counterpart of ``m3f/pytorch_tpu/models/gru.py``. Per layer, the input
projection ``x @ W_ih + b_ih`` of all time steps is one matmul over both
directions' concatenated weights (left to cuBLAS, as the reference leaves it
to XLA); the recurrence is ``ops.gru.gru_scan``: one CUDA kernel launch per
layer for both directions on the card, the plain loop on the CPU; under
autograd its gradient is backpropagation through time (``ops.gru``).

``backend`` keeps the reference's two numerics: ``"xla"`` (default) runs the
recurrent product with ``W_hh`` in the compute dtype, ``"pallas"`` with fp32
``W_hh``. The unidirectional GRU follows the reference's XLA scan whatever
the backend.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from m3f_torch.nn import fan_in_uniform
from m3f_torch.ops.gru import gru_scan


class GRUCell(nn.Module):
    """One direction's weights in the reference layout: w_ih [D, 3H],
    w_hh [H, 3H], b_ih, b_hh [3H], gate order (r, z, n)."""

    def __init__(self, in_dim: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.w_ih = nn.Parameter(fan_in_uniform(gen, (in_dim, 3 * hidden), hidden))
        self.w_hh = nn.Parameter(fan_in_uniform(gen, (hidden, 3 * hidden), hidden))
        self.b_ih = nn.Parameter(fan_in_uniform(gen, (3 * hidden,), hidden))
        self.b_hh = nn.Parameter(fan_in_uniform(gen, (3 * hidden,), hidden))


class BiGRU(nn.Module):
    def __init__(self, in_dim: int, hidden: int, gen: torch.Generator,
                 num_layers: int = 1, backend: str = "xla",
                 bidirectional: bool = True):
        super().__init__()
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown gru backend {backend!r} (xla | pallas)")
        self.hidden, self.backend, self.bidirectional = hidden, backend, bidirectional
        out_mult = 2 if bidirectional else 1
        dims = [in_dim] + [out_mult * hidden] * (num_layers - 1)
        layers: List[nn.Module] = []
        for d in dims:
            layer = nn.ModuleDict({"fwd": GRUCell(d, hidden, gen)})
            if bidirectional:
                layer["bwd"] = GRUCell(d, hidden, gen)
            layers.append(layer)
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] → [B, T, 2H] (forward ‖ backward) or [B, T, H]."""
        b, t, _ = x.shape
        h = x
        for layer in self.layers:
            cells = [layer["fwd"]] + ([layer["bwd"]] if self.bidirectional else [])
            d = len(cells)
            dtype = h.dtype
            w_ih = torch.cat([c.w_ih for c in cells], dim=1).to(dtype)
            b_ih = torch.cat([c.b_ih for c in cells]).to(dtype)
            xp = (h @ w_ih + b_ih).reshape(b, t, d, 3 * self.hidden)
            w_dtype = torch.float32 \
                if self.backend == "pallas" and self.bidirectional else dtype
            w_hh = torch.stack([c.w_hh for c in cells])
            b_hh = torch.stack([c.b_hh for c in cells]).float()
            h = gru_scan(xp, w_hh, b_hh, w_dtype).reshape(b, t, d * self.hidden)
        return h
