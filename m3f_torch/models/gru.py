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

Tensor parallelism (``tp``, the model axis; ``parallel/mesh.py``): each
rank holds the column block of every gate matrix and bias (``w_ih`` /
``w_hh`` [D, 3H/n], ``b_ih`` / ``b_hh`` [3H/n]). The input projection runs
column-parallel, ``h @ w_ih_block + b_ih_block``, and its blocks are
gathered into the full ``xp``; ``W_hh`` and ``b_hh`` are gathered once a
forward, and the recurrence runs at full width on every rank of the axis
(the gathers' backward takes the rank's own block of the full gradient,
which every rank computes alike). The gradient of the layer's input sums
the blocks' shares over the axis (``spread``).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from m3f_torch.nn import fan_in_uniform
from m3f_torch.ops.gru import gru_scan
from m3f_torch.parallel.mesh import gather_blocks, spread


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
        self.tp = None             # the model axis when the gates are sharded
        out_mult = 2 if bidirectional else 1
        dims = [in_dim] + [out_mult * hidden] * (num_layers - 1)
        layers: List[nn.Module] = []
        for d in dims:
            layer = nn.ModuleDict({"fwd": GRUCell(d, hidden, gen)})
            if bidirectional:
                layer["bwd"] = GRUCell(d, hidden, gen)
            layers.append(layer)
        self.layers = nn.ModuleList(layers)

    def cells(self, layer: nn.ModuleDict) -> List[GRUCell]:
        return [layer["fwd"]] + ([layer["bwd"]] if self.bidirectional else [])

    def w_dtype(self, dtype: torch.dtype) -> torch.dtype:
        """The dtype of the recurrent product for activations of ``dtype``."""
        return torch.float32 \
            if self.backend == "pallas" and self.bidirectional else dtype

    def project(self, cells, h: torch.Tensor, weight=lambda p: p
                ) -> torch.Tensor:
        """The input projection of ``cells`` (one layer's directions) on h
        [B, T, D_in] → xp [B, T, directions, 3H], one product for all
        directions (column-parallel and gathered under ``tp``); ``weight``
        maps each parameter first."""
        b, t, _ = h.shape
        dtype = h.dtype
        if self.tp is not None:
            # each rank's column block reaches h: its gradient is the sum
            h = spread(h, self.tp)
        w_ih = torch.cat([weight(c.w_ih) for c in cells], dim=1).to(dtype)
        b_ih = torch.cat([weight(c.b_ih) for c in cells]).to(dtype)
        xp = (h @ w_ih + b_ih).reshape(b, t, len(cells), -1)
        return gather_blocks(xp, self.tp)

    def recurrent(self, cells, weight=lambda p: p):
        """(W_hh [directions, H, 3H], b_hh fp32 [directions, 3H]) of one
        layer, gathered whole under ``tp``."""
        w_hh = torch.stack([weight(c.w_hh) for c in cells])
        b_hh = torch.stack([weight(c.b_hh) for c in cells]).float()
        return gather_blocks(w_hh, self.tp), gather_blocks(b_hh, self.tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] → [B, T, 2H] (forward ‖ backward) or [B, T, H]."""
        b, t, _ = x.shape
        h = x
        for layer in self.layers:
            cells = self.cells(layer)
            xp = self.project(cells, h)
            w_hh, b_hh = self.recurrent(cells)
            h = gru_scan(xp, w_hh, b_hh, self.w_dtype(h.dtype)).reshape(
                b, t, len(cells) * self.hidden)
        return h
