"""GRU recurrence: the plain PyTorch loop and the CUDA kernel.

Counterpart of the recurrence in ``m3f/pytorch_tpu/models/gru.py``
(``_gru_scan`` and the batched two-direction ``lax.scan`` of
``BiGRU.apply``) and of ``ops/pallas/gru_pallas.py::gru_scan_pallas``; the
kernel is ``csrc/gru.cu``.

Layout: ``xp`` [B, T, D, 3H] holds ``x@W_ih + b_ih`` of D directions
(gate order r, z, n), ``w_hh`` [D, H, 3H], ``b_hh`` [D, 3H] fp32; the
result is [B, T, D, H] in ``xp``'s dtype — the directions' concatenation
[B, T, D·H] as a view. With D = 2 the second direction runs backwards in
time, read and written at reversed indices, so nothing is flipped.

Numerics of both versions: h is carried in fp32; the recurrent product
takes h rounded to ``w_hh``'s dtype, accumulates in fp32 and rounds the
product to ``w_hh``'s dtype (bf16 weights: the reference's XLA scan; fp32
weights: the reference's Pallas kernel); bias and gates are fp32.
"""

from __future__ import annotations

import torch

from m3f_torch.ops import cuda_lib


def gru_scan_reference(xp: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor) -> torch.Tensor:
    """The recurrence as a Python loop over time (see module doc)."""
    b, t, d, h3 = xp.shape
    hdim = h3 // 3
    h = torch.zeros(b, d, hdim, dtype=torch.float32, device=xp.device)
    out = torch.empty(b, t, d, hdim, dtype=xp.dtype, device=xp.device)
    lanes = torch.arange(d, device=xp.device)
    rev = lanes == 1                                 # per-direction reversal
    for step in range(t):
        idx = torch.where(rev, t - 1 - step, step)   # [D] time index
        x_t = xp[:, idx, lanes].float()    # [B, D, 3H]
        hp = torch.einsum("bdh,dhg->bdg", h.to(w_hh.dtype), w_hh).float() \
            + b_hh[None]
        xr, xz, xn = x_t.split(hdim, dim=-1)
        hr, hz, hn = hp.split(hdim, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out[:, idx, lanes] = h.to(xp.dtype)
    return out


def gru_scan(xp: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor) -> torch.Tensor:
    """GRU recurrence (module doc): plain loop on the CPU, one kernel launch
    for all directions on the card."""
    if xp.device.type == "cpu":
        return gru_scan_reference(xp, w_hh, b_hh)
    cuda_lib.require_cuda("gru_scan", xp, w_hh, b_hh)
    b, t, d, h3 = xp.shape
    hdim = h3 // 3
    ok = (h3 == 3 * hdim and d in (1, 2)
          and tuple(w_hh.shape) == (d, hdim, h3) and tuple(b_hh.shape) == (d, h3)
          and xp.dtype in (torch.float32, torch.bfloat16)
          and w_hh.dtype in (xp.dtype, torch.float32)
          and b_hh.dtype == torch.float32)
    if not ok:
        raise ValueError(
            f"gru_scan kernel takes xp [B,T,D,3H] f32/bf16, w_hh [D,H,3H] in "
            f"xp's dtype or f32, b_hh [D,3H] f32; got {tuple(xp.shape)} {xp.dtype}, "
            f"{tuple(w_hh.shape)} {w_hh.dtype}, {tuple(b_hh.shape)} {b_hh.dtype}")
    xp, w_hh, b_hh = xp.contiguous(), w_hh.contiguous(), b_hh.contiguous()
    out = torch.empty(b, t, d, hdim, dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        err = cuda_lib.library("gru").m3f_gru_fwd(
            xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            b, t, hdim, d, int(xp.dtype == torch.bfloat16),
            int(w_hh.dtype == torch.bfloat16), cuda_lib.stream_ptr(xp))
    cuda_lib.check(err, "gru_scan kernel")
    cuda_lib.launches["gru"] += 1
    return out
