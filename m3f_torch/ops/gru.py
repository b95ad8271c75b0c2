"""GRU recurrence: the plain PyTorch loop, the CUDA kernel and its gradient.

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
takes h rounded to the weights' compute dtype, accumulates in fp32 and
rounds the product to that dtype (bf16 weights: the reference's XLA scan;
fp32 weights: the reference's Pallas kernel); bias and gates are fp32.

Gradient: the reference has no backward kernel; its trainer differentiates
the ``lax.scan``. Here the forward runs the kernel (or the plain loop on the
CPU) and also returns the fp32 carries it kept; the backward is
backpropagation through time in PyTorch ops over those carries, with the
reference's roundings (the cotangent of the recurrent product rounded to the
compute dtype, each step's ``dW_hh`` rounded there too) and ``dW_hh``,
``db_hh`` accumulated in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from m3f_torch.ops import cuda_lib


def _lane_index(d: int, t: int, step: int, device) -> torch.Tensor:
    """[D] time index of each direction at ``step`` (lane 1 reversed)."""
    lanes = torch.arange(d, device=device)
    return torch.where(lanes == 1, t - 1 - step, step)


def _gates(x_t: torch.Tensor, hp: torch.Tensor, hdim: int):
    xr, xz, xn = x_t.split(hdim, dim=-1)
    hr, hz, hn = hp.split(hdim, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return r, z, n, hn


def gru_scan_reference(xp: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor, carries: bool = False):
    """The recurrence as a Python loop over time (see module doc); with
    ``carries`` also the fp32 h of every step, [B, T, D, H]."""
    b, t, d, h3 = xp.shape
    hdim = h3 // 3
    h = torch.zeros(b, d, hdim, dtype=torch.float32, device=xp.device)
    out = torch.empty(b, t, d, hdim, dtype=xp.dtype, device=xp.device)
    hs = torch.empty(b, t, d, hdim, dtype=torch.float32, device=xp.device) \
        if carries else None
    lanes = torch.arange(d, device=xp.device)
    for step in range(t):
        idx = _lane_index(d, t, step, xp.device)
        x_t = xp[:, idx, lanes].float()    # [B, D, 3H]
        hp = torch.einsum("bdh,dhg->bdg", h.to(w_hh.dtype), w_hh).float() \
            + b_hh[None]
        _, z, n, _ = _gates(x_t, hp, hdim)
        h = (1.0 - z) * n + z * h
        out[:, idx, lanes] = h.to(xp.dtype)
        if carries:
            hs[:, idx, lanes] = h
    return (out, hs) if carries else out


def _gru_forward(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                 carries: bool = False):
    """Plain loop on the CPU, one kernel launch for all directions on the
    card; ``carries`` as in ``gru_scan_reference``."""
    if xp.device.type == "cpu":
        return gru_scan_reference(xp, w_hh, b_hh, carries)
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
    hs = torch.empty(b, t, d, hdim, dtype=torch.float32, device=xp.device) \
        if carries else None
    with torch.cuda.device(xp.device):
        err = cuda_lib.library("gru").m3f_gru_fwd(
            xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            None if hs is None else hs.data_ptr(),
            b, t, hdim, d, int(xp.dtype == torch.bfloat16),
            int(w_hh.dtype == torch.bfloat16), cuda_lib.stream_ptr(xp))
    cuda_lib.check(err, "gru_scan kernel")
    cuda_lib.launches["gru"] += 1
    return (out, hs) if carries else out


def gru_bptt(gout: torch.Tensor, xp: torch.Tensor, w: torch.Tensor,
             b_hh: torch.Tensor, hs: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backpropagation through time → (dxp in xp's dtype, dW_hh fp32,
    db_hh fp32). ``w`` [D, H, 3H] is in the compute dtype of the recurrent
    product, ``hs`` the forward's fp32 carries, ``gout`` the output's
    cotangent [B, T, D, H]."""
    b, t, d, h3 = xp.shape
    hdim = h3 // 3
    lanes = torch.arange(d, device=xp.device)
    dxp = torch.empty_like(xp)
    dw = torch.zeros(d, hdim, h3, dtype=torch.float32, device=xp.device)
    db = torch.zeros(d, h3, dtype=torch.float32, device=xp.device)
    dh = torch.zeros(b, d, hdim, dtype=torch.float32, device=xp.device)
    wt = w.transpose(1, 2)                              # [D, 3H, H]
    for step in reversed(range(t)):
        idx = _lane_index(d, t, step, xp.device)
        if step > 0:
            h_prev = hs[:, _lane_index(d, t, step - 1, xp.device), lanes]
        else:
            h_prev = torch.zeros_like(dh)
        hw = h_prev.to(w.dtype)
        hp = torch.einsum("bdh,dhg->bdg", hw, w).float() + b_hh[None]
        r, z, n, hn = _gates(xp[:, idx, lanes].float(), hp, hdim)
        dh = dh + gout[:, idx, lanes].float()
        # h' = (1 - z)·n + z·h
        dn_pre = dh * (1.0 - z) * (1.0 - n * n)         # through tanh
        dz_pre = dh * (h_prev - n) * z * (1.0 - z)      # through sigmoid
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dxp[:, idx, lanes] = torch.cat([dr_pre, dz_pre, dn_pre], -1).to(xp.dtype)
        dhp = torch.cat([dr_pre, dz_pre, dn_pre * r], -1)   # [B, D, 3H] fp32
        db += dhp.sum(0)
        dot = dhp.to(w.dtype)
        dw += torch.einsum("bdh,bdg->dhg", hw, dot).float()
        dh = dh * z + torch.einsum("bdg,dgh->bdh", dot, wt).float()
    return dxp, dw, db


class _GRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, w_hh, b_hh, w_dtype):
        w = w_hh.to(w_dtype)
        out, hs = _gru_forward(xp, w, b_hh, carries=True)
        ctx.save_for_backward(xp, w, b_hh, hs)
        ctx.w_hh_dtype = w_hh.dtype
        return out

    @staticmethod
    def backward(ctx, gout):
        xp, w, b_hh, hs = ctx.saved_tensors
        dxp, dw, db = gru_bptt(gout, xp, w, b_hh, hs)
        return dxp, dw.to(ctx.w_hh_dtype), db, None


def gru_scan(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             w_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GRU recurrence (module doc), the recurrent product in ``w_dtype``
    (default: ``w_hh``'s dtype). Differentiable: with autograd on, the
    kernel also keeps the fp32 carries for ``gru_bptt``, and ``w_hh``'s
    gradient accumulates in fp32 across steps whatever ``w_dtype`` is."""
    w_dtype = w_dtype or w_hh.dtype
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (xp, w_hh, b_hh)):
        return _GRUScan.apply(xp, w_hh, b_hh, w_dtype)
    return _gru_forward(xp, w_hh.to(w_dtype), b_hh)
