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

Carried state: ``h0`` [B, D, H] fp32 is the carry each lane starts from
(None: zeros; lane 1 starts at the last time index) and ``last=True``
also returns the carry after each lane's last step, [B, D, H] fp32. A
sequence scanned in chunks, each from the carry the one before left, gives
the bits of one scan (the sequence-parallel BiGRU, ``parallel/seqpar.py``).

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

Two routes on the card (``gru_route``): ``"cluster"``, the kernel
``gru_cluster_kernel`` — one thread-block cluster per (direction, tile of 16
sequences), ``W_hh`` split by hidden unit over the cluster's blocks and kept
in shared memory for the whole sequence, h exchanged through distributed
shared memory with one cluster barrier a step (``gru_plan`` cuts the work)
— wherever a cluster's slice fits; ``"stream"``, the first design
(``gru_kernel``, ``W_hh`` read from the L2 every step), for the shapes it
does not. Each route has its own launch counter (``"gru"``, ``"gru_stream"``);
neither falls back to the other.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from m3f_torch.ops import cuda_lib

BM = 16                  # sequences a batch tile: the M of one mma.sync tile
NSLOT = 2                # xp ring slots (step t and t + 1)
SMEM_LIMIT = 232_448     # shared memory a block can use on an H100
MAX_THREADS = 512        # threads a block (unit groups x K parts)
CLUSTER_SIZES = (8, 16)  # 8 is portable; 16 only where 8 does not fit
# K parts a unit group, by w_bf16: fp32 W's FFMA product gains from 2 (1.088
# -> 0.893 ms at the serving shape on an H100), bf16 W's mma.sync does not
# (0.371 / 0.372; 4 parts 0.400; filter_sweep --kind gru, PERF.md §6)
KSPLIT = {True: 1, False: 2}


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def cluster_smem(h: int, units: int, w_bf16: bool, ksplit: int = 1) -> int:
    """Bytes of shared memory a block of the cluster walk takes
    (``cluster_layout`` in ``csrc/gru.cu``): the W slice (bf16: [3U][K+8],
    fp32: [K][3U]), two h buffers [16][K + 16 bytes] in W's dtype, the xp
    ring [2][16][3U] (bf16 with bf16 W, else sized for fp32) and, with K
    split over ``ksplit`` warps, their partial products [ksplit - 1][U/8][32
    lanes][12] fp32; K = H padded to a multiple of 32."""
    ws = 2 if w_bf16 else 4
    n = 3 * units
    kp = _round_up(h, 32)
    w_bytes = n * (kp + 8) * 2 if w_bf16 else kp * n * 4
    h_bytes = BM * (kp + 16 // ws) * ws
    x_bytes = NSLOT * BM * n * (2 if w_bf16 else 4)
    r_bytes = (ksplit - 1) * (units // 8) * 32 * 12 * 4
    return w_bytes + 2 * h_bytes + x_bytes + r_bytes


class GruPlan(NamedTuple):
    """How the cluster walk cuts a [B, T, D, 3H] recurrence: ``clusters`` =
    D x ``batch_tiles`` clusters of ``cluster`` blocks (grid (cluster,
    batch_tiles, D)), block r owning hidden units [r·units, (r+1)·units) of
    every gate; a block has units / 8 unit groups of ``ksplit`` warps each,
    which split K (``threads`` in all); ``fits`` is False where no cluster
    size fits (then the "stream" route runs)."""
    batch: int
    hidden: int
    directions: int
    cluster: int
    units: int
    ksplit: int
    bm: int
    batch_tiles: int
    clusters: int
    threads: int
    k_pad: int
    smem: int
    waves: int
    fits: bool

    def units_of(self, rank: int) -> range:
        """The hidden units block ``rank`` owns (those below H)."""
        return range(rank * self.units, min((rank + 1) * self.units, self.hidden))

    def k_range(self, part: int) -> range:
        """The k a warp of K part ``part`` multiplies (whole steps of 32)."""
        nk = self.k_pad // 32
        return range(part * nk // self.ksplit * 32,
                     (part + 1) * nk // self.ksplit * 32)

    def lanes(self, cluster: int, rank: int) -> List[Tuple[int, List[Tuple[int, int, int]]]]:
        """(thread, [(direction, sequence, unit), ...]) of every thread of
        block ``rank`` of cluster ``cluster`` (cluster = d · batch_tiles +
        tile), as the kernel maps them: warp w is unit group q = w % (U/8)
        and K part w // (U/8); the K part 0 warp of group q owns units
        8q..8q+7 of the block, its lane l the rows l/4 and l/4 + 8 of the
        tile and the units 8q + 2(l%4) + {0, 1}; masked rows and units, and
        the other K parts' warps, own nothing."""
        d, tile = divmod(cluster, self.batch_tiles)
        groups = self.units // 8
        out = []
        for tid in range(self.threads):
            warp, lane = divmod(tid, 32)
            q, part = warp % groups, warp // groups
            owned = []
            for i in range(2 if part == 0 else 0):
                b = tile * self.bm + lane // 4 + 8 * i
                for e in range(2):
                    j = rank * self.units + q * 8 + 2 * (lane % 4) + e
                    if b < self.batch and j < self.hidden:
                        owned.append((d, b, j))
            out.append((tid, owned))
        return out


def gru_plan(b: int, t: int, h: int, d: int, w_bf16: bool,
             sms: int = 132) -> GruPlan:
    """The cluster walk's cut of a recurrence of ``b`` sequences, ``t``
    steps, ``h`` hidden units and ``d`` directions with W_hh in bf16 or
    fp32: the first cluster size of ``CLUSTER_SIZES`` whose slice fits,
    U = ceil(H / C) rounded up to a multiple of 8, and as many blocks as
    own a unit (C = ceil(H / U) <= the size tried); K split over
    ``KSPLIT[w_bf16]`` warps a unit group, fewer where the threads or the
    partials' shared memory do not fit. H must be even (a lane's two units
    are one 4- or 8-byte word). ``t`` changes nothing: the walk keeps no
    time tile."""
    del t
    tiles = -(-b // BM)
    plan = None
    for size in CLUSTER_SIZES:
        units = _round_up(-(-h // size), 8)
        cluster = -(-h // units)
        ksplit = KSPLIT[w_bf16]
        while ksplit > 1 and (units // 8 * 32 * ksplit > MAX_THREADS or
                              cluster_smem(h, units, w_bf16, ksplit) > SMEM_LIMIT):
            ksplit //= 2
        smem = cluster_smem(h, units, w_bf16, ksplit)
        fits = (h % 2 == 0 and units // 8 * 32 <= MAX_THREADS
                and smem <= SMEM_LIMIT)
        plan = GruPlan(b, h, d, cluster, units, ksplit, BM, tiles, d * tiles,
                       units // 8 * 32 * ksplit, _round_up(h, 32), smem,
                       -(-(d * tiles * cluster) // sms), fits)
        if fits:
            break
    return plan


def gru_route(b: int, h: int, d: int, w_bf16: bool) -> str:
    """``"cluster"`` where ``gru_plan`` fits, else ``"stream"``."""
    return "cluster" if gru_plan(b, 1, h, d, w_bf16).fits else "stream"


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


def _result(out, hs, h_last):
    """``out``, or the tuple of ``out`` and those of the fp32 carries of
    every step and the final carry that were asked for."""
    extra = tuple(v for v in (hs, h_last) if v is not None)
    return (out,) + extra if extra else out


def _check_h0(h0: Optional[torch.Tensor], b: int, d: int, hdim: int,
              device) -> None:
    if h0 is not None and (tuple(h0.shape) != (b, d, hdim)
                           or h0.dtype != torch.float32
                           or h0.device != device):
        raise ValueError(f"gru_scan h0 must be fp32 [B, D, H] = "
                         f"{(b, d, hdim)} on {device}; got {tuple(h0.shape)} "
                         f"{h0.dtype} on {h0.device}")


def gru_scan_reference(xp: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor, carries: bool = False,
                       h0: Optional[torch.Tensor] = None, last: bool = False):
    """The recurrence as a Python loop over time (see module doc), each
    lane from ``h0`` (None: zeros); with ``carries`` also the fp32 h of
    every step, [B, T, D, H]; with ``last`` also the final carry [B, D,
    H]."""
    b, t, d, h3 = xp.shape
    hdim = h3 // 3
    _check_h0(h0, b, d, hdim, xp.device)
    h = torch.zeros(b, d, hdim, dtype=torch.float32, device=xp.device) \
        if h0 is None else h0.clone()
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
    return _result(out, hs, h if last else None)


def _gru_forward(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                 carries: bool = False, route: Optional[str] = None,
                 h0: Optional[torch.Tensor] = None, last: bool = False):
    """Plain loop on the CPU, one kernel launch for all directions on the
    card, on ``route`` (default: ``gru_route``'s choice; "stream" forces
    the first design, for timing); ``carries``, ``h0`` and ``last`` as in
    ``gru_scan_reference``."""
    if xp.device.type == "cpu":
        return gru_scan_reference(xp, w_hh, b_hh, carries, h0, last)
    cuda_lib.require_cuda("gru_scan", xp, w_hh, b_hh,
                          *(() if h0 is None else (h0,)))
    b, t, d, h3 = xp.shape
    hdim = h3 // 3
    _check_h0(h0, b, d, hdim, xp.device)
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
    w_bf16 = w_hh.dtype == torch.bfloat16
    plan = gru_plan(b, t, hdim, d, w_bf16)
    route = route or ("cluster" if plan.fits else "stream")
    xp, w_hh, b_hh = xp.contiguous(), w_hh.contiguous(), b_hh.contiguous()
    out = torch.empty(b, t, d, hdim, dtype=xp.dtype, device=xp.device)
    hs = torch.empty(b, t, d, hdim, dtype=torch.float32, device=xp.device) \
        if carries else None
    h0 = None if h0 is None else h0.contiguous()
    h_last = torch.empty(b, d, hdim, dtype=torch.float32, device=xp.device) \
        if last else None
    ptr = lambda v: None if v is None else v.data_ptr()
    args = (xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            ptr(hs), ptr(h0), ptr(h_last), b, t, hdim, d,
            int(xp.dtype == torch.bfloat16), int(w_bf16))
    lib = cuda_lib.library("gru")
    with torch.cuda.device(xp.device):
        if route == "cluster":
            if not plan.fits:
                raise ValueError(f"gru_scan: no cluster fits H={hdim} "
                                 f"(w_bf16={w_bf16}); take the stream route")
            err = lib.m3f_gru_cluster_fwd(*args, plan.cluster, plan.units,
                                          plan.ksplit, cuda_lib.stream_ptr(xp))
            counter = "gru"
        elif route == "stream":
            err = lib.m3f_gru_stream_fwd(*args, cuda_lib.stream_ptr(xp))
            counter = "gru_stream"
        else:
            raise ValueError(f"unknown gru route {route!r} (cluster | stream)")
    cuda_lib.check(err, f"gru_scan kernel ({route})")
    cuda_lib.launches[counter] += 1
    return _result(out, hs, h_last)


def gru_bptt(gout: torch.Tensor, xp: torch.Tensor, w: torch.Tensor,
             b_hh: torch.Tensor, hs: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             dh_last: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backpropagation through time → (dxp in xp's dtype, dW_hh fp32,
    db_hh fp32, dh0 fp32 [B, D, H]: the cotangent of the starting carry).
    ``w`` [D, H, 3H] is in the compute dtype of the recurrent product,
    ``hs`` the forward's fp32 carries, ``h0`` the carry it started from
    (None: zeros), ``gout`` the output's cotangent [B, T, D, H] and
    ``dh_last`` that of the final carry (None: zeros)."""
    b, t, d, h3 = xp.shape
    hdim = h3 // 3
    lanes = torch.arange(d, device=xp.device)
    dxp = torch.empty_like(xp)
    dw = torch.zeros(d, hdim, h3, dtype=torch.float32, device=xp.device)
    db = torch.zeros(d, h3, dtype=torch.float32, device=xp.device)
    dh = torch.zeros(b, d, hdim, dtype=torch.float32, device=xp.device) \
        if dh_last is None else dh_last.float().clone()
    wt = w.transpose(1, 2)                              # [D, 3H, H]
    for step in reversed(range(t)):
        idx = _lane_index(d, t, step, xp.device)
        if step > 0:
            h_prev = hs[:, _lane_index(d, t, step - 1, xp.device), lanes]
        elif h0 is not None:
            h_prev = h0
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
    return dxp, dw, db, dh


class _GRUScan(torch.autograd.Function):
    """The recurrence from ``h0`` (None: zeros), returning the output and
    the final carry; the backward takes both cotangents and returns that
    of ``h0`` too."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh, h0, w_dtype):
        w = w_hh.to(w_dtype)
        out, hs, h_last = _gru_forward(xp, w, b_hh, carries=True, h0=h0,
                                       last=True)
        ctx.save_for_backward(xp, w, b_hh, hs, h0)
        ctx.w_hh_dtype = w_hh.dtype
        return out, h_last

    @staticmethod
    def backward(ctx, gout, gh_last):
        xp, w, b_hh, hs, h0 = ctx.saved_tensors
        dxp, dw, db, dh0 = gru_bptt(gout, xp, w, b_hh, hs, h0, gh_last)
        return dxp, dw.to(ctx.w_hh_dtype), db, \
            None if h0 is None else dh0, None


def gru_scan(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             w_dtype: Optional[torch.dtype] = None,
             h0: Optional[torch.Tensor] = None, last: bool = False):
    """GRU recurrence (module doc), the recurrent product in ``w_dtype``
    (default: ``w_hh``'s dtype), each lane from ``h0`` (None: zeros); with
    ``last`` → (output, final carry). Differentiable (in ``h0`` too): with
    autograd on, the kernel also keeps the fp32 carries for ``gru_bptt``,
    and ``w_hh``'s gradient accumulates in fp32 across steps whatever
    ``w_dtype`` is."""
    w_dtype = w_dtype or w_hh.dtype
    leaves = (xp, w_hh, b_hh) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(v.requires_grad for v in leaves):
        out, h_last = _GRUScan.apply(xp, w_hh, b_hh, h0, w_dtype)
        return (out, h_last) if last else out
    return _gru_forward(xp, w_hh.to(w_dtype), b_hh, h0=h0, last=last)
