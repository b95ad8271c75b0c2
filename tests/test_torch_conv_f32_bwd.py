"""The fp32 conv-unit backward (``spatial_data_f32_kernel``,
``temporal_data_f32_kernel``, ``bwd_data_f32_kernel``,
``spatial_filter_f32_kernel`` and ``bwd_filter_f32_kernel`` in
m3f_torch/csrc/conv_bn_f32.cu, wrapped by
``ops.conv_bn.conv_unit_bwd_data`` / ``conv_unit_bwd_filter`` for fp32 x)
where a CPU can hold it: a numpy run of each kernel's walk against the JAX
package's Pallas backward in fp32 under interpret mode (``_spatial_bwd`` /
``_temporal_bwd``, as tests/test_torch_conv_bn_bwd.py runs them; a clip of
one frame against the XLA composition ``_xla_bwd``, since the Pallas
temporal units need two frames) and against the port's plain version, at
the forward's EMU_CASES, at FILTER_CASES, DATA_CASES and TDF_CASES with
and without the prologue; the tilings (``f32_bwd_data_plan``,
``f32_spatial_data_plan``, ``f32_temporal_data_plan``,
``f32_bwd_filter_plan``, ``f32_spatial_filter_plan``) at every fused unit's
train shape, the walks' shared-memory formulas against the C source's; and
the plain versions' convs run without TF32. The kernels themselves run only on the card
(chip_smoke.py, phase kernel_conv_f32_bwd).

Spatial data row walk: ranges of whole images, each a stream of rows (a
zero row before every image and after the last, zero columns 0 and W+1),
steps of S output pixels reading the rows from the one above the first
pixel to the one below the last, K in chunks of 16 or 8 output channels
for all nine taps (ge folded on real pixels and channels < C_out only, 0
elsewhere) at one offset per pixel plus (dh·(W+2) + dw) against the
mirrored filter; the chunks of each range cut into K splits, each split's
partial dx^ summed in split order. With one split the walk applies the
two-rounding xa, the mask and dx = dxa * inv and sums dinv / dshift by
pixel group over the walk, then the groups in order into one partial row a
range; with several the second pass does, one partial row per 64
positions; the rows summed in order.
Temporal data frame walk: strips of the flattened B·H·W axis (across clips
where H·W is small) walked over T, ranges of strips; frame t's ge in
chunks of 16 output channels (folded on the strip's positions and channels
< C_out only, 0 elsewhere) multiplied into dx^ frames t+1, t and t-1
against the mirrored filter's taps 0, 1 and 2, a tap whose frame lies
outside the clip skipped; then the two-rounding xa, the mask, dx = dxa *
inv, dinv / dshift by position group over the walk, the groups in order
into one partial row a range, the rows in colsum order.
Data gather (spatial images too wide for the row walk):
tiles of 64 positions x 64 input channels, K in chunks of 16 output
channels of one tap, ge formed at the gather from gy, y, gs1 and gs2 at the
tap's neighbour (0 in the padding and past C_out) against the filter's
mirrored tap, then the two-rounding xa, the mask, dx = dxa * inv and one
partial row of dinv / dshift per range of tiles, summed in order.
Spatial filter row walk: slices of whole images, each a stream of rows (a
zero row before every image and after the last, zero columns 0 and W+1)
held in a ring of two steps' rows, each row copied and formed once (x^
through the prologue on real pixels and channels only), steps of S output
pixels whose ge is folded once (0 past the slice and C_out), each tap an
offset of the step's table, one [9·16, N tile] of sums a block, the
partials summed in slice order. Filter gather (the temporal kind, and
images too wide for the walk): slices of chunks of 16 positions, x^ formed
at the gather (0 in the padding), ge at the load, one partial [K, C_out] a
slice, the partials summed in slice order.

Tolerances: dx per element within 2e-5 of its largest magnitude (fp32 sums
in another order over K up to 648); dw per element within 1e-5 of
sum |x^|*|ge| plus 1e-6 of that sum's largest (the form of
tests/test_torch_conv_bn_bwd.py); dinv / dshift per channel rtol 1e-4, plus
1e-5 of sum |x * dxa| (sum |dxa|) for channels whose terms cancel."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import m3f.pytorch_tpu.ops.pallas.conv_bn as jcb
from m3f_torch.ops import conv_bn
from test_torch_conv_f32 import EMU_CASES, SMS, _colsum, _unit_shapes

DX_TOL = 2e-5
DW_REL, DW_ABS = 1e-5, 1e-6
S_RTOL, S_REL = 1e-4, 1e-5
KC = 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fold(gy, y, gs1, gs2):
    """ge = gy + (gs1 + (2 y) gs2), fp32, each op rounded (numpy float32
    arithmetic rounds every op; no fused multiply-add)."""
    return gy + (gs1 + (np.float32(2) * y) * gs2)


def _neighbour(kind, m, tap, t, h, w):
    """(source position, inside) of the neighbour of positions ``m`` that
    ``tap`` reads, as the kernels' ``neighbour<KIND>``."""
    img, r = m // (h * w), m % (h * w)
    gh, gw, gt = r // w, r % w, img % t
    if kind == "spatial":
        dh, dw = tap // 3 - 1, tap % 3 - 1
        ok = (gh + dh >= 0) & (gh + dh < h) & (gw + dw >= 0) & (gw + dw < w)
        src = m + dh * w + dw
    else:
        ok = (gt + tap - 1 >= 0) & (gt + tap - 1 < t)
        src = m + (tap - 1) * h * w
    return np.where(ok, src, 0), ok


def _emulate_data(x, w, inv, shift, y, gy, gs1, gs2, sms=SMS):
    """bwd_data_f32_kernel's walk (spatial only: where no row-walk layout
    fits the images) in numpy (fp32): returns (dx, dinv, dshift)."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    plan = conv_bn.f32_bwd_data_plan(b, t, h, wd, ci, sms)
    m_all = b * t * h * wd
    wt = conv_bn.f32_bwd_data_filter(torch.from_numpy(w), "spatial").numpy()
    gyf, yf = gy.reshape(m_all, co), y.reshape(m_all, co)
    m = np.arange(plan.m_tiles * 64)
    ok_m = m < m_all
    nck = -(-co // KC)
    acc = np.zeros((len(m), plan.n_tiles * 64), np.float32)
    for step in range(9 * nck):
        tap, c0 = divmod(step, nck)
        cs = np.arange(c0 * KC, min(c0 * KC + KC, co))
        src, ok = _neighbour("spatial", np.minimum(m, m_all - 1), tap, t, h,
                             wd)
        ok &= ok_m
        a = np.zeros((len(m), KC), np.float32)
        a[:, :len(cs)] = np.where(ok[:, None], _fold(
            gyf[src][:, cs], yf[src][:, cs], gs1[cs], gs2[cs]), 0)
        bm = np.zeros((KC, plan.n_tiles * 64), np.float32)
        bm[:len(cs), :ci] = wt[tap * co + cs]
        acc += a @ bm
    dxh = acc[:m_all, :ci]
    if inv is None:
        return dxh.reshape(x.shape), None, None
    xf = x.reshape(m_all, ci)
    xa = (xf * inv) + shift
    dxa = np.where(xa > 0, dxh, np.float32(0))
    span = plan.tiles_per_range * 64
    dinv = np.zeros(ci, np.float32)
    dshift = np.zeros(ci, np.float32)
    for r in range(plan.ranges):             # one partial row per range
        q = slice(r * span, (r + 1) * span)
        dinv = dinv + (xf[q] * dxa[q]).sum(0)
        dshift = dshift + dxa[q].sum(0)
    return (dxa * inv).reshape(x.shape), dinv, dshift


def _emulate_dx(x, w, inv, shift, y, gy, gs1, gs2, kind, sms=None):
    """The data gradient's walk in numpy (fp32), as the wrapper routes it:
    the temporal frame walk; the spatial row walk where its plan has a
    layout, else the per-tap gather; returns (dx, dinv, dshift)."""
    if kind == "temporal":
        plan = conv_bn.f32_temporal_data_plan(
            *x.shape, gy.shape[-1], sms or TDF_SMS.get(x.shape, SMS),
            inv is not None)
        return _emulate_temporal_data_walk(x, w, inv, shift, y, gy, gs1, gs2,
                                           plan)[:3]
    sms = sms or DATA_SMS.get(x.shape, SMS)
    plan = conv_bn.f32_spatial_data_plan(*x.shape, gy.shape[-1], sms)
    if plan is not None:
        return _emulate_data_walk(x, w, inv, shift, y, gy, gs1, gs2, plan)[:3]
    return _emulate_data(x, w, inv, shift, y, gy, gs1, gs2, sms)


def _emulate_data_walk(x, w, inv, shift, y, gy, gs1, gs2, plan, pad=None,
                       leak=False):
    """spatial_data_f32_kernel's walk and, with K splits, its second pass:
    per range of whole images a stream of rows (a zero row before every
    image and after the last, zero columns 0 and W+1; ge folded on real
    pixels and channels < C_out only), each split's chunks of
    ``plan.k_chunk`` output channels in order, steps of ``plan.step``
    output pixels reading each tap at the pixel's row above plus (dh, dw)
    against the mirrored filter's rows (tap, k); the splits' partial dx^
    summed in split order. With the prologue, one split: dinv / dshift by
    pixel group p % (step / 8) over the range's steps in order, then the
    groups in order into the range's partial row; several: by row group
    p % 4 over each block of 64 positions, the groups in order into the
    block's row; the rows then in order. Controls: ``pad`` (per output
    channel) puts that ge in the padding in place of 0; ``leak`` stacks a
    range's images with no zero row between them (a halo row from the
    neighbouring image). Returns (dx, dinv, dshift, dinv's partial rows)."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    step, kc, npg = plan.step, plan.k_chunk, plan.step // 8
    hw, m_all = h * wd, b * t * h * wd
    cop, ncols = plan.chunks * kc, plan.n_tiles * plan.n_tile
    wk = np.zeros((9, cop, ncols), np.float32)
    wk[:, :co, :ci] = conv_bn.f32_bwd_data_filter(
        torch.from_numpy(w), "spatial").numpy().reshape(9, co, ci)
    imgs = np.zeros((b * t, h, wd, cop), np.float32)
    imgs[..., :co] = _fold(gy, y, gs1, gs2).reshape(b * t, h, wd, co)
    padv = np.zeros(cop, np.float32)
    if pad is not None:
        padv[:co] = pad
    dxh = np.zeros((plan.k_splits, m_all, ncols), np.float32)
    sep = 0 if leak else 1                       # zero rows between images
    for r in range(plan.ranges):
        ims = plan.images_of(r)
        stream = np.tile(padv, (len(ims) * (h + sep) + 2 - sep, wd + 2, 1))
        for k, i in enumerate(ims):
            top = k * (h + sep) + 1
            stream[top:top + h, 1:wd + 1] = imgs[i]
        q_all, p0 = len(ims) * hw, ims[0] * hw
        for s in range(plan.k_splits):
            for j in range(-(-q_all // step)):
                q = np.arange(j * step, min(q_all, (j + 1) * step))
                rho = q // wd
                col, vr = q - rho * wd, rho + sep * (rho // h) + 1
                assert vr.max() - vr.min() + 3 <= plan.buf_rows
                acc = np.zeros((len(q), ncols), np.float32)
                for ck in plan.chunks_of(s):
                    cs = slice(ck * kc, (ck + 1) * kc)
                    for tap in range(9):
                        dh, dw = divmod(tap, 3)
                        acc += stream[vr - 1 + dh, col + dw, cs] @ wk[tap, cs]
                dxh[s, p0 + q] = acc
    d = dxh[0]
    for part in dxh[1:]:                         # in split order
        d = d + part
    d = d[:, :ci]
    if inv is None:
        return d.reshape(x.shape), None, None, None
    xf = x.reshape(m_all, ci)
    dxa = np.where((xf * inv) + shift > 0, d, np.float32(0))
    xd = xf * dxa
    rows1, rows2 = [], []
    if plan.k_splits == 1:
        for r in range(plan.ranges):
            ims = plan.images_of(r)
            p0, q_all = ims[0] * hw, len(ims) * hw
            g1 = np.zeros((npg, ci), np.float32)
            g2 = np.zeros((npg, ci), np.float32)
            for i in range(0, q_all, npg):
                blk = slice(p0 + i, p0 + min(q_all, i + npg))
                n = blk.stop - blk.start
                g1[:n] += xd[blk]
                g2[:n] += dxa[blk]
            rows1.append(_in_order(g1))
            rows2.append(_in_order(g2))
    else:
        for m0 in range(0, m_all, conv_bn._SDF_SUM_ROWS):
            g1 = np.zeros((4, ci), np.float32)
            g2 = np.zeros((4, ci), np.float32)
            for i in range(m0, min(m_all, m0 + conv_bn._SDF_SUM_ROWS), 4):
                n = min(m_all, i + 4) - i
                g1[:n] += xd[i:i + n]
                g2[:n] += dxa[i:i + n]
            rows1.append(_in_order(g1))
            rows2.append(_in_order(g2))
    assert len(rows1) == plan.part_rows
    return ((dxa * inv).reshape(x.shape), _in_order(rows1), _in_order(rows2),
            rows1)


def _emulate_temporal_data_walk(x, w, inv, shift, y, gy, gs1, gs2, plan,
                                pad=None):
    """temporal_data_f32_kernel's walk: per range its units in order, each a
    strip of ``plan.strip`` positions of the flattened B·H·W axis (across
    clips where H·W is small) walked over the frames; frame t's ge (folded
    on the strip's positions and channels < C_out only) in chunks of
    ``plan.k_chunk`` output channels multiplied into three accumulator
    sets, dx^ frames t+1 (tap 0), t (tap 1) and t-1 (tap 2) against the
    mirrored filter's rows (tap, k), a tap whose frame lies outside the clip
    skipped; after frame t's last chunk frame t-1 leaves (and at the clip's
    last frame t too) and the sets shift. With the prologue, strip row p's
    x * dxa and dxa are summed by position group p % (strip / 4) over the
    range's units and frames in order, then the groups in order into the
    range's partial row, the rows in colsum_f32_kernel's order. ``pad`` (a
    control, per output channel) puts that ge at the frames -1 and T in
    place of 0. Returns (dx, dinv, dshift, dinv's partial rows)."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    hw, kc, npg = h * wd, plan.k_chunk, plan.strip // 4
    cop = -(-co // kc) * kc
    ncols = plan.n_tiles * plan.n_tile
    ge = np.zeros((b, t, hw, cop), np.float32)
    ge[..., :co] = _fold(gy, y, gs1, gs2).reshape(b, t, hw, co)
    wk = np.zeros((3, cop, ncols), np.float32)
    wk[:, :co, :ci] = conv_bn.f32_bwd_data_filter(
        torch.from_numpy(w), "temporal").numpy().reshape(3, co, ci)
    dxh = np.zeros((b, t, hw, ncols), np.float32)
    for r in range(plan.ranges):
        for u in plan.units_of(r):
            pos = np.array(plan.positions_of(u))
            bi, pi = pos // hw, pos % hw
            acc = np.zeros((3, len(pos), ncols), np.float32)
            for tt in range(t):
                for c in range(cop // kc):
                    cs = slice(c * kc, (c + 1) * kc)
                    a = ge[bi, tt, pi, cs]
                    for tap in range(3):
                        if 0 <= tt + 1 - tap < t:
                            acc[2 - tap] += a @ wk[tap, cs]
                done = ([(0, tt - 1)] if tt > 0 else []) \
                    + ([(1, tt)] if tt + 1 == t else [])
                for f, tf in done:
                    dxh[bi, tf, pi] = acc[f]
                acc = np.stack([acc[1], acc[2], np.zeros_like(acc[2])])
    if pad is not None:                        # ge = pad at frames -1 and T
        padv = np.zeros(cop, np.float32)
        padv[:co] = pad
        dxh[:, 0] += padv @ wk[0]
        dxh[:, t - 1] += padv @ wk[2]
    dxh = dxh[..., :ci]
    if inv is None:
        return dxh.reshape(x.shape), None, None, None
    xf = x.reshape(b, t, hw, ci)
    dxa = np.where((xf * inv) + shift > 0, dxh, np.float32(0))
    xd = xf * dxa
    rows1, rows2 = [], []
    for r in range(plan.ranges):
        g1 = np.zeros((npg, ci), np.float32)
        g2 = np.zeros((npg, ci), np.float32)
        for u in plan.units_of(r):
            pos = np.array(plan.positions_of(u))
            bi, pi = pos // hw, pos % hw
            for tf in range(t):
                for i in range(4):
                    blk = slice(npg * i, npg * (i + 1))
                    n = len(pos[blk])
                    g1[:n] += xd[bi[blk], tf, pi[blk]]
                    g2[:n] += dxa[bi[blk], tf, pi[blk]]
        rows1.append(_in_order(g1))
        rows2.append(_in_order(g2))
    assert len(rows1) == plan.part_rows
    return ((dxa * inv).reshape(x.shape), _colsum(rows1, ci),
            _colsum(rows2, ci), rows1)


def _in_order(rows):
    """The rows of ``rows`` summed one after another (fp32)."""
    out = np.zeros_like(rows[0])
    for v in rows:
        out = out + v
    return out


def _emulate_filter(x, inv, shift, y, gy, gs1, gs2, kind, sms=None):
    """The filter gradient's walk in numpy (fp32), as the wrapper routes it:
    the spatial row walk where its plan has a layout, else the per-tap
    gather; returns dw in the reference layout."""
    sms = sms or FILTER_SMS.get(x.shape, SMS)
    if kind == "spatial":
        plan = conv_bn.f32_spatial_filter_plan(*x.shape, gy.shape[-1], sms)
        if plan is not None:
            return _emulate_filter_walk(x, inv, shift, y, gy, gs1, gs2,
                                        plan)[0]
    return _emulate_filter_gather(x, inv, shift, y, gy, gs1, gs2, kind, sms)


def _emulate_filter_walk(x, inv, shift, y, gy, gs1, gs2, plan, pad=None):
    """spatial_filter_f32_kernel's walk: per slice of whole images a stream
    of rows (a zero row before every image and after the last, zero
    columns 0 and W+1), each row copied once into ring slot row %
    ``plan.ring_rows``, a step ahead of the step multiplied (x^ formed
    on real pixels and channels < C_in only; the ring is held to carry
    every row a step reads after those copies), steps of
    ``plan.step`` output pixels with ge folded on the slice's pixels and
    channels < C_out only, each pixel's tap (dh, dw) read at the table's
    ring offset of row h + dh - 1 plus column w + dw, every block's [9·16,
    N tile] summed over the steps in order. The blocks of a slice are
    independent, so all its channel blocks and N tiles run at once. ``pad``
    (per input channel) puts that x^ in the padding rows and columns in
    place of 0 (a control). Returns (dw in the reference layout, the
    slices' partials [9·C_in, C_out] summed in slice order into it)."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    step, rows_n = plan.step, plan.ring_rows
    hw, wp = h * wd, wd + 2
    cip = plan.ci_blocks * plan.ci_blk
    ncols = plan.n_tiles * plan.n_tile
    imgs = np.zeros((b * t, h, wd, cip), np.float32)
    imgs[..., :ci] = x.reshape(b * t, h, wd, ci) if inv is None else \
        np.maximum(np.float32(x * inv) + shift, np.float32(0)).reshape(
            b * t, h, wd, ci)
    ge = np.zeros((b * t * hw, ncols), np.float32)
    ge[:, :co] = _fold(gy.reshape(-1, co), y.reshape(-1, co), gs1, gs2)
    padv = np.zeros(cip, np.float32)
    if pad is not None:
        padv[:ci] = pad
    parts = []
    for s in range(plan.slices):
        ims = plan.images_of(s)
        q_all, p0 = len(ims) * hw, ims[0] * hw
        last_row = len(ims) * (h + 1)
        ring = np.zeros((rows_n, wp, cip), np.float32)
        held = np.full(rows_n, -1)
        acc = np.zeros((9, cip, ncols), np.float32)
        nq = -(-q_all // step)

        def need(j):                       # the last row step j reads
            if (j + 1) * step >= q_all:
                return last_row
            rho = ((j + 1) * step - 1) // wd
            return rho + rho // h + 2
        lo = -1
        for j in range(nq):
            hi = need(min(nq - 1, j + 1))
            for vr in range(lo + 1, hi + 1):   # the rows up to step j+1's
                img, hr = divmod(vr, h + 1)
                slot = vr % rows_n
                ring[slot] = padv
                if hr:
                    ring[slot, 1:wd + 1] = imgs[ims[img], hr - 1]
                held[slot] = vr
            lo = hi
            q = np.arange(j * step, min(q_all, (j + 1) * step))
            rho = q // wd
            col, vr = q - rho * wd, rho + rho // h + 1
            g = ge[p0 + q]
            for dh in range(3):
                r = vr + dh - 1
                assert (held[r % rows_n] == r).all()
                for dw in range(3):
                    acc[dh * 3 + dw] += ring[r % rows_n, col + dw].T @ g
        parts.append(acc[:, :ci, :co].reshape(9 * ci, co))
    dw = parts[0]
    for p in parts[1:]:                      # in slice order
        dw = dw + p
    return dw.reshape(3, 3, ci, co), parts


def _emulate_filter_gather(x, inv, shift, y, gy, gs1, gs2, kind, sms=SMS):
    """bwd_filter_f32_kernel's walk (the temporal kind, and the spatial
    kind where no row-walk layout fits the images) in numpy (fp32): returns
    dw in the reference layout."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    taps = 9 if kind == "spatial" else 3
    plan = conv_bn.f32_bwd_filter_plan(b, t, h, wd, ci, co, kind, sms)
    m_all = b * t * h * wd
    k = taps * ci
    xh = x.reshape(m_all, ci)
    if inv is not None:
        xh = np.maximum((xh * inv) + shift, np.float32(0))
    ge = _fold(gy.reshape(m_all, co), y.reshape(m_all, co), gs1, gs2)
    parts = []
    for s in range(plan.slices):
        acc = np.zeros((plan.k_tiles * 64, plan.n_tiles * 64), np.float32)
        for c in range(s * plan.chunks_per_slice,
                       min(plan.chunks, (s + 1) * plan.chunks_per_slice)):
            m = c * KC + np.arange(KC)
            ok_m = m < m_all
            a = np.zeros((KC, plan.k_tiles * 64), np.float32)
            for tap in range(taps):
                src, ok = _neighbour(kind, np.minimum(m, m_all - 1), tap, t,
                                     h, wd)
                a[:, tap * ci:(tap + 1) * ci] = np.where(
                    (ok & ok_m)[:, None], xh[src], 0)
            bm = np.zeros((KC, plan.n_tiles * 64), np.float32)
            bm[ok_m, :co] = ge[m[ok_m]]
            acc += a.T @ bm
        parts.append(acc[:k, :co])
    dw = parts[0]
    for p in parts[1:]:                      # in slice order
        dw = dw + p
    return dw.reshape((3, 3, ci, co) if kind == "spatial" else (3, ci, co))


def _case_id(kind, xs, ws):
    return f"{kind}-{'x'.join(map(str, xs))}-to-{ws[-1]}"


# the spatial filter gradient off EMU_CASES: five 7x7 images two a slice,
# the last slice one image (FILTER_SMS); images too wide for the row walk
# (the per-tap gather)
FILTER_CASES = [("spatial", (1, 5, 7, 7, 24), (3, 3, 24, 40)),
                ("spatial", (1, 2, 2, 600, 16), (3, 3, 16, 16))]
# the multiprocessors the filter plans are made for, where not SMS: fewer
# put several images in a slice, so that a step spans images and a slice
# (7x7 images: slices of 5, of 3, 3 and 2, and of 2, 2 and 1; four 1x1
# images in one slice)
FILTER_SMS = {(2, 5, 7, 7, 24): 4, (2, 4, 7, 7, 16): 3, (1, 4, 1, 1, 16): 2,
              (1, 5, 7, 7, 24): 6}
# the spatial data walk off EMU_CASES: seven 7x7 images at C_in 200 (four
# N tiles of 64, the last masked to 8 channels) and C_out 40 (chunks of 16,
# 16 and 8)
DATA_CASES = [("spatial", (1, 7, 7, 7, 200), (3, 3, 200, 40))]
# the multiprocessors the data plans are made for, where not SMS: fewer put
# several images in a range and keep the K whole, or split it (7x7 images:
# two ranges of 5, one split; 7x7 at C_out 144: two ranges of 4, two splits
# of 5 and 4 chunks; 1x1 images: one range of 6, several a step; 4x7
# images at C_out 200: four splits of 4, 4, 4 and 1 chunks; five 7x7
# images: ranges of 3 and 2, three splits; seven 7x7 images: ranges of 4
# and 3, two splits, or with one split asked for ranges of 2, 2, 2 and 1)
DATA_SMS = {(2, 5, 7, 7, 24): 2, (2, 4, 7, 7, 16): 4, (3, 2, 1, 1, 8): 1,
            (2, 3, 4, 7, 40): 4, (1, 5, 7, 7, 24): 6, (1, 7, 7, 7, 200): 16}
# the temporal data frame walk off EMU_CASES: five 7x7 clips of three frames
# and seven 5x5 clips of two across strips (the last strip partial in
# every layout), C_in 200 and 24 (a masked last N tile in every layout),
# C_out 40 (chunks of 16, 16 and 8)
TDF_CASES = [("temporal", (5, 3, 7, 7, 200), (3, 200, 40)),
             ("temporal", (7, 2, 5, 5, 24), (3, 24, 40))]
# the multiprocessors the frame walk's plans are made for, where not SMS:
# fewer put several strips in a range (C_in 200: ranges of 2, 2 and 1
# strips at N tiles of 144, one of 2 at 64; C_in 24: one range of every
# strip)
TDF_SMS = {(5, 3, 7, 7, 200): 6, (7, 2, 5, 5, 24): 1}
ALL_CASES = EMU_CASES + FILTER_CASES + DATA_CASES + TDF_CASES

CASES = [pytest.param(i, affine, id=f"{_case_id(*c)}-{'affine' if affine else 'plain'}")
         for i, c in enumerate(EMU_CASES) for affine in (False, True)]
WALK_CASES = [pytest.param(len(EMU_CASES) + i, affine,
                           id=f"{_case_id(*c)}-{'affine' if affine else 'plain'}")
              for i, c in enumerate(FILTER_CASES) for affine in (False, True)]
# (case, K splits asked for or None: the plan's) of the data walk's edges:
# FILTER_CASES' five 7x7 images (ranges of 3 and 2, three splits),
# DATA_CASES' seven at C_in 200 (the plan's two splits of 2 and 1 chunks
# over ranges of 4 and 3; one split asked for: ranges of 2 to a one-image
# last)
_DATA_EDGES = ((len(EMU_CASES), None),
               (len(EMU_CASES) + len(FILTER_CASES), None),
               (len(EMU_CASES) + len(FILTER_CASES), 1))
DATA_WALK_CASES = [
    pytest.param(i, splits, affine,
                 id=f"{_case_id(*ALL_CASES[i])}-splits={splits or 'plan'}-"
                    f"{'affine' if affine else 'plain'}")
    for i, splits in _DATA_EDGES for affine in (False, True)]


@functools.lru_cache(maxsize=None)
def _inputs(i, affine):
    """Inputs from a numpy seed, y from the reference's forward, and the
    reference's backward: the Pallas one in interpret mode, or the XLA
    composition for a clip of one frame."""
    kind, xs, ws = ALL_CASES[i]
    rng = np.random.RandomState(100 + i)
    co = ws[-1]
    x = rng.randn(*xs).astype(np.float32)
    w = (0.1 * rng.randn(*ws)).astype(np.float32)
    inv = (rng.rand(xs[-1]) + 0.5).astype(np.float32) if affine else None
    shift = (0.1 * rng.randn(xs[-1])).astype(np.float32) if affine else None
    gy = rng.randn(*xs[:-1], co).astype(np.float32)
    gs1 = rng.randn(co).astype(np.float32)
    gs2 = (0.01 * rng.randn(co)).astype(np.float32)
    j = lambda v: None if v is None else jnp.asarray(v)
    y = np.asarray(jcb.conv_unit_reference(j(x), j(w), j(inv), j(shift),
                                           kind=kind)[0])
    args = (j(x), j(w), j(inv), j(shift), j(y), j(gy), j(gs1), j(gs2))
    if kind == "temporal" and xs[1] < 2:
        want = jcb._xla_bwd(kind, *args)
    else:
        bwd = jcb._spatial_bwd if kind == "spatial" else jcb._temporal_bwd
        want = bwd(*args, interpret=True)
    want = tuple(None if v is None else np.asarray(v) for v in want)
    t = lambda v: None if v is None else torch.from_numpy(v)
    plain = conv_bn.conv_unit_bwd_reference(
        t(x), t(w), t(inv), t(shift), t(y), t(gy), t(gs1), t(gs2), kind=kind)
    plain = tuple(None if v is None else v.numpy() for v in plain)
    return kind, (x, w, inv, shift, y, gy, gs1, gs2), want, plain


def _data_within(x, inv, shift, dx, dinv, dshift, ref):
    """dx within DX_TOL of the reference's largest, dinv / dshift per
    channel within S_RTOL plus S_REL of the channel's sum of magnitudes."""
    if not np.abs(dx - ref[0]).max() <= DX_TOL * np.abs(ref[0]).max():
        return False
    if inv is None:
        return ref[2] is None and dinv is None and dshift is None
    # the scale of each channel's summation error
    mask = (x * inv + shift) > 0
    dxa = np.where(mask, ref[0] / inv, 0)
    axes = tuple(range(x.ndim - 1))
    return all((np.abs(got - r) <= S_RTOL * np.abs(r) + S_REL * scale).all()
               for got, r, scale in ((dinv, ref[2], np.abs(x * dxa).sum(axes)),
                                     (dshift, ref[3], np.abs(dxa).sum(axes))))


TDF_WALK_CASES = [
    pytest.param(len(ALL_CASES) - len(TDF_CASES) + i, nb, affine,
                 id=f"{_case_id(*c)}-n_tile={nb}-{'affine' if affine else 'plain'}")
    for i, c in enumerate(TDF_CASES) for nb in conv_bn._TDF_N_TILES
    for affine in (False, True)]


@pytest.mark.parametrize("i,affine", CASES)
def test_data_walk_matches_pallas_backward_fp32(i, affine):
    """EMU_CASES as the wrapper routes them: the temporal frame walk (one
    strip a range at 132 SMs; ranges of several strips are
    TDF_CASES'), the spatial row walk where its plan has a layout
    (DATA_SMS: ranges of several images, K splits), the per-tap gather for
    images too wide."""
    kind, (x, w, inv, shift, y, gy, gs1, gs2), want, plain = _inputs(i, affine)
    if kind == "spatial":
        walk = conv_bn.f32_spatial_data_plan(
            *x.shape, gy.shape[-1], DATA_SMS.get(x.shape, SMS))
        assert (walk is None) == (x.shape[3] == 240)
    dx, dinv, dshift = _emulate_dx(x, w, inv, shift, y, gy, gs1, gs2, kind)
    for ref in (want, plain):
        assert _data_within(x, inv, shift, dx, dinv, dshift, ref)


@pytest.mark.parametrize("i,splits,affine", DATA_WALK_CASES)
def test_spatial_data_walk_edges_match_pallas_backward_fp32(i, splits, affine):
    """The data walk off EMU_CASES: several images a range with a one-image
    last range, a masked N tile, chunks of 16, 16 and 8, K splits of the
    plan's and asked for."""
    kind, (x, w, inv, shift, y, gy, gs1, gs2), want, plain = _inputs(i, affine)
    plan = conv_bn.f32_spatial_data_plan(*x.shape, gy.shape[-1],
                                         DATA_SMS[x.shape], k_splits=splits)
    shape = (plan.images_per_range, plan.ranges, plan.k_splits,
             [len(plan.chunks_of(s)) for s in range(plan.k_splits)])
    assert shape == {(1, 5, 7, 7, 24, None): (3, 2, 3, [1, 1, 1]),
                     (1, 7, 7, 7, 200, None): (4, 2, 2, [2, 1]),
                     (1, 7, 7, 7, 200, 1): (2, 4, 1, [3])}[x.shape + (splits,)]
    if x.shape[-1] == 200:
        assert (plan.n_tile, plan.n_tiles) == (64, 4)
    dx, dinv, dshift, _ = _emulate_data_walk(x, w, inv, shift, y, gy, gs1,
                                             gs2, plan)
    for ref in (want, plain):
        assert _data_within(x, inv, shift, dx, dinv, dshift, ref)


@pytest.mark.parametrize("i,n_tile,affine", TDF_WALK_CASES)
def test_temporal_data_walk_edges_match_pallas_backward_fp32(i, n_tile, affine):
    """The frame walk at TDF_CASES in every N tile the plan can take: clips
    across strips with a partial last strip, ranges of several strips
    (TDF_SMS), a masked last N tile, chunks of 16, 16 and 8, two and three
    frames."""
    kind, (x, w, inv, shift, y, gy, gs1, gs2), want, plain = _inputs(i, affine)
    plan = conv_bn.f32_temporal_data_plan(*x.shape, gy.shape[-1],
                                          TDF_SMS[x.shape], affine,
                                          n_tile=n_tile)
    assert plan.n_tile == n_tile and plan.units > 1
    assert len(plan.positions_of(plan.units - 1)) < plan.strip
    assert plan.n_tiles * n_tile > x.shape[-1]
    assert any(len(plan.units_of(r)) > 1 for r in range(plan.ranges))
    dx, dinv, dshift, _ = _emulate_temporal_data_walk(
        x, w, inv, shift, y, gy, gs1, gs2, plan)
    for ref in (want, plain):
        assert _data_within(x, inv, shift, dx, dinv, dshift, ref)


def _dw_limit(x, inv, shift, y, gy, gs1, gs2, kind):
    """dw's limit per element: DW_REL of sum |x^|*|ge| plus DW_ABS of that
    sum's largest."""
    xh = np.maximum(x * inv + shift, 0) if inv is not None else x
    ge = _fold(gy, y, gs1, gs2)
    absw = conv_bn.conv_unit_bwd_filter_reference(
        torch.from_numpy(np.abs(xh)), None, None,
        torch.zeros(ge.shape), torch.from_numpy(np.abs(ge)),
        torch.zeros(ge.shape[-1]), torch.zeros(ge.shape[-1]), kind=kind).numpy()
    return DW_REL * absw + DW_ABS * absw.max()


@pytest.mark.parametrize("i,affine", CASES)
def test_filter_walk_matches_pallas_backward_fp32(i, affine):
    kind, (x, w, inv, shift, y, gy, gs1, gs2), want, plain = _inputs(i, affine)
    dw = _emulate_filter(x, inv, shift, y, gy, gs1, gs2, kind)
    lim = _dw_limit(x, inv, shift, y, gy, gs1, gs2, kind)
    for ref in (want, plain):
        assert dw.shape == ref[1].shape
        assert (np.abs(dw - ref[1]) <= lim).all(), np.abs(dw - ref[1]).max()


@pytest.mark.parametrize("i,affine", WALK_CASES)
def test_spatial_filter_walk_edges_match_pallas_backward_fp32(i, affine):
    """FILTER_CASES: the row walk with a one-image last slice, and the
    per-tap gather where no ring layout fits the images (as the wrapper
    routes them)."""
    kind, (x, w, inv, shift, y, gy, gs1, gs2), want, plain = _inputs(i, affine)
    plan = conv_bn.f32_spatial_filter_plan(*x.shape, gy.shape[-1],
                                           FILTER_SMS.get(x.shape, SMS))
    if x.shape[3] == 600:
        assert plan is None
    else:
        assert plan.images_per_slice == 2 and plan.slices == 3
        assert len(plan.images_of(2)) == 1
    dw = _emulate_filter(x, inv, shift, y, gy, gs1, gs2, kind)
    lim = _dw_limit(x, inv, shift, y, gy, gs1, gs2, kind)
    for ref in (want, plain):
        assert dw.shape == ref[1].shape
        assert (np.abs(dw - ref[1]) <= lim).all(), np.abs(dw - ref[1]).max()


def test_walks_see_the_padding_and_the_slices():
    """The walks' checks can fail: ge formed through the formula in the
    padding (gs1 there) and x^ formed through the prologue in the padding
    (relu(shift) there) each miss the reference at the 1x1-image and
    one-frame cases, and a dw without its last slice's share where the
    walk takes several slices. The data row walk's emulation can fail too
    (7x7 images five a range, two ranges, one split; gs1 of the size of gy,
    xa > 0 for about half the elements): ge = gs1 in its padding rows and
    columns, a range's images with no zero row between them (the halo row
    from the neighbouring image) and a dinv without its last range's row
    each miss the reference."""
    for i in (1, 3):                       # 1x1 images; a clip of one frame
        kind, (x, w, inv, shift, y, gy, gs1, gs2), want, _ = _inputs(i, True)
        ci, co = x.shape[-1], gy.shape[-1]
        pad = ((0, 0), (0, 0), (1, 1), (1, 1), (0, 0)) if kind == "spatial" \
            else ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0))
        # ge through the formula in the padding: y = gy = 0 there gives gs1
        gep = _fold(np.pad(gy, pad), np.pad(y, pad), gs1, gs2)
        kern, _ = conv_bn._torch_kernel(torch.from_numpy(w), kind)
        flip = kern.flip(2, 3, 4).transpose(0, 1)
        dxh = torch.nn.functional.conv3d(
            torch.from_numpy(gep).permute(0, 4, 1, 2, 3), flip).permute(
                0, 2, 3, 4, 1).numpy()
        wrong_dx = np.where(x * inv + shift > 0, dxh, 0) * inv
        assert np.abs(wrong_dx - want[0]).max() > DX_TOL * np.abs(want[0]).max()
        # x^ through the prologue in the padding: relu(shift) there
        xhp = np.maximum(np.pad(x, pad) * inv + shift, 0)
        ge = _fold(gy, y, gs1, gs2)
        ksize = (1, 3, 3) if kind == "spatial" else (3, 1, 1)
        wrong_dw = torch.nn.grad.conv3d_weight(
            torch.from_numpy(xhp).permute(0, 4, 1, 2, 3), (co, ci) + ksize,
            torch.from_numpy(ge).permute(0, 4, 1, 2, 3)).numpy()
        wrong_dw = (wrong_dw[:, :, 0].transpose(2, 3, 1, 0) if kind == "spatial"
                    else wrong_dw[:, :, :, 0, 0].transpose(2, 1, 0))
        assert np.abs(wrong_dw - want[1]).max() > DW_REL * np.abs(want[1]).max()
    for i in (0, 3):                       # 14 and 2 chunks of 16 positions
        kind, (x, w, inv, shift, y, gy, gs1, gs2), want, _ = _inputs(i, True)
        b, t, h, wd, ci = x.shape
        co, m = gy.shape[-1], b * t * h * wd
        plan = conv_bn.f32_bwd_filter_plan(b, t, h, wd, ci, co, kind, SMS)
        walk = conv_bn.f32_spatial_filter_plan(b, t, h, wd, ci, co, SMS) \
            if kind == "spatial" else None
        assert plan.slices > 1 and (walk is None or walk.slices > 1)
        last = plan.positions_of(plan.slices - 1, m) if walk is None else \
            range(walk.images_of(walk.slices - 1)[0] * h * wd, m)
        keep = np.ones((m, 1), np.float32)
        keep[last.start:last.stop] = 0
        ge = (_fold(gy, y, gs1, gs2).reshape(m, co) * keep).reshape(gy.shape)
        zero = torch.zeros(co)
        short = conv_bn.conv_unit_bwd_filter_reference(
            *(torch.from_numpy(v) for v in (x, inv, shift)),
            torch.zeros(gy.shape), torch.from_numpy(ge), zero, zero,
            kind=kind).numpy()
        assert np.abs(short - want[1]).max() > DW_REL * np.abs(want[1]).max()
    kind, args, want, _ = _inputs(6, True)
    x, inv, shift, gs1 = args[0], args[2], args[3], args[6]
    plan = conv_bn.f32_spatial_data_plan(*x.shape, args[5].shape[-1],
                                         DATA_SMS[x.shape])
    assert (plan.images_per_range, plan.ranges, plan.k_splits) == (5, 2, 1)
    right = _emulate_data_walk(*args, plan)
    assert _data_within(x, inv, shift, *right[:3], want)
    for wrong in (_emulate_data_walk(*args, plan, pad=gs1),
                  _emulate_data_walk(*args, plan, leak=True)):
        assert np.abs(wrong[0] - want[0]).max() > DX_TOL * np.abs(want[0]).max()
    short = right[1] - right[3][-1]
    assert not _data_within(x, inv, shift, right[0], short, right[2], want)
    assert (x.reshape(-1, x.shape[-1])[5 * 49:] * inv + shift > 0).mean() > 0.3


def test_walks_see_the_padding_and_the_ring_slices():
    """The row walk's emulation can fail: x^ formed through the prologue in
    its padding rows and columns (relu(shift) there, nonzero for about half
    the channels) misses the reference at the 7x7 and 1x1 images, and a dw
    without its last slice's partial (a one-image slice of random, nonzero
    x^) misses it where the walk takes several slices."""
    for i in (6, 1, len(EMU_CASES)):        # 7x7 two slices; 1x1; 5 images
        kind, (x, w, inv, shift, y, gy, gs1, gs2), want, _ = _inputs(i, True)
        plan = conv_bn.f32_spatial_filter_plan(
            *x.shape, gy.shape[-1], FILTER_SMS.get(x.shape, SMS))
        args = (x, inv, shift, y, gy, gs1, gs2)
        lim = _dw_limit(*args, kind)
        right, parts = _emulate_filter_walk(*args, plan)
        assert (np.abs(right - want[1]) <= lim).all()
        wrong = _emulate_filter_walk(*args, plan,
                                     pad=np.maximum(shift, np.float32(0)))[0]
        assert (np.abs(wrong - want[1]) > lim).any()
        if plan.slices > 1:
            short = (right.reshape(parts[-1].shape) - parts[-1]).reshape(
                right.shape)
            assert (np.abs(short - want[1]) > lim).any()
            assert (np.abs(x.reshape(-1, x.shape[-1])[
                plan.images_of(plan.slices - 1)[0] * x.shape[2] * x.shape[3]:]
                * inv + shift) > 0).any()


def _c_sff_smem():
    """sff_smem of conv_bn_f32.cu as a Python function of (W, ring rows,
    step, N tile): its expression read from the source, so the plan's
    formula is held against the C side's."""
    src = (Path(conv_bn.__file__).parents[1] / "csrc" / "conv_bn_f32.cu"
           ).read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (SFF_\w+) = (\d+);", src)}
    body = re.search(r"size_t sff_smem\(int W, int XR, int S, int NB\) "
                     r"\{\s*return (.*?);\n\}", src, re.S).group(1)
    expr = " ".join(body.replace("(size_t)", "").replace("sizeof(float)", "4")
                    .replace("sizeof(int)", "4").replace("sizeof(uint64_t)", "8")
                    .split())

    def smem(w, rows, step, n_tile):
        return eval(expr, {}, {"W": w, "XR": rows, "S": step, "NB": n_tile,
                               **consts})
    return smem, consts


def _check_spatial_filter_plan(p, b, t, h, w, ci, co, sms=SMS):
    """What every fp32 spatial filter-walk plan must hold: every image in
    exactly one slice and no slice empty, the block of the C side's channel
    block and thread tile (consumers and a producer warp), N tiles covering
    C_out, steps of 128, 64 or 32 pixels, a ring of two steps' rows, the grid
    and the int offsets within their limits, the partials within
    _FILTER_PART_BYTES, one wave of blocks unless the tiles alone are more,
    and a shared-memory size within a block's that is the C side's; ge
    folded once before the walk into a scratch of [M, C_out] floats."""
    c_smem, consts = _c_sff_smem()
    assert p.images == b * t
    covered = [i for s in range(p.slices) for i in p.images_of(s)]
    assert covered == list(range(p.images))
    assert all(len(p.images_of(s)) for s in range(p.slices))
    assert p.ci_blk == consts["SFF_CB"] == 16
    assert p.register_tile == (3, 4, 8)
    consumers = 3 * (p.ci_blk // 4) * (p.n_tile // 8)
    assert p.threads == (-(-consumers // 32) + 1) * 32 <= 256
    assert p.n_tile in (144, 128) and p.n_tiles == -(-co // p.n_tile)
    assert p.ci_blocks == -(-ci // 16)
    assert p.step in (128, 64, 32)
    assert p.ring_rows == conv_bn.spatial_ring_rows(h, w, p.step, 2)
    assert p.blocks == p.slices * p.ci_blocks * p.n_tiles < 2 ** 31
    assert p.images_per_slice * h * w < 2 ** 31
    assert p.part_bytes <= conv_bn._FILTER_PART_BYTES
    assert p.part_bytes == (4 * 9 * ci * co * p.slices if p.slices > 1 else 0)
    assert p.blocks <= max(sms, p.ci_blocks * p.n_tiles)
    assert p.ge_bytes == 4 * b * t * h * w * co
    assert p.smem_bytes == c_smem(w, p.ring_rows, p.step, p.n_tile) \
        == conv_bn._spatial_filter_f32_smem(w, p.ring_rows, p.step, p.n_tile) \
        <= 227 * 1024


def _c_sdf_smem():
    """sdf_smem of conv_bn_f32.cu as a Python function of (W, buffer rows,
    K chunk, N tile): its expression read from the source, so the plan's
    formula is held against the C side's."""
    src = (Path(conv_bn.__file__).parents[1] / "csrc" / "conv_bn_f32.cu"
           ).read_text()
    body = re.search(r"size_t sdf_smem\(int W, int XR, int KC, int NB\) "
                     r"\{\s*return (.*?);\n\}", src, re.S).group(1)
    expr = " ".join(body.replace("(size_t)", "").replace("sizeof(float)", "4")
                    .split())
    rows = int(re.search(r"constexpr int SDF_SUM_ROWS = (\d+);", src).group(1))

    def smem(w, buf_rows, k_chunk, n_tile):
        return eval(expr, {}, {"W": w, "XR": buf_rows, "KC": k_chunk,
                               "NB": n_tile})
    return smem, rows


def _check_spatial_data_plan(p, b, t, h, w, ci, co, sms=SMS):
    """What every fp32 spatial data-walk plan must hold: every image in
    exactly one range and no range empty, every chunk of 16 or 8 output
    channels in exactly one K split and no split empty, N tiles of 64 (steps
    of 256) or 128 (steps of 128) covering C_in at 256 threads (8 warps),
    buffers of a step's rows that a thread's copies cover, one wave of
    blocks within the grid's limit, int offsets within their limits, the
    partial rows (one a range, or one per SDF_SUM_ROWS positions with a K
    split) and the split partials' bytes, and a shared-memory size within a
    block's that is the C side's."""
    c_smem, sum_rows = _c_sdf_smem()
    assert p.images == b * t
    covered = [i for r in range(p.ranges) for i in p.images_of(r)]
    assert covered == list(range(p.images))
    assert all(len(p.images_of(r)) for r in range(p.ranges))
    assert p.k_chunk in (16, 8) and p.chunks == -(-co // p.k_chunk)
    chunks = [c for k in range(p.k_splits) for c in p.chunks_of(k)]
    assert chunks == list(range(p.chunks))
    assert all(len(p.chunks_of(k)) for k in range(p.k_splits))
    assert (p.n_tile, p.step) in ((64, 256), (128, 128))
    assert p.n_tiles == -(-ci // p.n_tile)
    assert p.threads == p.step // 8 * p.n_tile // 8 == 256
    assert p.buf_rows == conv_bn.spatial_ring_rows(h, w, p.step, 1)
    assert p.buf_rows * w <= 8 * p.threads // (p.k_chunk // 4)
    assert p.blocks == p.ranges * p.k_splits * p.n_tiles <= max(sms, p.n_tiles)
    assert p.blocks < 2 ** 31 and p.images_per_range * h * w < 2 ** 31
    m = b * t * h * w
    assert p.part_rows == (p.ranges if p.k_splits == 1 else -(-m // sum_rows))
    assert p.part_bytes == (4 * p.k_splits * m * ci if p.k_splits > 1 else 0)
    assert p.smem_bytes == c_smem(w, p.buf_rows, p.k_chunk, p.n_tile) \
        == conv_bn._spatial_data_f32_smem(w, p.buf_rows, p.k_chunk, p.n_tile) \
        <= 227 * 1024


def _c_tdf():
    """tdf_smem of conv_bn_f32.cu as a Python function of (strip, N tile,
    C_out in whole chunks, resident, the prologue), its three expressions
    read from the source, and the C entry's layouts {N tile: (NCG, NPG)}
    read from its ``tdf_run<NCG, NPG>`` instances (N tile 8·NCG, strip
    4·NPG)."""
    src = (Path(conv_bn.__file__).parents[1] / "csrc" / "conv_bn_f32.cu"
           ).read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (TDF_\w+) = (\d+);", src)}
    body = re.search(r"size_t tdf_smem\(int S, int NB, int Cop, int res, "
                     r"int aff\) \{(.*?)\n\}", src, re.S).group(1)
    filt = re.search(r"const size_t filt = res \? (.*?) : (.*?);", body, re.S)
    xs = re.search(r"const size_t xs = aff \? (.*?) : (.*?);", body, re.S)
    total = re.search(r"return sizeof\(float\) \* (.*?);", body, re.S).group(1)
    py = lambda e: " ".join(e.replace("(size_t)", "").split())

    def smem(strip, n_tile, cop, resident, affine):
        env = {"S": strip, "NB": n_tile, "Cop": cop, **consts}
        env["filt"] = eval(py(filt.group(1 if resident else 2)), {}, env)
        env["xs"] = eval(py(xs.group(1 if affine else 2)), {}, env)
        return 4 * eval(py(total), {}, env)
    layouts = {int(nb): (int(ncg), int(npg)) for nb, ncg, npg in re.findall(
        r"case (\d+): return tdf_run<(\d+), (\d+)>", src)}
    return smem, consts, layouts


def _check_temporal_data_plan(p, b, t, h, w, ci, co, sms=SMS, affine=True):
    """What every fp32 temporal data-walk plan must hold: every position in
    exactly one strip and every strip in exactly one non-empty range, the
    N tile and strip of one of the C entry's layouts (8·NCG, 4·NPG; at most
    8 warps), the chunk and register tile of the C side's constants, N
    tiles covering C_in, the resident filter exactly where it fits a
    block's shared memory (with the prologue beside the x slots), the
    ranges of ``_tw_units_per_block`` (the
    fewest strip-times to the last block's end), and a shared-memory size
    that is the C side's."""
    c_smem, consts, layouts = _c_tdf()
    assert p.positions == b * h * w and p.units == -(-p.positions // p.strip)
    covered = [q for u in range(p.units) for q in p.positions_of(u)]
    assert covered == list(range(p.positions))
    units = [u for r in range(p.ranges) for u in p.units_of(r)]
    assert units == list(range(p.units))
    assert all(len(p.units_of(r)) for r in range(p.ranges))
    assert p.part_rows == p.ranges and p.blocks == p.ranges * p.n_tiles
    assert layouts == {nb: (nb // 8, strip // 4) for nb, strip
                       in conv_bn._TDF_LAYOUTS.items()}
    ncg, npg = layouts[p.n_tile]
    assert (p.strip, p.threads) == (4 * npg, ncg * npg) and p.threads <= 256
    assert p.k_chunk == consts["TDF_KC"] == 16
    assert p.register_tile == (p.strip // npg, p.n_tile // ncg, 3) == (4, 8, 3)
    assert p.n_tiles == -(-ci // p.n_tile)
    cop = -(-co // 16) * 16
    assert p.smem_bytes == c_smem(p.strip, p.n_tile, cop, p.resident, affine) \
        == conv_bn._temporal_data_f32_smem(co, p.n_tile, p.resident, affine) \
        <= 227 * 1024
    assert p.resident == (c_smem(p.strip, p.n_tile, cop, True, affine)
                          <= 227 * 1024)
    assert p.units_per_range == conv_bn._tw_units_per_block(
        p.units, p.n_tiles, sms, 1)


@pytest.mark.parametrize("mode", ["flops", "lane"])
@pytest.mark.parametrize("clips", [128, 32])
@pytest.mark.parametrize("part", ["data", "filter", "spatial_filter_walk",
                                  "spatial_data_walk", "temporal_data_walk"])
def test_plans_cover_every_train_shape(part, clips, mode):
    """Every fused unit's shape: the data gradient's position tiles each in
    exactly one range, at most 65535 ranges (the grid's y), every input
    channel in a tile, its partial rows of dinv / dshift; the filter
    gradient's chunks of 16 positions each in exactly one slice, none
    empty, at most 65535 slices and K tiles (the grid's z and y), the
    partials within _FILTER_PART_BYTES, about 8 blocks a multiprocessor
    where the work allows; the spatial filter's row walk at every spatial
    unit and at stage 1 of data.image_size=224 (112x112 images): a layout,
    N tiles of 144 (flops; lane's 1152 too) or 128 (lane) with no masked
    column, steps of 128, and what every walk plan holds
    (``_check_spatial_filter_plan``); the spatial data gradient's row walk
    at the same shapes: a layout, N tiles of 64 at C_in 64 and no masked
    column, chunks of 16 (8 at 112x112 images), one split at
    stages 1-2 and several at stages 3-4 (short M, long K), and what every
    data-walk plan holds (``_check_spatial_data_plan``); the temporal data
    gradient's frame walk at every temporal unit: C_in in whole N tiles
    (no padded column) and what every frame-walk plan holds
    (``_check_temporal_data_plan``)."""
    if part == "temporal_data_walk":
        for xs, co in _unit_shapes(clips, mode)[1::2]:
            p = conv_bn.f32_temporal_data_plan(*xs, co, SMS)
            assert xs[-1] % p.n_tile == 0
            _check_temporal_data_plan(p, *xs, co)
        return
    if part == "spatial_data_walk":
        units = _unit_shapes(clips, mode)[::2]
        units.append(((clips, 16, 112, 112, 64), units[0][1]))
        for k, (xs, co) in enumerate(units):
            p = conv_bn.f32_spatial_data_plan(*xs, co, SMS)
            assert p is not None
            assert xs[-1] % p.n_tile == 0 and (xs[-1] > 64 or p.n_tile == 64)
            assert p.k_chunk == (8 if xs[3] == 112 else 16)
            assert (p.k_splits > 1) == (k in (2, 3))
            _check_spatial_data_plan(p, *xs, co)
        return
    if part == "spatial_filter_walk":
        units = _unit_shapes(clips, mode)[::2]
        units.append(((clips, 16, 112, 112, 64), units[0][1]))
        for xs, co in units:
            p = conv_bn.f32_spatial_filter_plan(*xs, co, SMS)
            assert p is not None and p.step == 128
            assert co % p.n_tile == 0 and (co % 144 or p.n_tile == 144)
            assert p.n_tile == 144 or mode == "lane"
            _check_spatial_filter_plan(p, *xs, co)
        return
    for xs, co in _unit_shapes(clips, mode):
        b, t, h, w, ci = xs
        m = b * t * h * w
        for kind in ("spatial", "temporal"):
            if part == "data":
                p = conv_bn.f32_bwd_data_plan(b, t, h, w, ci, SMS)
                assert p == conv_bn.f32_fwd_plan(b, t, h, w, ci, SMS)
                assert p.m_tiles == -(-m // 64)
                assert (p.ranges - 1) * p.tiles_per_range < p.m_tiles \
                    <= p.ranges * p.tiles_per_range
                assert p.ranges <= 65535 and p.n_tiles * 64 >= ci
                assert p.blocks >= min(p.m_tiles * p.n_tiles, 4 * SMS)
                continue
            p = conv_bn.f32_bwd_filter_plan(b, t, h, w, ci, co, kind, SMS)
            k = (9 if kind == "spatial" else 3) * ci
            assert p.k_tiles * 64 >= k > (p.k_tiles - 1) * 64
            assert p.n_tiles * 64 >= co > (p.n_tiles - 1) * 64
            assert p.chunks == -(-m // KC)
            assert (p.slices - 1) * p.chunks_per_slice < p.chunks \
                <= p.slices * p.chunks_per_slice
            covered = [p.positions_of(s, m) for s in range(p.slices)]
            assert covered[0].start == 0 and covered[-1].stop == m
            assert all(len(r) > 0 for r in covered)
            assert all(a.stop == c.start for a, c in zip(covered, covered[1:]))
            assert p.slices <= 65535 and p.k_tiles <= 65535
            assert p.part_bytes <= conv_bn._FILTER_PART_BYTES
            assert p.part_bytes == (4 * k * co * p.slices if p.slices > 1 else 0)
            tiles = p.k_tiles * p.n_tiles
            assert p.blocks == tiles * p.slices
            # slices >= half the wanted count (chunks cut into equal runs)
            assert 2 * p.blocks >= min(tiles * p.chunks, 8 * SMS,
                                       tiles * (conv_bn._FILTER_PART_BYTES
                                                // (4 * k * co)))


# (B, T, H, W, C_in, C_out) -> (N tile, step, images a slice, slices) of
# the row walk on 132 SMs, or None (the per-tap gather): chip_smoke.py's
# F32_FILTER_WALK_EDGE_SHAPES and F32_GATHER_EDGE_SHAPES (1x1 and 240-wide
# images: steps of 64), a single pixel, images 450 wide (steps of 32 fit,
# 64 do not), C_out 1000 (seven tiles of
# 144, the last masked), stage 4 at 128 clips
SFF_PLAN_EDGES = {(1, 131, 7, 7, 24, 40): (128, 128, 2, 66),
                  (2, 3, 4, 7, 40, 200): (128, 128, 1, 6),
                  (3, 4, 1, 1, 16, 72): (128, 64, 1, 12),
                  (32, 2, 7, 7, 512, 1152): (144, 128, 64, 1),
                  (2, 2, 2, 240, 16, 16): (128, 64, 1, 4),
                  (2, 2, 2, 600, 16, 16): None,
                  (1, 1, 1, 1, 8, 8): (128, 64, 1, 1),
                  (1, 2, 2, 450, 16, 16): (128, 32, 1, 2),
                  (2, 3, 5, 7, 24, 1000): (144, 128, 1, 6),
                  (128, 2, 7, 7, 512, 1152): (144, 128, 256, 1)}


@pytest.mark.parametrize("shape", list(SFF_PLAN_EDGES),
                         ids=["x".join(map(str, s)) for s in SFF_PLAN_EDGES])
def test_spatial_filter_f32_plan_edges(shape):
    """Off the train widths: the N tile that pads C_out least (128 for 40,
    200 and 16; 144 for 1000 and 1152), steps of 128, else of 64, else of
    32, as their buffers fit, None where none do; one wave of slices, at most one per
    image (131 images: 66 slices of 2, the last of one); and what every
    walk plan holds."""
    p = conv_bn.f32_spatial_filter_plan(*shape, SMS)
    want = SFF_PLAN_EDGES[shape]
    assert (None if p is None else
            (p.n_tile, p.step, p.images_per_slice, p.slices)) == want
    if p is not None:
        _check_spatial_filter_plan(p, *shape)
        if shape[1] == 131:
            assert len(p.images_of(p.slices - 1)) == 1


# (B, T, H, W, C_in, C_out) -> (N tile, K chunk, images a range, ranges,
# K splits) of the data walk on 132 SMs, or None (the per-tap gather):
# chip_smoke.py's F32_DATA_WALK_EDGE_SHAPES (129 7x7 images four a range,
# the last one, C_in 200 in four N tiles of 64, C_out 40; 1x1 images 22 a
# step, N tiles of 128 (steps of 256 do not fit) in 8-channel chunks split
# nine ways; stages 3 and 4 at 32 clips, K split four and eight ways) and
# F32_GATHER_EDGE_SHAPES (rows of 240 and 600 pixels: no layout), stage 4 at
# 128 clips, a single pixel
SDF_PLAN_EDGES = {(1, 129, 7, 7, 200, 40): (64, 16, 4, 33, 1),
                  (3, 100, 1, 1, 16, 72): (128, 8, 22, 14, 9),
                  (32, 4, 14, 14, 256, 576): (64, 16, 16, 8, 4),
                  (32, 2, 7, 7, 512, 1152): (64, 16, 32, 2, 8),
                  (2, 2, 2, 240, 16, 16): None,
                  (2, 2, 2, 600, 16, 16): None,
                  (128, 2, 7, 7, 512, 1152): (64, 16, 128, 2, 8),
                  (1, 1, 1, 1, 8, 8): (128, 8, 1, 1, 1)}


@pytest.mark.parametrize("shape", list(SDF_PLAN_EDGES),
                         ids=["x".join(map(str, s)) for s in SDF_PLAN_EDGES])
def test_spatial_data_f32_plan_edges(shape):
    """Off the train widths: the layout of least modelled time (steps of the
    longest range x chunks of a split, plus a split's traffic and launch),
    one wave of blocks; 8-channel chunks where 16 do not fit; None where no
    layout fits (rows of 240 pixels and more); the plan's N tile with
    8-channel chunks in two splits, asked for, is taken; and what every
    data-walk plan holds."""
    p = conv_bn.f32_spatial_data_plan(*shape, SMS)
    want = SDF_PLAN_EDGES[shape]
    assert (None if p is None else (p.n_tile, p.k_chunk, p.images_per_range,
                                    p.ranges, p.k_splits)) == want
    if p is None:
        return
    _check_spatial_data_plan(p, *shape)
    if shape[1] == 129:
        assert len(p.images_of(p.ranges - 1)) == 1
    q = conv_bn.f32_spatial_data_plan(*shape, SMS, n_tile=p.n_tile,
                                      k_chunk=8, k_splits=2)
    assert (q.n_tile, q.k_chunk, q.k_splits) == (p.n_tile, 8, min(2, q.chunks))
    _check_spatial_data_plan(q, *shape)


# (B, T, H, W, C_in, C_out) -> (N tile, resident, strips a range, ranges)
# of the frame walk on 132 SMs with the prologue: chip_smoke.py's
# F32_TEMPORAL_DATA_EDGE_SHAPES (one-frame clips; 7x7 clips across strips,
# the last partial, at C_in 200 and C_out 40; the same at C_in 144 in tiles
# of 144; 81 7x7 clips at C_in 280, tiles of 144 with the second masked,
# ranges of two strips, the last of one; C_out 200, the filter streamed
# beside the x slots and resident without the prologue; the stage-4 train
# shape), C_in 288 at C_out 96 (tiles of 144), a single position, stage 4
# at 128 clips
TDF_PLAN_EDGES = {(3, 1, 7, 7, 24, 40): (64, True, 1, 2),
                  (5, 3, 7, 7, 200, 40): (64, True, 1, 2),
                  (5, 3, 7, 7, 144, 40): (144, True, 1, 5),
                  (81, 3, 7, 7, 280, 40): (144, True, 2, 36),
                  (4, 2, 5, 5, 64, 200): (64, False, 1, 1),
                  (2, 2, 9, 9, 576, 1152): (64, False, 1, 2),
                  (32, 2, 7, 7, 1152, 512): (64, False, 2, 7),
                  (2, 3, 6, 6, 288, 96): (144, False, 1, 2),
                  (1, 1, 1, 1, 8, 8): (64, True, 1, 1),
                  (128, 2, 7, 7, 1152, 512): (64, False, 7, 7)}


@pytest.mark.parametrize("shape", list(TDF_PLAN_EDGES),
                         ids=["x".join(map(str, s)) for s in TDF_PLAN_EDGES])
def test_temporal_data_f32_plan_edges(shape):
    """Off the train widths: the N tile that pads C_in least, the filter
    resident where [3·C_out, N tile] fits beside the buffers, ranges for
    the fewest strip-times to the last block's end (stage 4 at 32 clips: 7
    ranges of two strips x 18 N tiles, one wave; at 128: 7 of seven); each
    N tile asked for is taken; the resident layout's shared memory is the
    C side's (the C entry refuses it where it does not fit); and what every
    plan holds."""
    p = conv_bn.f32_temporal_data_plan(*shape, SMS)
    assert (p.n_tile, p.resident, p.units_per_range, p.ranges) \
        == TDF_PLAN_EDGES[shape]
    _check_temporal_data_plan(p, *shape)
    for nb in conv_bn._TDF_N_TILES:
        q = conv_bn.f32_temporal_data_plan(*shape, SMS, n_tile=nb)
        assert q.n_tile == nb
        _check_temporal_data_plan(q, *shape)
    cop = -(-shape[-1] // 16) * 16
    assert conv_bn._temporal_data_f32_smem(shape[-1], p.n_tile, True, True) \
        == _c_tdf()[0](p.strip, p.n_tile, cop, True, True)
    q = conv_bn.f32_temporal_data_plan(*shape, SMS, affine=False)
    _check_temporal_data_plan(q, *shape, affine=False)
    assert q.resident >= p.resident
    assert q.resident > p.resident or shape != (4, 2, 5, 5, 64, 200)


def test_frame_walk_sees_the_padding_and_the_ranges():
    """The frame walk's emulation can fail: ge formed through the formula
    at the frames -1 and T (gs1 there, of the size of gy) misses the
    reference, and a dinv without its last range's partial row misses it
    where the walk takes several ranges (five 7x7 clips of three frames,
    ranges of two, two and one strips; xa > 0 for about half the
    elements)."""
    kind, args, want, _ = _inputs(len(ALL_CASES) - len(TDF_CASES), True)
    x, inv, shift, gs1 = args[0], args[2], args[3], args[6]
    plan = conv_bn.f32_temporal_data_plan(*x.shape, args[5].shape[-1],
                                          TDF_SMS[x.shape], n_tile=144)
    assert plan.ranges == 3 and len(plan.units_of(2)) == 1
    right = _emulate_temporal_data_walk(*args, plan)
    assert _data_within(x, inv, shift, *right[:3], want)
    wrong = _emulate_temporal_data_walk(*args, plan, pad=gs1)
    assert np.abs(wrong[0] - want[0]).max() > DX_TOL * np.abs(want[0]).max()
    short = right[1] - right[3][-1]
    assert not _data_within(x, inv, shift, right[0], short, right[2], want)
    assert (x * inv + shift > 0).mean() > 0.3


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_plain_backward_runs_its_convs_without_tf32(kind, monkeypatch):
    """The plain versions' convs (``F.conv3d`` of the data gradient,
    ``torch.nn.grad.conv3d_weight`` of the filter gradient) run inside
    ``nn.full_fp32``, as the plain forward does: on the card cuDNN would
    otherwise run an fp32 conv in TF32 when chip_smoke.py calls them alone
    to hold the fp32 kernels. TF32 is turned on before the call, seen off
    inside each conv and on again after."""
    cudnn = torch.backends.cudnn
    seen = []

    def spy(fn, name):
        def wrapped(*a, **k):
            seen.append((name, cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(torch.nn.functional, "conv3d",
                        spy(torch.nn.functional.conv3d, "conv3d"))
    monkeypatch.setattr(torch.nn.grad, "conv3d_weight",
                        spy(torch.nn.grad.conv3d_weight, "conv3d_weight"))
    _, xs, ws = next(c for c in EMU_CASES if c[0] == kind)
    rng = np.random.RandomState(5)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    x, w, inv, shift = t(*xs), t(*ws), t(xs[-1]).abs(), t(xs[-1])
    co = ws[-1]
    y, gy, gs1, gs2 = t(*xs[:-1], co), t(*xs[:-1], co), t(co), t(co)
    saved = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        conv_bn.conv_unit_bwd_reference(x, w, inv, shift, y, gy, gs1, gs2,
                                        kind=kind)
        after = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert [s[0] for s in seen] == ["conv3d", "conv3d_weight"]
    assert all(not s[1] and not s[2] for s in seen), seen
    assert after == (True, True)
