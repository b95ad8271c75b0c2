"""The fp32 forward conv unit (wrapped by ``ops.conv_bn.conv_unit_fwd`` for
fp32 x; m3f_torch/csrc/conv_bn_f32.cu) where a CPU can hold it: the spatial
kind's row walk (``spatial_fwd_f32_kernel``, tiled by
``f32_spatial_fwd_plan``) and its per-tap gather for images too wide for
the walk (``conv_f32_kernel``, ``f32_fwd_plan``), the temporal kind's frame
walk (``temporal_fwd_f32_kernel``, ``f32_temporal_fwd_plan``) at every fused
unit's serving and training shape, numpy runs of the three walks against
the JAX package's Pallas units in fp32 under interpret mode (as
tests/test_conv_bn_fused.py runs them): the row walk's steps of 128 output
pixels over ranges of whole images with a zero row before every image and
after the last, zero columns, the two-rounding prologue on real pixels
only, K in chunks of 16 (or 8) input channels for all nine taps, N tiles of
144 / 128 and the fixed order of its sums; the gather's position tiles of
64, K in chunks of 16 input channels a tap with its zero padding; the frame
walk's strips of positions across clips, chunks of 16 input channels
formed once into three output-frame accumulators, the taps past the clip's
edge skipped, and the fixed order of its sums; each with partial rows of
the sums per range. Also the scoped fp32 precision of ``nn.full_fp32`` (no
TF32) across threads, and one train step of an fp32 model with fused
units against the JAX package's (its backward kernels are
tests/test_torch_conv_f32_bwd.py's). The kernels themselves run only on
the card (chip_smoke.py, phase kernel_conv_f32).

Tolerances: y within F32_TOL of its largest magnitude (fp32 sums in another
order); the sums per channel rtol 1e-4 / atol 1e-2 (tests/test_torch_conv_bn.py,
from tests/test_conv_bn_fused.py:41-46)."""

import dataclasses
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import m3f.pytorch_tpu.ops.pallas.conv_bn as cb
import m3f_torch.config as tc
from m3f_torch import nn as tnn
from m3f_torch.models.r2plus1d import midplanes
from m3f_torch.ops import conv_bn, cuda_lib

F32_TOL = 2e-5
S_RTOL, S_ATOL = 1e-4, 1e-2
SMS = 132


def _emulate(x, w, inv, shift, kind, sms=SMS):
    """The kernel's walk in numpy (fp32): returns (y, s1, s2). The temporal
    kind takes the frame walk; the spatial kind the row walk where its plan
    has a layout, else (as the wrapper) the per-tap gather."""
    b, t, h, wd, ci = x.shape
    if kind == "temporal":
        plan = conv_bn.f32_temporal_fwd_plan(b, t, h, wd, ci, w.shape[-1], sms)
        return _emulate_frame_walk(x, w, inv, shift, plan)
    plan = conv_bn.f32_spatial_fwd_plan(b, t, h, wd, ci, w.shape[-1], sms)
    if plan is not None:
        return _emulate_row_walk(x, w, inv, shift, plan)
    return _emulate_gather(x, w, inv, shift, sms)


def _colsum(rows, co):
    """colsum_f32_kernel's order: row r into lane r % 32 in order, then the
    32 lanes in order."""
    lanes = [np.zeros(co, np.float32) for _ in range(32)]
    for r, v in enumerate(rows):
        lanes[r % 32] += v
    s = np.zeros(co, np.float32)
    for v in lanes:
        s += v
    return s


def _emulate_frame_walk(x, w, inv, shift, plan):
    """temporal_fwd_f32_kernel's walk: per range its units in order, each a
    strip of ``plan.strip`` positions of the flattened B·H·W axis (across
    clips where H·W is small) walked over the frames; frame t's x̂ in chunks
    of ``plan.k_chunk`` input channels (zero past C_in) multiplied into
    three accumulator sets, output frames t+1 (tap 0), t (tap 1) and t-1
    (tap 2), a tap whose output frame lies outside the clip skipped; after
    frame t's last chunk frame t-1 leaves (and at the clip's last frame t
    too) and the sets shift. Strip row p's y and y² are summed by position
    group p % (strip / 4) over the walk in order, then the groups in order
    into the range's partial row, then the rows in colsum_f32_kernel's
    order."""
    b, t, h, wd, ci = x.shape
    co = w.shape[-1]
    hw, kc = h * wd, plan.k_chunk
    npg = plan.strip // 4                        # position groups
    cip = -(-ci // kc) * kc
    ncols = plan.n_tiles * plan.n_tile
    xh = x if inv is None else np.maximum(np.float32(x * inv) + shift,
                                          np.float32(0))
    xp = np.zeros((b, t, hw, cip), np.float32)
    xp[..., :ci] = xh.reshape(b, t, hw, ci)
    wk = np.zeros((3, cip, ncols), np.float32)
    wk[:, :ci, :co] = w
    y = np.zeros((b, t, hw, co), np.float32)
    rows1, rows2 = [], []
    for r in range(plan.ranges):
        g1 = np.zeros((npg, ncols), np.float32)
        g2 = np.zeros((npg, ncols), np.float32)
        for u in plan.units_of(r):
            pos = np.array(plan.positions_of(u))
            bi, pi = pos // hw, pos % hw
            acc = np.zeros((3, len(pos), ncols), np.float32)
            for tt in range(t):
                for c in range(cip // kc):
                    a = xp[bi, tt, pi, c * kc:(c + 1) * kc]
                    for dt in range(3):
                        if 0 <= tt + 1 - dt < t:
                            acc[2 - dt] += a @ wk[dt, c * kc:(c + 1) * kc]
                done = ([(0, tt - 1)] if tt > 0 else []) \
                    + ([(1, tt)] if tt + 1 == t else [])
                for f, tf in done:
                    y[bi, tf, pi] = acc[f][:, :co]
                    for i in range(4):
                        blk = acc[f][npg * i:npg * (i + 1)]
                        g1[:len(blk)] += blk
                        g2[:len(blk)] += blk * blk
                acc = np.stack([acc[1], acc[2], np.zeros_like(acc[2])])
        v1 = np.zeros(ncols, np.float32)
        v2 = np.zeros(ncols, np.float32)
        for g in range(npg):
            v1 += g1[g]
            v2 += g2[g]
        rows1.append(v1[:co])
        rows2.append(v2[:co])
    return (y.reshape(b, t, h, wd, co), _colsum(rows1, co),
            _colsum(rows2, co))


def _emulate_row_walk(x, w, inv, shift, plan):
    """spatial_fwd_f32_kernel's walk: per range of images a stream of rows
    (a zero row before every image and after the last, zero columns 0 and
    W+1, x̂ formed on real pixels only), steps of ``plan.step`` output
    pixels reading the buffer rows from the one above the first pixel to
    the one below the last, K in chunks of ``plan.k_chunk`` channels for
    all nine taps at one offset per pixel plus (dh·(W+2) + dw); pixel p's
    y and y² summed by pixel group p % (step / 8) over the walk in order,
    then the groups in order into the range's partial row, then the rows in
    order."""
    b, t, h, wd, ci = x.shape
    co = w.shape[-1]
    step, kc = plan.step, plan.k_chunk
    npg = step // 8                            # pixel groups (threads a column)
    cip = -(-ci // kc) * kc
    ncols = plan.n_tiles * plan.n_tile
    xh = x if inv is None else np.maximum(np.float32(x * inv) + shift,
                                          np.float32(0))
    imgs = xh.reshape(b * t, h, wd, ci)
    wk = np.zeros((9, cip, ncols), np.float32)
    wk[:, :ci, :co] = w.reshape(9, ci, co)
    y = np.zeros((b * t * h * wd, co), np.float32)
    rows1, rows2 = [], []
    for r in range(plan.ranges):
        ims = plan.images_of(r)
        stream = np.zeros((len(ims) * (h + 1) + 1, wd + 2, cip), np.float32)
        for k, i in enumerate(ims):
            stream[k * (h + 1) + 1:(k + 1) * (h + 1), 1:wd + 1, :ci] = imgs[i]
        q_all = len(ims) * h * wd
        p0 = ims[0] * h * wd
        g1 = np.zeros((npg, ncols), np.float32)
        g2 = np.zeros((npg, ncols), np.float32)
        for j in range(-(-q_all // step)):
            q = np.arange(j * step, min(q_all, (j + 1) * step))
            rho = q // wd
            vr = rho + rho // h + 1            # stream rows of the pixels
            rs, re = vr[0] - 1, vr[-1] + 1
            assert re - rs + 1 <= plan.buf_rows
            buf = stream[rs:re + 1]
            lr, col = vr - rs, q - rho * wd
            acc = np.zeros((len(q), ncols), np.float32)
            for ck in range(cip // kc):
                for tap in range(9):
                    dh, dw = divmod(tap, 3)
                    a = buf[lr - 1 + dh, col + dw, ck * kc:(ck + 1) * kc]
                    acc += a @ wk[tap, ck * kc:(ck + 1) * kc]
            y[p0 + q] = acc[:, :co]
            for i in range(0, len(q), npg):
                blk = acc[i:i + npg]
                g1[:len(blk)] += blk
                g2[:len(blk)] += blk * blk
        v1 = np.zeros(ncols, np.float32)
        v2 = np.zeros(ncols, np.float32)
        for g in range(npg):
            v1 += g1[g]
            v2 += g2[g]
        rows1.append(v1[:co])
        rows2.append(v2[:co])
    s1 = np.zeros(co, np.float32)
    s2 = np.zeros(co, np.float32)
    for v1, v2 in zip(rows1, rows2):
        s1 += v1
        s2 += v2
    return y.reshape(b, t, h, wd, co), s1, s2


def _emulate_gather(x, w, inv, shift, sms=SMS):
    """conv_f32_kernel's walk (the spatial kind where no row-walk layout
    fits)."""
    b, t, h, wd, ci = x.shape
    co = w.shape[-1]
    plan = conv_bn.f32_fwd_plan(b, t, h, wd, co, sms)
    m_all = b * t * h * wd
    xf = x.reshape(m_all, ci)
    wk = w.reshape(9 * ci, co)
    m = np.arange(plan.m_tiles * 64)
    ok_m = m < m_all
    r = m % (h * wd)
    gh, gw = r // wd, r % wd
    acc = np.zeros((len(m), plan.n_tiles * 64), np.float32)
    for step in range(9 * -(-ci // 16)):
        tap, c0 = divmod(step, -(-ci // 16))
        c0 *= 16
        dh, dw = tap // 3 - 1, tap % 3 - 1
        ok = ok_m & (gh + dh >= 0) & (gh + dh < h) & (gw + dw >= 0) \
            & (gw + dw < wd)
        src = m + dh * wd + dw
        a = np.zeros((len(m), 16), np.float32)
        cs = np.arange(c0, min(c0 + 16, ci))
        v = xf[np.where(ok, src, 0)][:, cs]
        if inv is not None:
            v = np.maximum(np.float32(v * inv[cs]) + shift[cs], np.float32(0))
        a[:, :len(cs)] = np.where(ok[:, None], v, 0)
        bm = np.zeros((16, plan.n_tiles * 64), np.float32)
        bm[:len(cs), :co] = wk[tap * ci + cs]
        acc += a @ bm
    y = acc[:m_all, :co]
    # one partial row per range of tiles_per_range tiles, summed in order
    rows = [y[r * plan.tiles_per_range * 64:(r + 1) * plan.tiles_per_range * 64]
            for r in range(plan.ranges)]
    s1 = np.sum([q.sum(0) for q in rows], axis=0, dtype=np.float32)
    s2 = np.sum([(q * q).sum(0) for q in rows], axis=0, dtype=np.float32)
    return y.reshape(b, t, h, wd, co), s1, s2


# (kind, x shape, w shape): a partial last position tile (M not a multiple
# of 64), partial chunks (C_in 24, 8), a partial output-channel tile (C_out
# 40, 72), 1x1 images (every spatial tap but the centre in the padding),
# one frame and two (temporal padding), clips across a strip
EMU_CASES = [
    ("spatial", (2, 3, 5, 7, 24), (3, 3, 24, 40)),
    ("spatial", (3, 2, 1, 1, 8), (3, 3, 8, 72)),
    ("spatial", (1, 2, 9, 4, 40), (3, 3, 40, 16)),
    ("temporal", (2, 1, 3, 5, 24), (3, 24, 40)),
    ("temporal", (3, 2, 4, 5, 16), (3, 16, 72)),
    ("temporal", (2, 5, 6, 3, 40), (3, 40, 24)),
    # the row walk: W 7 with steps across images (ranges of 4 images of 49
    # pixels, the last range's one step partial), a partial chunk and a
    # masked N tile; 1x1 images (a zero row between every two pixels: the
    # 16-channel buffers do not fit, the 8-channel ones do) with C_out 200
    # in two N tiles of 128; 4x7 images, three a step, C_in 40 (chunks of
    # 16, 16, 8); 7x7 images at C_out 144, one N tile
    ("spatial", (2, 5, 7, 7, 24), (3, 3, 24, 40)),
    ("spatial", (1, 4, 1, 1, 16), (3, 3, 16, 200)),
    ("spatial", (2, 3, 4, 7, 40), (3, 3, 40, 200)),
    ("spatial", (2, 4, 7, 7, 16), (3, 3, 16, 144)),
    # images too wide for the row walk: the spatial kind's per-tap gather
    ("spatial", (1, 2, 2, 240, 16), (3, 3, 16, 16)),
    # the frame walk: 7x7 clips of two frames, strips across clips (49
    # positions < 128) and two units in one range; C_in 40 (chunks of 16,
    # 16, 8) at C_out 200 (N tiles of 64, the last masked to 8 channels);
    # clips of one frame, a strip across five 5x5 clips
    ("temporal", (3, 2, 7, 7, 16), (3, 16, 40)),
    ("temporal", (2, 3, 4, 7, 40), (3, 40, 200)),
    ("temporal", (5, 1, 5, 5, 8), (3, 8, 16)),
]
# the multiprocessors the plan is made for, where not SMS: fewer put
# several images (spatial) or strips (temporal) in a range, so that a step
# spans images or a block walks several strips
EMU_SMS = {(2, 5, 7, 7, 24): 3, (1, 4, 1, 1, 16): 2, (2, 3, 4, 7, 40): 4,
           (2, 4, 7, 7, 16): 2, (3, 2, 1, 1, 8): 2, (3, 2, 7, 7, 16): 1}


def _data(xshape, wshape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*xshape).astype(np.float32),
            (0.1 * rng.randn(*wshape)).astype(np.float32),
            (rng.rand(xshape[-1]) + 0.5).astype(np.float32),
            (0.1 * rng.randn(xshape[-1])).astype(np.float32))


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("kind,xshape,wshape", EMU_CASES)
def test_kernel_walk_matches_pallas_unit_fp32(kind, xshape, wshape, affine):
    x, w, inv, shift = _data(xshape, wshape, seed=len(xshape) + xshape[0])
    a = (inv, shift) if affine else (None, None)
    got = _emulate(x, w, *a, kind, sms=EMU_SMS.get(xshape, SMS))
    ja = tuple(jnp.asarray(v) for v in a) if affine else (None, None)
    wants = [cb.conv_unit_reference(jnp.asarray(x), jnp.asarray(w), *ja,
                                    kind=kind)]
    if kind == "spatial" or xshape[1] > 1:    # the Pallas unit's T-axis
        with pltpu.force_tpu_interpret_mode():  # im2col needs two frames
            wants.append(cb.conv_unit(jnp.asarray(x), jnp.asarray(w), *ja,
                                      kind=kind))
    for want in wants:
        y = np.asarray(want[0])
        assert np.abs(got[0] - y).max() <= F32_TOL * np.abs(y).max()
        for g, s in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, np.asarray(s), rtol=S_RTOL,
                                       atol=S_ATOL)
    # and the CPU wrapper (the plain version) gives the same unit
    port = conv_bn.conv_unit_fwd(
        torch.from_numpy(x), torch.from_numpy(w),
        *(torch.from_numpy(v) for v in a) if affine else (None, None),
        kind=kind)
    assert np.abs(port[0].numpy() - y).max() <= F32_TOL * np.abs(y).max()


def _unit_shapes(clips, mode):
    """(x shape, C_out) of every fused unit of R(2+1)D-18 over ``clips``."""
    out = []
    for c, t, s in ((64, 16, 56), (128, 8, 28), (256, 4, 14), (512, 2, 7)):
        mid = midplanes(c, c, mode=mode)
        out += [((clips, t, s, s, c), mid), ((clips, t, s, s, mid), c)]
    return out


@pytest.mark.parametrize("mode", ["flops", "lane"])
@pytest.mark.parametrize("clips", [128, 32])
def test_plan_covers_every_unit_shape(clips, mode):
    """Every position tile in exactly one range, at most 65535 ranges (the
    grid's y), about 8 blocks a multiprocessor, every output channel in a
    tile."""
    for xs, co in _unit_shapes(clips, mode):
        b, t, h, w, _ = xs
        p = conv_bn.f32_fwd_plan(b, t, h, w, co, SMS)
        assert p.m_tiles == -(-b * t * h * w // 64)
        assert (p.ranges - 1) * p.tiles_per_range < p.m_tiles \
            <= p.ranges * p.tiles_per_range
        assert p.ranges <= 65535 and p.n_tiles * 64 >= co
        assert p.blocks <= 8 * SMS + p.n_tiles
        assert p.blocks >= min(p.m_tiles * p.n_tiles, 4 * SMS)


@pytest.mark.parametrize("mode", ["flops", "lane"])
@pytest.mark.parametrize("clips", [128, 32])
def test_spatial_fwd_plan_covers_every_spatial_unit(clips, mode):
    """The row walk's plan at every fused spatial unit (C_in -> the
    midplane width): a layout at every one, every image in exactly one
    range, one wave of blocks, N tiles covering C_out, NB 144 or 128 where
    one divides C_out (so no masked columns at any fused width), steps of
    112 (NB 144) or 128 (NB 128) pixels, at 128 clips those of 112 ending
    on the ranges' last pixel (16 images), at most 8 warps a block, the
    16-channel chunks, buffers that hold a step's rows and that a thread's
    copies cover, within a block's shared memory, at most 65535 ranges."""
    for xs, co in _unit_shapes(clips, mode)[::2]:
        b, t, h, w, ci = xs
        p = conv_bn.f32_spatial_fwd_plan(b, t, h, w, ci, co, SMS)
        assert p is not None and p.k_chunk == 16
        assert p.images == b * t
        covered = [i for r in range(p.ranges) for i in p.images_of(r)]
        assert covered == list(range(p.images))
        assert all(len(p.images_of(r)) for r in range(p.ranges))
        assert p.ranges <= 65535 and p.part_rows == p.ranges
        assert p.n_tile in (144, 128) and p.n_tiles == -(-co // p.n_tile)
        assert co % p.n_tile == 0 and (co % 144 or p.n_tile == 144)
        assert p.blocks == p.ranges * p.n_tiles <= SMS
        assert p.step == {144: 112, 128: 128}[p.n_tile]
        assert p.threads == p.step // 8 * p.n_tile // 8 <= 256
        if p.n_tile == 144 and clips == 128:
            assert p.images_per_range * h * w % p.step == 0
        assert p.buf_rows == conv_bn.spatial_ring_rows(h, w, p.step, 1)
        assert p.buf_rows * w <= 8 * p.threads // (p.k_chunk // 4)
        assert p.smem_bytes == conv_bn._spatial_fwd_f32_smem(
            w, p.buf_rows, p.k_chunk, p.n_tile) <= 227 * 1024


# (B, T, H, W, C_in, C_out) -> (N tile, K chunk) or None (the gather)
PLAN_EDGES = {(2, 5, 7, 7, 24, 40): (128, 16),
              (1, 4, 1, 1, 16, 200): (128, 8),
              (2, 3, 4, 7, 40, 200): (128, 16),
              (3, 5, 7, 9, 24, 1152): (144, 16),
              (1, 2, 7, 7, 24, 256): (128, 16),
              (1, 2, 2, 200, 16, 16): (128, 8),
              (1, 2, 2, 240, 16, 16): None,
              (1, 2, 2, 600, 16, 16): None}


@pytest.mark.parametrize("shape", list(PLAN_EDGES),
                         ids=["x".join(map(str, s)) for s in PLAN_EDGES])
def test_spatial_fwd_plan_edges(shape):
    """Off the fused widths: C_out 40 and 200 take the N tile that pads
    least (128), 1152 the one with fewer tiles (144); buffers too large
    for 16-channel chunks take 8-channel ones, and images too wide for
    both go to the per-tap gather (None). Every step's rows fit the
    buffers (the numpy walk asserts it); a layout asked for is taken."""
    b, t, h, w, ci, co = shape
    p = conv_bn.f32_spatial_fwd_plan(b, t, h, w, ci, co, SMS)
    assert (None if p is None else (p.n_tile, p.k_chunk)) == PLAN_EDGES[shape]
    if p is not None:
        assert p.smem_bytes <= 227 * 1024
        assert p.buf_rows * w <= 8 * p.threads // (p.k_chunk // 4)
        q = conv_bn.f32_spatial_fwd_plan(b, t, h, w, ci, co, SMS,
                                         n_tile=p.n_tile, k_chunk=8)
        assert q is not None and (q.n_tile, q.k_chunk) == (p.n_tile, 8)


def _twf_source():
    """conv_bn_f32.cu's text and its TWF_ constants."""
    src = (Path(conv_bn.__file__).parents[1] / "csrc" / "conv_bn_f32.cu"
           ).read_text()
    return src, {k: int(v) for k, v in
                 re.findall(r"constexpr int (TWF_\w+) = (\d+);", src)}


def _c_twf_smem():
    """twf_smem of conv_bn_f32.cu as a Python function of (strip, N tile,
    C_in in whole chunks, resident): its two expressions read from the
    source, so the plan's formula is held against the C side's."""
    src, consts = _twf_source()
    body = re.search(r"size_t twf_smem\(int S, int NB, int Cip, int res\) "
                     r"\{(.*?)\n\}", src, re.S).group(1)
    filt = re.search(r"const size_t filt = res \? (.*?) : (.*?);", body, re.S)
    total = re.search(r"return sizeof\(float\) \* (.*?);", body, re.S).group(1)
    py = lambda e: " ".join(e.replace("(size_t)", "").split())

    def smem(strip, n_tile, cip, resident):
        env = {"S": strip, "NB": n_tile, "Cip": cip, **consts}
        env["filt"] = eval(py(filt.group(1 if resident else 2)), {}, env)
        return 4 * eval(py(total), {}, env)
    return smem


def _check_temporal_plan(p, b, t, h, w, ci, co):
    """What every fp32 frame-walk plan must hold: every position in exactly
    one strip and every strip in exactly one non-empty range, the strip, N
    tile, threads (8 warps), register tile and chunk of the C side's
    constants, N tiles covering C_out, the resident filter exactly where it
    fits a block's shared memory, and a shared-memory size that is the C
    side's."""
    assert p.positions == b * h * w and p.units == -(-p.positions // p.strip)
    covered = [q for u in range(p.units) for q in p.positions_of(u)]
    assert covered == list(range(p.positions))
    units = [u for r in range(p.ranges) for u in p.units_of(r)]
    assert units == list(range(p.units))
    assert all(len(p.units_of(r)) for r in range(p.ranges))
    assert p.part_rows == p.ranges and p.blocks == p.ranges * p.n_tiles
    _, c = _twf_source()
    assert (p.strip, p.n_tile, p.k_chunk, p.threads) == (
        4 * c["TWF_NPG"], 8 * c["TWF_NCG"], c["TWF_KC"],
        c["TWF_NPG"] * c["TWF_NCG"]) == (128, 64, 16, 256)
    assert p.register_tile == (p.strip // c["TWF_NPG"],
                               p.n_tile // c["TWF_NCG"], 3) == (4, 8, 3)
    assert p.n_tiles == -(-co // p.n_tile)
    cip = -(-ci // 16) * 16
    c_smem = _c_twf_smem()
    assert p.smem_bytes == c_smem(p.strip, p.n_tile, cip, p.resident) \
        == conv_bn._temporal_fwd_f32_smem(ci, p.resident)
    assert p.resident == (c_smem(p.strip, p.n_tile, cip, True) <= 227 * 1024)
    assert p.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("mode", ["flops", "lane"])
@pytest.mark.parametrize("clips", [128, 32])
def test_temporal_fwd_f32_plan_covers_every_temporal_unit(clips, mode):
    """The frame walk's plan at every fused temporal unit (the midplane
    width -> C_out): C_out in whole N tiles of 64 (at stage 1 one tile, so
    x̂ is formed once), the filter resident at stage 1 (and at lane's stage
    2, C_in 256), one wave of blocks
    unless a range is one strip (stage 4 at 128 clips: 49 strips x 8 N
    tiles, three waves of one strip against two of two), and what every
    plan holds (``_check_temporal_plan``)."""
    for xs, co in _unit_shapes(clips, mode)[1::2]:
        b, t, h, w, ci = xs
        p = conv_bn.f32_temporal_fwd_plan(b, t, h, w, ci, co, SMS)
        _check_temporal_plan(p, b, t, h, w, ci, co)
        assert co % p.n_tile == 0
        assert p.resident or co > 64
        assert p.blocks <= SMS or p.units_per_range == 1


# (B, T, H, W, C_in, C_out) -> the filter resident
TWF_PLAN_EDGES = {(1, 1, 1, 1, 8, 8): True,
                  (2, 3, 4, 7, 40, 200): True,
                  (4, 2, 5, 5, 272, 64): True,
                  (4, 2, 5, 5, 280, 64): False,
                  (1, 5, 3, 3, 256, 128): True,
                  (3, 4, 1, 1, 288, 16): False,
                  (2, 3, 9, 9, 1152, 1000): False,
                  (32, 2, 7, 7, 1152, 512): False}


@pytest.mark.parametrize("shape", list(TWF_PLAN_EDGES),
                         ids=["x".join(map(str, s)) for s in TWF_PLAN_EDGES])
def test_temporal_fwd_f32_plan_edges(shape):
    """Off the fused widths: the resident filter up to the last C_in that
    fits beside the x buffers (272), streamed beyond (280, 288 at 1x1
    images); a single position; C_out 72, 200 and 1000 in masked tiles; the
    stage-4 train shape (13 strips x 8 N tiles for 132 SMs); and what every
    plan holds."""
    p = conv_bn.f32_temporal_fwd_plan(*shape, SMS)
    assert p.resident == TWF_PLAN_EDGES[shape]
    _check_temporal_plan(p, *shape)


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 4, 5), (1, 2, 7, 1)])
def test_tap_pairs_count_the_products_inside_the_clip(kind, shape):
    """``tap_pairs`` (the operation count of the units' bounds) is the
    plain unit's y summed at x = 1, w = 1, one channel in and out, no
    prologue: one per (position, tap) pair whose input lies in the clip."""
    ws = (3, 3, 1, 1) if kind == "spatial" else (3, 1, 1)
    y = conv_bn.conv_unit_reference(
        torch.ones(*shape, 1, dtype=torch.float64),
        torch.ones(*ws, dtype=torch.float64), kind=kind)[0]
    assert conv_bn.tap_pairs(kind, *shape) == int(y.sum())


def test_full_fp32_turns_tf32_off_while_any_thread_is_inside():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, True
        inside, release = threading.Event(), threading.Event()
        seen = []

        def hold():
            with tnn.full_fp32():
                inside.set()
                release.wait(10)
        th = threading.Thread(target=hold)
        th.start()
        inside.wait(10)
        with tnn.full_fp32():
            seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        # this thread left first: the other is still inside
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        release.set()
        th.join()
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        assert seen == [(False, False), (False, False), (True, True)]
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_model_precision_scope_is_for_fp32_on_the_card_only():
    """``M3F.precision`` is ``full_fp32`` for an fp32 model whose weights
    lie on the card, nothing for a CPU model (TF32 exists only there) or a
    bf16 one; chip_smoke.py's serve_backbones shows the scope on the card."""
    from m3f_torch.models.m3f import M3F
    cfg = tc.ModelConfig(audio=tc.AudioNetConfig(channels=(4, 8), feature_dim=8),
                         visual=tc.VisualNetConfig(block_channels=(8,),
                                                   blocks_per_stage=(1,),
                                                   stem_channels=8,
                                                   feature_dim=8),
                         gru=tc.GRUConfig(hidden_size=8))
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        for dtype in ("float32", "bfloat16"):
            m = M3F(dataclasses.replace(cfg, compute_dtype=dtype), device="cpu")
            with m.precision():
                assert cudnn.allow_tf32
    finally:
        cudnn.allow_tf32 = saved


def _model(dtype, use_video=True, **visual):
    from m3f_torch.models.m3f import M3F
    cfg = tc.ModelConfig(
        compute_dtype=dtype, use_video=use_video,
        audio=tc.AudioNetConfig(channels=(4, 8), feature_dim=8),
        visual=tc.VisualNetConfig(block_channels=(8, 16),
                                  blocks_per_stage=(2, 1), stem_channels=8,
                                  feature_dim=16, **visual),
        gru=tc.GRUConfig(hidden_size=8))
    return M3F(cfg, device="cpu")


def _train_cfg(mod, **visual):
    """fp32, narrow, video only (the audio branch's mel frontend has its own
    tolerance against the reference's), every block of stage 1 a fused
    2plus1d block (the reference's ``pallas_fused`` backend: its BatchNorm
    statistics from the units' sums, as the port's); SGD at a learning rate of 1e4 without clipping, so one
    step moves each parameter by -1e4 times its gradient, far above the
    rounding of the weights."""
    return mod.ExperimentConfig(
        name="t",
        model=mod.ModelConfig(
            use_audio=False,
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            visual=mod.VisualNetConfig(block_channels=(8, 16),
                                       blocks_per_stage=(2, 1),
                                       stem_channels=8, feature_dim=16,
                                       conv_backend="pallas_fused", **visual),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype="float32"),
        window=mod.WindowConfig(windows_per_clip=2),
        data=mod.DataConfig(synthetic_num_videos=2, synthetic_video_frames=64,
                            image_size=32),
        train=mod.TrainConfig(batch_size=2, num_steps=1, log_every=1,
                              eval_every=0, checkpoint_every=0,
                              optim=mod.OptimConfig(optimizer="sgd",
                                                    learning_rate=1e4,
                                                    grad_clip_norm=1e12),
                              mesh=mod.MeshConfig(num_data=1)))


LR = 1e4
GRAD_FLOOR = 2e-5        # of a gradient's norm (F32_TOL of
#                          tests/test_torch_backbones.py)
NOISE_MULT = 2.0         # times the reference's own move (see the test)
WEIGHT_CHANGE = 1e-5     # the relative weight change that move is taken at


@pytest.mark.parametrize("visual", [{}, {"stem_s2d": True},
                                    {"mid_mode": "lane"}],
                         ids=["2plus1d", "stem_s2d", "lane"])
def test_fp32_fused_model_train_step_matches_jax(visual):
    """An fp32 model whose visual branch runs fused units (the card once
    refused to train it) takes one ``Trainer.train_step`` on the CPU, from
    the same weights and batch as the JAX package's train step: the loss
    within 1e-5, and each parameter's gradient (its move over -LR) in L2
    within NOISE_MULT times the larger of the reference's own gradient
    moves when every weight changes by WEIGHT_CHANGE with a random sign
    (two draws), plus GRAD_FLOOR of the gradient's norm. A random-init R(2+1)D trained on
    batch statistics through the CCC loss is that ill-conditioned in fp32:
    the two implementations' rounding moves some gradients by up to 3% of
    their norm here, about what a 1e-5 change of the weights does to the
    reference's own (measured; tests/test_torch_train.py), so
    no fixed tolerance near fp32 rounding holds them, while a wrong
    gradient (a missed tap, the padding through the formula) misses by
    far more."""
    import jax
    import m3f.pytorch_tpu.config as jc
    from m3f.pytorch_tpu.data.synthetic import SyntheticAVDataset as JDS
    from m3f.pytorch_tpu.data.windowing import WindowSequencer as JSeq
    from m3f.pytorch_tpu.data.windowing import example_stream as jstream
    from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
    from m3f_torch.train.checkpoint import from_jax_params
    from m3f_torch.train.loop import Trainer
    jcfg, tcfg = _train_cfg(jc, **visual), _train_cfg(tc, **visual)
    jds = JDS(jcfg.data, jcfg.model.mel)
    batch = next(jstream(jds, JSeq(jcfg.window, jcfg.model.mel, mel_frames=16),
                         jcfg.train.batch_size, seed=0))
    jt = JTrainer(jcfg)
    step = jt.make_train_step()

    def jax_grads(seed=None):
        """The reference's gradients (its move over -LR), its metrics and
        its weights: from its seeded init, or from that init with every
        weight WEIGHT_CHANGE off (a random sign each)."""
        st = jt.init_state()             # the step donates its state
        p0, s0 = jax.device_get(st.params), jax.device_get(st.bn_state)
        if seed is not None:
            rs = np.random.RandomState(seed)
            p0 = jax.tree_util.tree_map(
                lambda v: v * (1 + WEIGHT_CHANGE * rs.choice([-1.0, 1.0],
                                                             v.shape)
                               ).astype(v.dtype), p0)
            st = st._replace(params=jax.device_put(p0))
        with jax.default_matmul_precision("highest"), \
                pltpu.force_tpu_interpret_mode():
            new, metrics = step(st, batch)
        w0 = from_jax_params(p0, {})
        w1 = from_jax_params(jax.device_get(new.params), {})
        return ({n: (w1[n] - w0[n]).numpy() / -LR for n in w0}, metrics,
                p0, s0)
    want, jmetrics, p0, s0 = jax_grads()
    moved = [jax_grads(seed)[0] for seed in (7, 8)]
    pt = Trainer(tcfg, device="cpu")
    assert pt.model.dtype == torch.float32 and pt.model.visual.fused_blocks
    pt.model.load_state_dict(from_jax_params(p0, s0))
    state = pt.init_state(keep_weights=True)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    metrics = pt.train_step(state, {k: np.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-5)
    assert want.keys() == before.keys()
    for n, p in state.params.items():
        got = (p.detach() - before[n]).numpy() / -LR
        size = np.linalg.norm(want[n])
        noise = max(np.linalg.norm(m[n] - want[n]) for m in moved)
        err = np.linalg.norm(got - want[n])
        assert err <= NOISE_MULT * noise + GRAD_FLOOR * size, (n, err, noise)
