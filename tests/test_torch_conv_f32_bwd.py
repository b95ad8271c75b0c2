"""The fp32 conv-unit backward (``bwd_data_f32_kernel``,
``spatial_filter_f32_kernel`` and ``bwd_filter_f32_kernel`` in
m3f_torch/csrc/conv_bn_f32.cu, wrapped by ``ops.conv_bn.conv_unit_bwd_data``
/ ``conv_unit_bwd_filter`` for fp32 x) where a CPU can hold it: a numpy run
of each kernel's walk against the JAX package's Pallas backward in fp32
under interpret mode (``_spatial_bwd`` / ``_temporal_bwd``, as
tests/test_torch_conv_bn_bwd.py runs them; a clip of one frame against the
XLA composition ``_xla_bwd``, since the Pallas temporal units need two
frames) and against the port's plain version, at the forward's EMU_CASES
and at FILTER_CASES with and without the prologue; the tilings
(``f32_bwd_data_plan``, ``f32_bwd_filter_plan``,
``f32_spatial_filter_plan``) at every fused unit's train shape, the last's
shared-memory formula against the C source's; and the plain versions' convs
run without TF32. The kernels themselves run only on the card
(chip_smoke.py, phase kernel_conv_f32_bwd).

Data walk: tiles of 64 positions x 64 input channels, K in chunks of 16
output channels of one tap, ge formed at the gather from gy, y, gs1 and gs2
at the tap's neighbour (0 in the padding and past C_out) against the
filter's mirrored tap, then the two-rounding xa, the mask, dx = dxa * inv
and one partial row of dinv / dshift per range of tiles, summed in order.
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
from test_torch_conv_f32 import EMU_CASES, SMS, _unit_shapes

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


def _emulate_data(x, w, inv, shift, y, gy, gs1, gs2, kind, sms=SMS):
    """The data kernel's walk in numpy (fp32): returns (dx, dinv, dshift)."""
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    taps = 9 if kind == "spatial" else 3
    plan = conv_bn.f32_bwd_data_plan(b, t, h, wd, ci, sms)
    m_all = b * t * h * wd
    wt = conv_bn.f32_bwd_data_filter(torch.from_numpy(w), kind).numpy()
    gyf, yf = gy.reshape(m_all, co), y.reshape(m_all, co)
    m = np.arange(plan.m_tiles * 64)
    ok_m = m < m_all
    nck = -(-co // KC)
    acc = np.zeros((len(m), plan.n_tiles * 64), np.float32)
    for step in range(taps * nck):
        tap, c0 = divmod(step, nck)
        cs = np.arange(c0 * KC, min(c0 * KC + KC, co))
        src, ok = _neighbour(kind, np.minimum(m, m_all - 1), tap, t, h, wd)
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
ALL_CASES = EMU_CASES + FILTER_CASES

CASES = [pytest.param(i, affine, id=f"{_case_id(*c)}-{'affine' if affine else 'plain'}")
         for i, c in enumerate(EMU_CASES) for affine in (False, True)]
WALK_CASES = [pytest.param(len(EMU_CASES) + i, affine,
                           id=f"{_case_id(*c)}-{'affine' if affine else 'plain'}")
              for i, c in enumerate(FILTER_CASES) for affine in (False, True)]


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


@pytest.mark.parametrize("i,affine", CASES)
def test_data_walk_matches_pallas_backward_fp32(i, affine):
    kind, (x, w, inv, shift, y, gy, gs1, gs2), want, plain = _inputs(i, affine)
    dx, dinv, dshift = _emulate_data(x, w, inv, shift, y, gy, gs1, gs2, kind)
    for ref in (want, plain):
        assert np.abs(dx - ref[0]).max() <= DX_TOL * np.abs(ref[0]).max()
        if inv is None:
            assert ref[2] is None and dinv is None and dshift is None
            continue
        # the scale of each channel's summation error
        mask = (x * inv + shift) > 0
        dxa = np.where(mask, ref[0] / inv, 0)
        axes = tuple(range(x.ndim - 1))
        for got, r, scale in ((dinv, ref[2], np.abs(x * dxa).sum(axes)),
                              (dshift, ref[3], np.abs(dxa).sum(axes))):
            assert (np.abs(got - r) <= S_RTOL * np.abs(r) + S_REL * scale).all()


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
    walk takes several slices."""
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


@pytest.mark.parametrize("mode", ["flops", "lane"])
@pytest.mark.parametrize("clips", [128, 32])
@pytest.mark.parametrize("part", ["data", "filter", "spatial_filter_walk"])
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
    (``_check_spatial_filter_plan``)."""
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
