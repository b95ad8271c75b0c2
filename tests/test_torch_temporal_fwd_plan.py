"""The temporal forward kernel's planner
(``m3f_torch.ops.conv_bn.temporal_fwd_plan``) and its walk, on the CPU: at
the four temporal units of the full-width forward (128 clips served, 32
trained) and at the narrow edge shapes ``chip_smoke.py`` holds the kernel
at, for a card of 132 SMs. Every (clip, frame, position) falls in exactly
one unit of one block's range, the tiles fit the kernel's warp layouts, the
rings and the filter fit a block's shared memory, and the partial rows are
what the wrapper allocates. A numpy run of the kernel's walk (x̂ chunks
formed once, three taps into three output frames, the frames outside a
clip skipped) is held against the plain ``conv_unit_reference``."""

import numpy as np
import pytest
import torch

from m3f_torch.ops import conv_bn

SMS = 132
# (B, T, H, W, C_in, C_out): x is [B, T, H, W, C_in], y [B, T, H, W, C_out]
FULL = [(clips, t, s, s, mid, c) for clips in (128, 32)
        for c, t, s, mid in ((64, 16, 56, 144), (128, 8, 28, 288),
                             (256, 4, 14, 576), (512, 2, 7, 1152))]
EDGE = [(2, 7, 5, 3, 40, 24), (3, 1, 6, 5, 24, 16), (2, 2, 9, 9, 48, 40),
        (2, 3, 10, 10, 152, 40), (1, 3, 9, 8, 8, 96), (2, 3, 7, 5, 296, 144),
        (2, 4, 5, 5, 40, 160), (2, 2, 3, 3, 24, 344), (3, 3, 7, 7, 576, 256),
        (1, 2, 1, 1, 16, 8), (5, 2, 3, 11, 32, 24), (2, 3, 4, 5, 16, 24),
        (1, 2, 6, 6, 112, 48)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("shape", FULL + EDGE, ids=_ids(FULL + EDGE))
def test_temporal_fwd_plan(shape):
    b, t, h, w, ci, co = shape
    plan = conv_bn.temporal_fwd_plan(b, t, h, w, ci, co, SMS)
    assert plan.positions == b * h * w
    assert plan.units == -(-plan.positions // plan.strip)
    # every unit in exactly one range, no range empty; every (clip,
    # position) pair in exactly one unit, which walks all T frames of it
    assert plan.ranges == -(-plan.units // plan.units_per_block)
    covered = [u for r in range(plan.ranges) for u in plan.units_of(r)]
    assert covered == list(range(plan.units))
    assert all(len(plan.units_of(r)) > 0 for r in range(plan.ranges))
    pairs = [g for u in range(plan.units) for g in plan.positions_of(u)]
    assert pairs == list(range(b * h * w))
    # one block per range and N tile; the tiles cover C_out
    assert plan.n_tiles == -(-co // plan.n_tile)
    assert plan.blocks == plan.ranges * plan.n_tiles
    # the fewest unit-times to the last block's end (waves x units a range)
    # of any number of units a range, and on a tie the most units a range:
    # a grid under one wave only where no split ends sooner
    per_sm = conv_bn._TW_BUILT[(plan.strip, plan.n_tile)]

    def unit_times(per):
        return -(-(-(-plan.units // per) * plan.n_tiles) // (per_sm * SMS)) * per
    best = min(unit_times(per) for per in range(1, plan.units + 1))
    assert unit_times(plan.units_per_block) == best
    assert plan.units_per_block == max(
        per for per in range(1, plan.units + 1) if unit_times(per) == best)
    # a layout the kernel is built for, warps of 32 x 32, and the first of
    # the planner's choices that fits
    assert (plan.strip, plan.n_tile, plan.resident) in conv_bn._TW_CHOICES
    assert plan.warps == (plan.strip // 32) * (plan.n_tile // 32)
    # K chunks: multiples of the k16 step covering C_in, a thread's copies
    # within TW_XV vectors
    assert plan.k_chunk % 16 == 0 and plan.chunks == -(-ci // plan.k_chunk)
    assert plan.strip * plan.k_chunk // 8 <= conv_bn._TW_XV * 32 * plan.warps
    # shared memory: what the kernel computes, within a block's 227 KB and
    # its share of the multiprocessor's 228 KB (1 KB reserved a block)
    assert plan.smem_bytes == conv_bn._temporal_fwd_smem(
        plan.strip, plan.n_tile, plan.k_chunk, plan.chunks, plan.resident)
    assert plan.smem_bytes <= 227 * 1024
    assert per_sm * (plan.smem_bytes + 1024) <= 228 * 1024
    # the partial rows of s1 / s2: one per range (the wrapper allocates
    # 2 * part_rows * C_out floats)
    assert plan.part_rows == plan.ranges


def test_temporal_fwd_plan_serving_stages():
    """Serving (128 clips): stage 1 (x [128,16,56,56,144] → 64) in strips of
    64 positions x all 64 output channels (x read and formed once), two
    blocks a SM of 4 warps, the filter resident, the whole C_in one chunk
    (106 KB a block), 262 blocks of 24 strips; stage 2 keeps the filter
    resident in N tiles of 64 (strips of 128, two chunks of 144); stages
    3-4 stream it, stage 4 in 392 blocks of one strip (three waves, three
    unit-times) where 13 ranges of four would leave 28 SMs idle (four)."""
    plans = [conv_bn.temporal_fwd_plan(*s, SMS) for s in FULL[:4]]
    p1 = plans[0]
    assert (p1.strip, p1.n_tile, p1.n_tiles, p1.resident) == (64, 64, 1, True)
    assert (p1.warps, p1.k_chunk, p1.chunks) == (4, 144, 1)
    assert (p1.units, p1.units_per_block, p1.blocks) == (6272, 24, 262)
    assert p1.smem_bytes == 106048
    assert [(p.strip, p.resident, p.n_tiles) for p in plans] == [
        (64, True, 1), (128, True, 2), (128, False, 4), (128, False, 8)]
    assert [p.chunks for p in plans] == [1, 2, 4, 8]
    assert [(p.units_per_block, p.blocks) for p in plans] == [
        (24, 262), (12, 132), (6, 132), (1, 392)]


def test_temporal_fwd_plan_train_stages():
    """Train (32 clips): every stage fills a wave except where no split
    ends sooner: stage 3 (49 strips x 4 N tiles) in 25 ranges of two, 100
    blocks in one wave (two unit-times, as 196 blocks of one strip in two
    waves), and stage 4 (13 strips x 8) with every strip its own range."""
    plans = [conv_bn.temporal_fwd_plan(*s, SMS) for s in FULL[4:]]
    assert [(p.units_per_block, p.blocks) for p in plans] == [
        (6, 262), (3, 132), (2, 100), (1, 104)]


def test_temporal_fwd_plan_strips_span_clips():
    """Where H·W is smaller than a strip (stage 4: 49 positions), one strip
    holds the positions of three clips and part of a fourth."""
    plan = conv_bn.temporal_fwd_plan(128, 2, 7, 7, 1152, 512, SMS)
    clips = {g // 49 for g in plan.positions_of(0)}
    assert clips == {0, 1, 2}
    assert {g // 49 for g in plan.positions_of(1)} == {2, 3, 4, 5}


def test_temporal_fwd_plan_layout_asked_for():
    """The sweep's layouts: a resident filter that does not fit refuses;
    the same layout streamed fits at any C_in, two blocks a SM within half
    a SM's shared memory; a layout the kernel is not built for refuses."""
    with pytest.raises(ValueError, match="shared memory"):
        conv_bn.temporal_fwd_plan(128, 2, 7, 7, 1152, 512, SMS, (128, 64, True))
    with pytest.raises(ValueError, match="shared memory"):
        conv_bn.temporal_fwd_plan(128, 8, 28, 28, 288, 128, SMS, (64, 64, True))
    plan = conv_bn.temporal_fwd_plan(128, 2, 7, 7, 1152, 512, SMS,
                                     (64, 64, False))
    assert (plan.strip, plan.n_tile, plan.resident, plan.warps) == (64, 64, False, 4)
    assert plan.smem_bytes + 1024 <= 114 * 1024 and plan.blocks <= 2 * SMS
    for layout in ((96, 64, True), (64, 128, True)):
        with pytest.raises(ValueError, match="no layout"):
            conv_bn.temporal_fwd_plan(2, 3, 4, 5, 16, 24, SMS, layout)


def _walk(x, w, inv, shift, plan):
    """The kernel's walk in numpy (fp32): per unit its strip's rows, per
    frame t its chunks of x formed into x̂ once, each multiplied into three
    accumulators (output frames t+1, t, t-1 by taps 0, 1, 2; taps whose
    output frame lies outside the clip skipped); after frame t's last chunk
    output frame t-1 leaves (and frame t after the last frame). Returns y
    with NaN where nothing was written, and the channel sums; raises on a
    second write."""
    b, t, h, wd, ci = x.shape
    co, hw = w.shape[-1], h * wd
    xf = x.reshape(b, t, hw, ci)
    y = np.full((b, t, hw, co), np.nan, np.float32)
    s1, s2 = np.zeros(co, np.float64), np.zeros(co, np.float64)
    for tile in range(plan.n_tiles):
        cols = slice(tile * plan.n_tile, min(co, (tile + 1) * plan.n_tile))
        for r in range(plan.ranges):
            for u in plan.units_of(r):
                g = np.array(plan.positions_of(u))
                rb, rp = g // hw, g % hw
                acc = np.zeros((3, len(g), cols.stop - cols.start), np.float32)

                def emit(a, tf):
                    assert np.isnan(y[rb, tf, rp, cols]).all(), "written twice"
                    y[rb, tf, rp, cols] = a
                    s1[cols] += a.sum(0)
                    s2[cols] += (a.astype(np.float64) ** 2).sum(0)
                for f in range(t):
                    for c in range(plan.chunks):
                        ch = slice(c * plan.k_chunk,
                                   min(ci, (c + 1) * plan.k_chunk))
                        xh = xf[rb, f, rp, ch]
                        if inv is not None:
                            xh = np.maximum(xh * inv[ch] + shift[ch], 0)
                        for dt in range(3):
                            if (dt == 0 and f + 1 >= t) or (dt == 2 and f == 0):
                                continue
                            acc[2 - dt] += xh @ w[dt, ch, cols]
                    if f > 0:
                        emit(acc[0], f - 1)
                    if f + 1 == t:
                        emit(acc[1], f)
                        acc[:] = 0
                    else:
                        acc = np.stack([acc[1], acc[2], np.zeros_like(acc[0])])
    return y.reshape(b, t, h, wd, co), s1, s2


WALK = [(2, 7, 5, 3, 40, 24), (3, 1, 6, 5, 24, 16), (5, 2, 3, 11, 32, 24),
        (2, 3, 7, 5, 296, 144), (3, 3, 7, 7, 576, 256)]


@pytest.mark.parametrize("shape", WALK, ids=_ids(WALK))
@pytest.mark.parametrize("affine", [False, True])
def test_kernel_walk_matches_reference(shape, affine):
    """The walk's tap order and frame bookkeeping against the plain version
    (fp32; 1e-5 relative for the summation order). Shapes: T 7 with a
    partial strip; T 1 (taps 0 and 2 never used); strips of 128 spanning
    four clips of 33 positions at T 2 (a clip must not read its neighbour's
    frames); C_in 296 (several chunks a frame, the last partial, two N
    tiles); C_in 576 with the filter streamed."""
    b, t, h, wd, ci, co = shape
    rng = np.random.RandomState(3)
    x = rng.randn(b, t, h, wd, ci).astype(np.float32)
    w = (rng.randn(3, ci, co) / np.sqrt(3 * ci)).astype(np.float32)
    inv = (rng.rand(ci) + 0.5).astype(np.float32) if affine else None
    shift = (0.3 * rng.randn(ci)).astype(np.float32) if affine else None
    plan = conv_bn.temporal_fwd_plan(b, t, h, wd, ci, co, SMS)
    y, s1, s2 = _walk(x, w, inv, shift, plan)
    assert not np.isnan(y).any(), "a (clip, frame, position) left unwritten"
    a = (torch.from_numpy(inv), torch.from_numpy(shift)) if affine else (None, None)
    y0, s10, s20 = conv_bn.conv_unit_reference(
        torch.from_numpy(x), torch.from_numpy(w), *a, kind="temporal")
    y0 = y0.numpy()
    np.testing.assert_allclose(y, y0, rtol=1e-5, atol=1e-5 * np.abs(y0).max())
    np.testing.assert_allclose(s1, s10.numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(y0).sum(axis=(0, 1, 2, 3)).max())
    np.testing.assert_allclose(s2, s20.numpy(), rtol=1e-5,
                               atol=1e-5 * float(s20.max()))
