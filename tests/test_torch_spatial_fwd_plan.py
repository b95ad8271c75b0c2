"""The spatial forward kernel's planner (``m3f_torch.ops.conv_bn.
spatial_fwd_plan``), on the CPU: at the four spatial units of the serving
forward (128 clips) and of the fusion train step (32 clips) and at the
forward edge shapes ``chip_smoke.py`` holds the kernel at, for a card of
132 SMs. Every output pixel falls in exactly one step of one block, the
ranges partition the images, a step's chunk buffers hold every row it
reads and a thread's copies cover them, the tiles fit the kernel's warp
layouts, shared memory stays within a block's 227 KB and matches a count
by hand, and what does not fit is refused. Exact integer checks."""

import numpy as np
import pytest

from m3f_torch.ops import conv_bn

SMS = 132
# (B, T, H, W, C_in, C_out): x is [B, T, H, W, C_in], y [..., C_out]
SERVE = [(128, 16, 56, 56, 64, 144), (128, 8, 28, 28, 128, 288),
         (128, 4, 14, 14, 256, 576), (128, 2, 7, 7, 512, 1152)]
TRAIN = [(32,) + s[1:] for s in SERVE]
# chip_smoke.py FWD_EDGE_SHAPES, spatial
EDGE = [(3, 5, 7, 9, 24, 40), (2, 3, 5, 7, 32, 136), (1, 2, 20, 20, 24, 144),
        (8, 250, 3, 5, 24, 40), (2, 2, 11, 13, 152, 288),
        (1, 2, 9, 9, 200, 152), (1, 2, 6, 6, 264, 288),
        (1, 3, 3, 200, 16, 40), (3, 4, 1, 1, 16, 8), (1, 2, 7, 7, 24, 1152)]
ALL = SERVE + TRAIN + EDGE
# (step, N tile) -> (WN, MT, NT) of dispatch_spatial_fwd; 4 warps along
# the pixels
WARPS = {(128, 144): (2, 2, 9), (256, 64): (2, 4, 4)}
SMEM_MAX = 227 * 1024


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("shape", ALL, ids=_ids(ALL))
def test_spatial_fwd_plan(shape):
    b, t, h, w, ci, co = shape
    plan = conv_bn.spatial_fwd_plan(b, t, h, w, ci, co, SMS)
    # images_of partitions the images: each in exactly one range, in order,
    # no range empty, as the kernel cuts them
    assert plan.images == b * t
    assert plan.ranges == -(-plan.images // plan.images_per_range)
    covered = [i for r in range(plan.ranges) for i in plan.images_of(r)]
    assert covered == list(range(plan.images))
    assert all(len(plan.images_of(r)) > 0 for r in range(plan.ranges))
    # one block per range and N tile; the tiles cover C_out
    assert plan.n_tiles == -(-co // plan.n_tile)
    assert plan.blocks == plan.ranges * plan.n_tiles
    assert plan.ranges == plan.images or plan.blocks <= SMS \
        or plan.n_tiles > SMS
    # the warp layout: 4 x WN warps of MT m16 pixel tiles x NT n8 channels
    wn, mt, nt = WARPS[(plan.step, plan.n_tile)]
    assert plan.warps == 4 * wn == 8
    assert plan.step == 16 * mt * 4 and plan.n_tile == 8 * nt * wn
    assert plan.step <= 32 * plan.warps       # one table entry a thread
    # the buffers: the rows of one step; a thread's copies (two 8-channel
    # vectors a pixel, 128 pixels a pass) cover them
    assert plan.buf_rows == conv_bn.spatial_ring_rows(h, w, plan.step, 1)
    assert plan.buf_rows * w <= 128 * conv_bn._SW_VMAX
    assert plan.smem_bytes == conv_bn._spatial_fwd_smem(
        w, ci, plan.step, plan.n_tile, plan.buf_rows, plan.resident)
    assert plan.smem_bytes <= SMEM_MAX
    # the choice: a layout with the filter resident where one fits, else
    # streamed; on each pass the layout that pads C_out least first (144
    # first on a tie)
    pads = {l: -(-co // l[1]) * l[1] for l in conv_bn._SW_LAYOUTS}

    def fits(layout, resident):
        rows = conv_bn.spatial_ring_rows(h, w, layout[0], 1)
        return rows * w <= 128 * conv_bn._SW_VMAX and conv_bn._spatial_fwd_smem(
            w, ci, layout[0], layout[1], rows, resident) <= SMEM_MAX
    order = [(l, r) for r in (True, False)
             for l in sorted(conv_bn._SW_LAYOUTS, key=lambda l: pads[l])]
    first = next(c for c in order if fits(*c))
    assert first == ((plan.step, plan.n_tile), plan.resident)
    # one partial row of s1 / s2 per range
    assert plan.part_rows == plan.ranges


@pytest.mark.parametrize("shape", ALL, ids=_ids(ALL))
def test_every_output_pixel_in_one_step_of_one_block(shape):
    """Block (range r, N tile) walks the pixels of its images from P0 =
    first image * H*W in steps of ``step``; only a range's last step is
    partly masked. Every pixel once per N tile."""
    b, t, h, w, ci, co = shape
    plan = conv_bn.spatial_fwd_plan(b, t, h, w, ci, co, SMS)
    hw = h * w
    seen = np.zeros(b * t * hw, dtype=np.int64)
    for r in range(plan.ranges):
        imgs = plan.images_of(r)
        p0, q = imgs.start * hw, len(imgs) * hw
        for j in range(-(-q // plan.step)):
            npx = min(plan.step, q - j * plan.step)
            assert 0 < npx <= plan.step
            seen[p0 + j * plan.step:p0 + j * plan.step + npx] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", ALL, ids=_ids(ALL))
def test_a_step_s_buffers_hold_every_row_it_reads(shape):
    """A step reads the stream rows from the one above its first pixel to
    the one below its last, the zero rows between images included."""
    b, t, h, w, ci, co = shape
    plan = conv_bn.spatial_fwd_plan(b, t, h, w, ci, co, SMS)
    q_all = len(plan.images_of(0)) * h * w
    row = lambda q: q // w + q // w // h + 1       # stream row of pixel q
    worst = max(row(min((j + 1) * plan.step, q_all) - 1) + 1
                - (row(j * plan.step) - 1) + 1
                for j in range(-(-q_all // plan.step)))
    assert worst <= plan.buf_rows


def test_byte_formula_by_hand():
    """Stage 1 (x [.., 56, 56, 64] → 144): steps of 128 pixels x 144
    channels over buffers of 7 rows. Two x buffers of 7 rows x 58 pixels x
    24 bf16 (38 976 B) share a region with the y staging (128 x 152 bf16,
    38 912 B) and the sums (2 x 4 x 144 fp32); the resident filter 144 x
    (9 x 64 + 8) bf16 (168 192 B); two tap tables of 3 x 128 ints (3072 B);
    inv / shift as 64 bf16 pairs (256 B)."""
    plan = conv_bn.spatial_fwd_plan(128, 16, 56, 56, 64, 144, SMS)
    assert (plan.step, plan.n_tile, plan.buf_rows, plan.resident) == \
        (128, 144, 7, True)
    hand = max(2 * 7 * 58 * 24 * 2, 128 * 152 * 2, 2 * 4 * 144 * 4) \
        + 144 * (9 * 64 + 8) * 2 + 2 * 3 * 128 * 4 + 4 * 64
    assert plan.smem_bytes == hand == 210496
    # stage 2, resident 64-wide tiles: buffers of 14 rows x 30 pixels, the
    # filter 64 x (9 x 128 + 8), tables of 3 x 256
    p2 = conv_bn.spatial_fwd_plan(128, 8, 28, 28, 128, 288, SMS)
    hand2 = max(2 * 14 * 30 * 24 * 2, 256 * 72 * 2) + 64 * (9 * 128 + 8) * 2 \
        + 2 * 3 * 256 * 4 + 4 * 128
    assert (p2.step, p2.resident, p2.buf_rows, p2.smem_bytes) == \
        (256, True, 14, hand2)
    # streamed (stage 3): two filter chunks of 144 x (9 x 16 + 8) bf16; the
    # staging outgrows the buffers of 14 rows x 16 pixels
    p3 = conv_bn.spatial_fwd_plan(128, 4, 14, 14, 256, 576, SMS)
    hand3 = max(2 * 14 * 16 * 24 * 2, 128 * 152 * 2) + 2 * 144 * 152 * 2 \
        + 3072 + 4 * 256
    assert (p3.resident, p3.buf_rows, p3.smem_bytes) == (False, 14, hand3)


def test_serving_stages():
    """x̂ formed once per N tile: once at stage 1 (C_out 144 in one tile, the
    filter resident), 5 times at stage 2 (tiles of 64, the filter
    resident), 4 and 8 times at stages 3-4 (tiles of 144, streamed);
    about one block a SM."""
    plans = [conv_bn.spatial_fwd_plan(*s, SMS) for s in SERVE]
    assert [(p.step, p.n_tile) for p in plans] == \
        [(128, 144), (256, 64), (128, 144), (128, 144)]
    assert [p.n_tiles for p in plans] == [1, 5, 4, 8]
    assert [p.resident for p in plans] == [True, True, False, False]
    assert [p.blocks for p in plans] == [128, 130, 128, 128]
    assert [p.images_per_range for p in plans] == [16, 40, 16, 16]


@pytest.mark.parametrize("shape,layout,resident", [
    ((3, 5, 7, 9, 24, 40), (256, 64), True),
    ((2, 3, 5, 7, 32, 136), (128, 144), True),
    ((1, 3, 3, 200, 16, 40), (128, 144), True),
    ((3, 4, 1, 1, 16, 8), (256, 64), True),
    ((2, 2, 11, 13, 152, 288), (256, 64), True),
    ((1, 2, 9, 9, 200, 152), (256, 64), False),
    ((1, 2, 6, 6, 264, 288), (128, 144), False)], ids=str)
def test_spatial_fwd_plan_branches(shape, layout, resident):
    """N tiles of 64 where they pad C_out less or keep the filter resident
    where 144 would stream it; tiles of 144 where a 256-pixel step's rows of
    200 pixels outgrow a thread's copies; streamed where neither holds the
    filter."""
    plan = conv_bn.spatial_fwd_plan(*shape, SMS)
    assert ((plan.step, plan.n_tile), plan.resident) == (layout, resident)


def test_spatial_fwd_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        conv_bn.spatial_fwd_plan(1, 1, 4, 4000, 64, 48, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        conv_bn.spatial_fwd_plan(1, 2, 4, 300, 24, 40, SMS)
