"""The spatial filter-gradient kernel's planner
(``m3f_torch.ops.conv_bn.spatial_filter_plan``), on the CPU: at the four
spatial units of the full-width fusion train step and at the edge shapes
``chip_smoke.py`` holds the kernel at, for a card of 132 SMs. Every (b, t)
image falls in exactly one slice, the fp32 partials fit their 64 MB budget,
the tiles fit the kernel's MMA shapes, the rings fit a block's shared
memory and the accumulators a thread's registers, the x ring
holds every row a step and the steps in flight touch (by walking the
largest slice as the kernel does), and the blocks fill about four waves of
the card unless every image is already its own slice or the partial budget
binds."""

import pytest

from m3f_torch.ops import conv_bn

SMS = 132
TRAIN = [(32, 16, 56, 56, 64, 144), (32, 8, 28, 28, 128, 288),
         (32, 4, 14, 14, 256, 576), (32, 2, 7, 7, 512, 1152)]
# chip_smoke.py BWD_EDGE_SHAPES, spatial: (B, T, H, W, C_in, C_out)
EDGE = [(3, 5, 7, 9, 24, 40), (2, 3, 1, 11, 40, 24), (2, 2, 6, 1, 24, 16),
        (3, 4, 1, 1, 16, 8), (2, 3, 5, 7, 152, 40), (1, 1, 9, 13, 48, 40),
        (1, 2, 2, 3, 16, 24), (3, 200, 3, 5, 16, 8), (1, 2, 70, 11, 24, 40),
        (2, 3, 4, 3, 40, 296), (1, 2, 9, 11, 40, 288), (1, 2, 9, 9, 152, 704),
        (1, 2, 14, 14, 40, 512), (2, 3, 1, 1, 24, 440), (1, 2, 7, 7, 24, 1024),
        (1, 2, 3, 200, 24, 40)]
IDS = ["x".join(map(str, s)) for s in TRAIN + EDGE]


@pytest.mark.parametrize("shape", TRAIN + EDGE, ids=IDS)
def test_spatial_filter_plan(shape):
    b, t, h, w, ci, co = shape
    plan = conv_bn.spatial_filter_plan(b, t, h, w, ci, co, SMS)
    assert plan.units == b * t
    # every image in exactly one slice, no slice empty, as the kernel cuts them
    assert plan.units_per_slice == -(-plan.units // plan.slices)
    covered = [u for s in range(plan.slices) for u in plan.units_of(s)]
    assert covered == list(range(plan.units))
    assert all(len(plan.units_of(s)) > 0 for s in range(plan.slices))
    # the partials
    out_bytes = 4 * 9 * ci * co
    assert plan.part_bytes == (plan.slices * out_bytes if plan.slices > 1 else 0)
    assert plan.part_bytes <= conv_bn._FILTER_PART_BYTES
    # the tiles: m16 output-channel tiles (ge is the A operand), one warp per
    # n8 tile of input channels, k16 pixel steps; a table entry per thread
    assert (plan.ci_blk, plan.co_tile) in conv_bn._SPATIAL_TILES
    assert plan.ci_blk % 16 == 0 and plan.co_tile % 16 == 0
    assert plan.step % 16 == 0 and 0 < plan.step <= plan.threads
    assert plan.threads == 32 * (plan.ci_blk // 8)
    # the tile pads C_in x C_out least
    padded = lambda cb, ct: -(-ci // cb) * cb * -(-co // ct) * ct
    assert padded(plan.ci_blk, plan.co_tile) == min(
        padded(*cbt) for cbt in conv_bn._SPATIAL_TILES)
    # shared memory and registers, as the plan states them
    assert plan.ring_rows == conv_bn.spatial_ring_rows(h, w, plan.step)
    assert plan.smem_bytes == conv_bn._spatial_smem(
        w, plan.ci_blk, plan.co_tile, plan.step, plan.ring_rows)
    assert plan.smem_bytes <= 227 * 1024
    assert plan.acc_regs == 9 * (plan.co_tile // 16) * 4
    # a thread's registers: 255 at most, 65536 a multiprocessor; 64 are left
    # for fragments, addresses and cursors
    assert plan.acc_regs + 64 <= min(255, 65536 // plan.threads)
    # ~4 waves: cutting ceil(units / s) images per slice leaves more than
    # (per - 1) / per of the asked-for blocks
    tiles = -(-ci // plan.ci_blk) * -(-co // plan.co_tile)
    per = plan.units_per_slice
    assert (plan.slices == plan.units
            or (plan.slices + 1) * out_bytes > conv_bn._FILTER_PART_BYTES
            or tiles * plan.slices * per >= 4 * SMS * (per - 1))


@pytest.mark.parametrize("shape", TRAIN + EDGE, ids=IDS)
def test_the_x_ring_holds_every_row_in_use(shape):
    """The kernel's walk over the largest slice: while step j is computed the
    copies of steps j+1 .. j+AHEAD are in flight, so the ring must hold the
    rows from the one above step j's first pixel to the one below step
    j+AHEAD's last, zero rows between images included."""
    b, t, h, w, ci, co = shape
    plan = conv_bn.spatial_filter_plan(b, t, h, w, ci, co, SMS)
    q_all = len(plan.units_of(0)) * h * w
    row = lambda q: q // w + q // w // h + 1       # stream row of pixel q
    steps = -(-q_all // plan.step)
    worst = 0
    for j in range(steps):
        ahead = min(j + conv_bn._SPATIAL_AHEAD, steps - 1)
        last = min((ahead + 1) * plan.step, q_all) - 1
        worst = max(worst, row(last) + 1 - (row(j * plan.step) - 1) + 1)
    assert worst <= plan.ring_rows
    # and, where the slice is long enough to meet the worst alignment, not
    # more than one step's worth of rows to spare
    if shape in TRAIN:
        assert plan.ring_rows - worst <= -(-plan.step // w) + 1


def test_spatial_filter_plan_train_stage_one():
    """Stage 1 (x [32,16,56,56,64] → 144): one channel block of 64 and three
    output tiles of 48, steps of 112 pixels (two image rows) over a ring of
    12 rows (202 KB: one block of 8 warps a SM), 171 slices of 3 images, 513
    blocks (~4 waves of 132), 57 MB of partials."""
    plan = conv_bn.spatial_filter_plan(32, 16, 56, 56, 64, 144, SMS)
    assert (plan.ci_blk, plan.co_tile, plan.step, plan.ring_rows) == (64, 48, 112, 12)
    assert (plan.units, plan.units_per_slice, plan.slices) == (512, 3, 171)
    assert plan.part_bytes == 171 * 4 * 576 * 144
    assert plan.smem_bytes == 206592
    assert (plan.threads, plan.acc_regs) == (256, 108)


def test_spatial_filter_plan_refuses_a_row_too_wide_for_the_ring():
    with pytest.raises(ValueError, match="shared memory"):
        conv_bn.spatial_filter_plan(1, 1, 4, 4000, 64, 48, SMS)
