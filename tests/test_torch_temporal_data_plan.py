"""The temporal data-gradient kernel's planner
(``m3f_torch.ops.conv_bn.temporal_data_plan``), on the CPU: at the four
temporal units of the full-width fusion train step and at the temporal edge
shapes ``chip_smoke.py`` holds the kernel at, for a card of 132 SMs. Every
(clip, strip) unit falls in exactly one block's range, no block is empty,
the tiles fit the kernel's MMA shapes and warp layouts, the rings and the
filter fit a block's shared memory, and the partial rows are what the
wrapper allocates."""

import pytest

from m3f_torch.ops import conv_bn

SMS = 132
# (B, T, H, W, C_in, C_out): x is [B, T, H, W, C_in], gy [B, T, H, W, C_out]
TRAIN = [(32, 16, 56, 56, 144, 64), (32, 8, 28, 28, 288, 128),
         (32, 4, 14, 14, 576, 256), (32, 2, 7, 7, 1152, 512)]
EDGE = [(2, 7, 5, 3, 40, 24), (3, 1, 6, 5, 24, 16), (2, 2, 9, 9, 48, 40),
        (4, 3, 5, 7, 64, 24), (2, 4, 6, 6, 40, 24), (2, 3, 10, 10, 152, 40),
        (1, 2, 4, 5, 16, 8), (3, 1, 6, 5, 160, 104), (2, 3, 7, 5, 296, 144),
        (2, 4, 5, 5, 40, 160), (2, 2, 3, 3, 24, 344), (1, 3, 9, 8, 8, 96)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("shape", TRAIN + EDGE, ids=_ids(TRAIN + EDGE))
def test_temporal_data_plan(shape):
    b, t, h, w, ci, co = shape
    plan = conv_bn.temporal_data_plan(b, t, h, w, ci, co, SMS)
    assert plan.units == b * -(-h * w // plan.strip)
    # every unit in exactly one range, no range empty, as the kernel cuts them
    assert plan.ranges == -(-plan.units // plan.units_per_block)
    covered = [u for r in range(plan.ranges) for u in plan.units_of(r)]
    assert covered == list(range(plan.units))
    assert all(len(plan.units_of(r)) > 0 for r in range(plan.ranges))
    # one block per range and N tile; the tiles cover C_in
    assert plan.n_tiles == -(-ci // plan.n_tile)
    assert plan.blocks == plan.ranges * plan.n_tiles
    # one block a multiprocessor, unless every unit is its own range or the
    # N tiles alone outnumber the card
    assert plan.ranges == plan.units or plan.blocks <= SMS \
        or plan.n_tiles > SMS
    assert plan.ranges == plan.units \
        or (plan.ranges + 1) * plan.n_tiles > SMS * (plan.units_per_block - 1) \
        / plan.units_per_block
    # the warp layout: m16 row tiles, n8 column tiles, k16 steps of C_out
    # rounded up; a layout the kernel is built for
    assert plan.strip % 16 == 0 and plan.n_tile % 8 == 0
    assert (plan.strip, plan.warps, plan.resident) in {
        (64, 8, True), (32, 6, True), (32, 6, False), (16, 6, False)}
    rows_of_warps = plan.strip // 16
    assert plan.warps % rows_of_warps == 0
    assert plan.n_tile % (8 * (plan.warps // rows_of_warps)) == 0
    # shared memory: what the kernel computes, within a block's 227 KB; the
    # choice is the first that fits (a wider strip, the filter resident or
    # two frames ahead would not)
    assert plan.ahead in ((1, 2) if plan.resident else (1,))
    assert plan.smem_bytes == conv_bn._temporal_data_smem(
        plan.strip, co, plan.resident, plan.ahead)
    assert plan.smem_bytes <= 227 * 1024
    choices = [(s, r, a) for s, r in conv_bn._TD_CHOICES
               for a in ((2, 1) if r else (1,))]
    for s, r, a in choices[:choices.index(
            (plan.strip, plan.resident, plan.ahead))]:
        assert conv_bn._temporal_data_smem(s, co, r, a) > 227 * 1024
    # the partial rows of dinv / dshift: one per range (the wrapper
    # allocates 2 * part_rows * C_in floats)
    assert plan.part_rows == plan.ranges


@pytest.mark.parametrize("co,want", [(8, (64, True, 2)), (64, (64, True, 2)),
                                     (72, (64, True, 1)), (96, (64, True, 1)),
                                     (104, (32, True, 2)), (128, (32, True, 2)),
                                     (144, (32, True, 1)), (152, (32, False, 1)),
                                     (336, (32, False, 1)), (344, (16, False, 1)),
                                     (752, (16, False, 1))])
def test_temporal_data_plan_branches(co, want):
    """Each branch of the planner by C_out: the filter resident beside tiles
    of 64 and of 32 positions, two frames ahead or one; then streamed with
    32 and with 16 positions."""
    plan = conv_bn.temporal_data_plan(2, 3, 10, 10, 152, co, SMS)
    assert (plan.strip, plan.resident, plan.ahead) == want


def test_temporal_data_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        conv_bn.temporal_data_plan(2, 3, 10, 10, 152, 760, SMS)


def test_temporal_data_plan_train_stage_one():
    """Stage 1 (gy [32,16,56,56,64] → dx 144): strips of 64 positions, all
    144 input channels in one block (ge formed once), the filter resident,
    two frames ahead, 205 KB a block: 131 blocks of 12 units on 132 SMs."""
    plan = conv_bn.temporal_data_plan(32, 16, 56, 56, 144, 64, SMS)
    assert (plan.strip, plan.n_tile, plan.warps) == (64, 144, 8)
    assert (plan.resident, plan.ahead, plan.n_tiles) == (True, 2, 1)
    assert (plan.units, plan.units_per_block, plan.ranges) == (1568, 12, 131)
    assert (plan.blocks, plan.part_rows) == (131, 131)
    assert plan.smem_bytes == 210240


def test_temporal_data_plan_train_wider_stages():
    """Stages 2-4: ge is formed 2, 4 and 8 times per element (the N tiles);
    the filter is resident at stage 2 and streamed at stages 3 and 4."""
    plans = [conv_bn.temporal_data_plan(*s, SMS) for s in TRAIN[1:]]
    assert [p.n_tiles for p in plans] == [2, 4, 8]
    assert [(p.strip, p.resident) for p in plans] == [
        (32, True), (32, False), (16, False)]
    assert [p.blocks for p in plans] == [124, 128, 128]
