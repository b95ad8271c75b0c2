"""The temporal filter-gradient kernel's planner
(``m3f_torch.ops.conv_bn.temporal_filter_plan``), on the CPU: at the four
temporal units of the full-width fusion train step and at the edge shapes
``chip_smoke.py`` holds the kernel at, for a card of 132 SMs. Every (clip,
strip) unit falls in exactly one slice, the fp32 partials fit their 64 MB
budget, the tiles fit the kernel's MMA shapes, and the blocks fill about
four waves of the card unless every unit is already its own slice or the
partial budget binds."""

import pytest

from m3f_torch.ops import conv_bn

SMS = 132
TRAIN = [(32, 16, 56, 56, 144, 64), (32, 8, 28, 28, 288, 128),
         (32, 4, 14, 14, 576, 256), (32, 2, 7, 7, 1152, 512)]
EDGE = [(2, 7, 5, 3, 40, 24), (3, 1, 6, 5, 24, 16), (2, 2, 9, 9, 48, 40),
        (4, 3, 5, 7, 64, 24), (2, 4, 6, 6, 40, 24), (2, 3, 10, 10, 152, 40),
        (1, 2, 4, 5, 16, 8), (1, 3, 9, 8, 8, 96), (3, 1, 6, 5, 160, 104),
        (2, 3, 7, 5, 296, 144), (2, 4, 5, 5, 40, 160), (2, 2, 3, 3, 24, 344)]


@pytest.mark.parametrize("shape", TRAIN + EDGE,
                         ids=["x".join(map(str, s)) for s in TRAIN + EDGE])
def test_temporal_filter_plan(shape):
    b, t, h, w, ci, co = shape
    plan = conv_bn.temporal_filter_plan(b, t, h, w, ci, co, SMS)
    assert plan.units == b * -(-h * w // plan.strip)
    # every unit in exactly one slice, no slice empty, as the kernel cuts them
    assert plan.units_per_slice == -(-plan.units // plan.slices)
    covered = [u for s in range(plan.slices) for u in plan.units_of(s)]
    assert covered == list(range(plan.units))
    assert all(len(plan.units_of(s)) > 0 for s in range(plan.slices))
    # the partials
    out_bytes = 4 * 3 * ci * co
    assert plan.part_bytes == (plan.slices * out_bytes if plan.slices > 1 else 0)
    assert plan.part_bytes <= conv_bn._FILTER_PART_BYTES
    # the tiles: m16 channel tiles, n8 output-channel tiles, k16 pixel steps
    assert plan.ci_blk in (48, 64) and plan.ci_blk % 16 == 0
    assert plan.co_tile % 8 == 0 and plan.strip % 16 == 0
    # the channel block pads C_in least (48 of 144, 288; 64 of 576, 1152)
    assert -(-ci // plan.ci_blk) * plan.ci_blk == min(-(-ci // c) * c for c in (48, 64))
    # ~4 waves: cutting ceil(units / s) units per slice leaves more than
    # (per - 1) / per of the asked-for blocks
    tiles = -(-ci // plan.ci_blk) * -(-co // plan.co_tile)
    per = plan.units_per_slice
    assert (plan.slices == plan.units
            or (plan.slices + 1) * out_bytes > conv_bn._FILTER_PART_BYTES
            or tiles * plan.slices * per >= 4 * SMS * (per - 1))


def test_temporal_filter_plan_train_stage_one():
    """Stage 1 (x [32,16,56,56,144] → 64): three channel blocks of 48, 175
    slices of 9 units, 525 blocks (~4 waves of 132), 19 MB of partials."""
    plan = conv_bn.temporal_filter_plan(32, 16, 56, 56, 144, 64, SMS)
    assert (plan.strip, plan.ci_blk, plan.co_tile) == (64, 48, 64)
    assert (plan.units, plan.units_per_slice, plan.slices) == (1568, 9, 175)
    assert plan.part_bytes == 175 * 4 * 432 * 64
