"""The spatial data-gradient kernel's planner
(``m3f_torch.ops.conv_bn.spatial_data_plan``), on the CPU: at the four
spatial units of the full-width fusion train step and at the spatial edge
shapes ``chip_smoke.py`` holds the kernel at, for a card of 132 SMs. Every
output pixel falls in exactly one step of one block, a step's chunk
buffers hold every row the step reads (by walking the largest range as the
kernel does) and a thread's copies cover them, the tiles fit the kernel's
MMA shapes and warp layouts, shared memory stays within a block's 227 KB,
the partial rows are what the wrapper allocates, and what does not fit is
refused."""

import numpy as np
import pytest

from m3f_torch.ops import conv_bn

SMS = 132
# (B, T, H, W, C_in, C_out): x and dx are [B, T, H, W, C_in], gy [..., C_out]
TRAIN = [(32, 16, 56, 56, 64, 144), (32, 8, 28, 28, 128, 288),
         (32, 4, 14, 14, 256, 576), (32, 2, 7, 7, 512, 1152)]
# chip_smoke.py BWD_EDGE_SHAPES, spatial
EDGE = [(3, 5, 7, 9, 24, 40), (2, 3, 1, 11, 40, 24), (2, 2, 6, 1, 24, 16),
        (3, 4, 1, 1, 16, 8), (2, 3, 5, 7, 152, 40), (1, 1, 9, 13, 48, 40),
        (1, 2, 2, 3, 16, 24), (3, 200, 3, 5, 16, 8), (1, 2, 70, 11, 24, 40),
        (2, 3, 4, 3, 40, 296), (1, 2, 9, 11, 40, 288), (1, 2, 9, 9, 152, 704),
        (1, 2, 14, 14, 40, 512), (1, 2, 7, 7, 24, 1024),
        (2, 3, 1, 1, 24, 440), (1, 2, 3, 200, 24, 40)]
# step -> (WM, WN, MT, NT) of dispatch_spatial_data
WARPS = {256: (4, 2, 4, 4), 128: (4, 2, 2, 4)}
SMEM_MAX = 227 * 1024


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("shape", TRAIN + EDGE, ids=_ids(TRAIN + EDGE))
def test_spatial_data_plan(shape):
    b, t, h, w, ci, co = shape
    plan = conv_bn.spatial_data_plan(b, t, h, w, ci, co, SMS)
    assert plan.images == b * t
    # every image in exactly one range, no range empty, as the kernel cuts them
    assert plan.ranges == -(-plan.images // plan.images_per_range)
    covered = [i for r in range(plan.ranges) for i in plan.images_of(r)]
    assert covered == list(range(plan.images))
    assert all(len(plan.images_of(r)) > 0 for r in range(plan.ranges))
    # one block per range and N tile; the tiles cover C_in
    assert plan.n_tiles == -(-ci // plan.n_tile)
    assert plan.blocks == plan.ranges * plan.n_tiles
    # about one block a multiprocessor, unless every image is its own range
    assert plan.ranges == plan.images or plan.blocks <= SMS \
        or plan.n_tiles > SMS
    # the warp layout: 8 warps of MT m16 pixel tiles x NT n8 channel tiles;
    # a table entry and an x row per thread; k16 = one chunk of 16 channels
    assert plan.step in conv_bn._SD_STEPS and plan.n_tile == conv_bn._SD_N_TILE
    wm, wn, mt, nt = WARPS[plan.step]
    assert plan.warps == wm * wn == 8
    assert plan.step == 16 * mt * wm and plan.n_tile == 8 * nt * wn
    assert plan.step <= 32 * plan.warps and conv_bn._SD_K_CHUNK == 16
    # shared memory: what the kernel computes, within a block's 227 KB; a
    # thread's copies (two 8-channel vectors a pixel, 128 pixels a pass)
    # cover the step's rows; the choice is the first step that fits
    assert plan.buf_rows == conv_bn.spatial_ring_rows(h, w, plan.step, 1)
    assert plan.smem_bytes == conv_bn._spatial_data_smem(
        w, co, plan.step, plan.buf_rows)
    assert plan.smem_bytes <= SMEM_MAX
    assert plan.buf_rows * w <= 128 * conv_bn._SD_VMAX
    for step in conv_bn._SD_STEPS[:conv_bn._SD_STEPS.index(plan.step)]:
        rows = conv_bn.spatial_ring_rows(h, w, step, 1)
        assert conv_bn._spatial_data_smem(w, co, step, rows) > SMEM_MAX \
            or rows * w > 128 * conv_bn._SD_VMAX
    # the partial rows of dinv / dshift: one per range (the wrapper
    # allocates 2 * part_rows * C_in floats, the C entry reads
    # ceil(images / images_per_range) rows)
    assert plan.part_rows == plan.ranges


@pytest.mark.parametrize("shape", TRAIN + EDGE, ids=_ids(TRAIN + EDGE))
def test_every_output_pixel_in_one_step_of_one_block(shape):
    """The kernel's cut: block (range r, N tile) walks the pixels of its
    images from P0 = first image * H*W in steps of ``step``; only the
    range's last step is partly masked. Every pixel once per N tile."""
    b, t, h, w, ci, co = shape
    plan = conv_bn.spatial_data_plan(b, t, h, w, ci, co, SMS)
    hw = h * w
    seen = np.zeros(b * t * hw, dtype=np.int64)
    for r in range(plan.ranges):
        imgs = plan.images_of(r)
        p0, q = imgs.start * hw, len(imgs) * hw
        steps = -(-q // plan.step)
        for j in range(steps):
            npx = min(plan.step, q - j * plan.step)
            assert 0 < npx <= plan.step
            seen[p0 + j * plan.step:p0 + j * plan.step + npx] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", TRAIN + EDGE, ids=_ids(TRAIN + EDGE))
def test_a_step_s_buffers_hold_every_row_it_reads(shape):
    """The kernel's walk over the largest range: a step reads the stream
    rows from the one above its first pixel to the one below its last, zero
    rows between images included; its chunk buffers must hold them all."""
    b, t, h, w, ci, co = shape
    plan = conv_bn.spatial_data_plan(b, t, h, w, ci, co, SMS)
    q_all = len(plan.images_of(0)) * h * w
    row = lambda q: q // w + q // w // h + 1       # stream row of pixel q
    worst = max(row(min((j + 1) * plan.step, q_all) - 1) + 1
                - (row(j * plan.step) - 1) + 1
                for j in range(-(-q_all // plan.step)))
    assert worst <= plan.buf_rows
    # and, where the range is long enough to meet the worst alignment (the
    # train stages 1-2), not more than one row to spare
    if shape in TRAIN and q_all >= 8 * plan.step:
        assert plan.buf_rows - worst <= 1


@pytest.mark.parametrize("shape,step", [
    ((3, 5, 7, 9, 24, 40), 256), ((1, 2, 7, 7, 24, 1024), 256),
    ((2, 2, 6, 1, 24, 16), 256), ((1, 2, 3, 160, 24, 40), 256),
    ((3, 4, 1, 1, 16, 8), 128), ((2, 3, 1, 1, 24, 440), 128),
    ((1, 2, 3, 200, 24, 40), 128)], ids=str)
def test_spatial_data_plan_branches(shape, step):
    """Steps of 256 pixels (W = 1 and rows of 160 pixels still fit), and of
    128 where the rows a step of 256 reads outgrow shared memory (one-pixel
    images: 513 rows) or a thread's copies (rows of 200 pixels)."""
    assert conv_bn.spatial_data_plan(*shape, SMS).step == step


def test_spatial_data_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        conv_bn.spatial_data_plan(1, 1, 4, 4000, 64, 48, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        conv_bn.spatial_data_plan(1, 2, 4, 300, 24, 40, SMS)


def test_spatial_data_plan_train_stage_one():
    """Stage 1 (gy [32,16,56,56,144] → dx 64): steps of 256 pixels x all 64
    input channels (ge formed once per row), buffers of 9 rows, 9 chunks a
    step, 155 KB a block: 128 ranges of 4 images, 128 blocks on 132 SMs."""
    plan = conv_bn.spatial_data_plan(32, 16, 56, 56, 64, 144, SMS)
    assert (plan.step, plan.n_tile, plan.buf_rows, plan.n_tiles) == (256, 64, 9, 1)
    assert (plan.images, plan.images_per_range, plan.ranges) == (512, 4, 128)
    assert (plan.blocks, plan.part_rows) == (128, 128)
    assert plan.smem_bytes == 158496


def test_spatial_data_plan_train_wider_stages():
    """Stages 2-4: ge formed 2, 4 and 8 times per element (the N tiles),
    steps of 256 pixels over buffers of 14, 24 and 46 rows."""
    plans = [conv_bn.spatial_data_plan(*s, SMS) for s in TRAIN[1:]]
    assert [p.n_tiles for p in plans] == [2, 4, 8]
    assert [(p.step, p.buf_rows) for p in plans] == [(256, 14), (256, 24), (256, 46)]
    assert [p.blocks for p in plans] == [128, 128, 128]
