"""The ablation kernels' planner (``m3f_torch.ops.packed_conv.ablation_plan``)
and their walks, on the CPU: at the probe's full shapes (COUT 144 and 128)
and ``chip_smoke.py``'s shapes off the tiling, for row 11
(``ablate_matmul``: a resident P^T tile, W streamed, each W box feeding the
products of one or two images) at the planner's layout and at each layout
it can be asked for, and for row 10 (``ablate_slabs``: x windows formed
into every row of the P tile, the rows below COUT stored) at each ring
depth. The regions fit a block's shared memory, 1024-aligned where the
128-byte swizzle reads them; the boxes are ones the copy engine takes
(dimensions <= 256, inner extent a multiple of 16 bytes and <= 128 under
the swizzle, every box coordinate on 16 bytes); every (image, row < COUT,
position) of y is owned by exactly one work item of one block.

A numpy run of each walk, unit by unit in the planner's order, is held
against the plain version and against the JAX script's ``ablate_slabs`` /
``ablate_matmul`` in interpret mode at the shapes of
``tests/test_torch_packed_conv.py``: row 10 bit for bit (a copy and a
multiply by 0 or 1), row 11 within one bf16 ulp of the fp32 product plus
1e-5 of (|W_cm| @ |p_const|) and a 1e-6 floor (that file's limits). Two
negative controls must fail: row 10's walk without the x-edge mask, and row
11's walk that leaves out the last image. ``_aligned`` is tested on the CPU.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from m3f_torch.ops import packed_conv as pc

SMEM = 232_448            # shared memory a block can use on an H100
TX_MAX = (1 << 20) - 1    # transaction bytes one mbarrier phase can count
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "probe_packed_conv.py"
S = pc.ProbeShape
PLAN_SHAPES = {
    "full_cout144": S(),
    "full_cout128": S(COUT=128),
    # chip_smoke.py's shapes off the tiling
    "cin16_cout24": S(B=2, T=3, H=20, W=20, CIN=16, COUT=24, CHUNK=128),
    "cin24_cout152": S(B=1, T=2, H=12, W=12, CIN=24, COUT=152, CHUNK=256),
    "cout264": S(B=5, T=7, H=20, W=20, CIN=32, COUT=264, CHUNK=128),
}
# tests/test_torch_packed_conv.py's shapes, and an odd BT (a last group of
# one image) with W 7 (two x edges in some 8-position words)
WALK_SHAPES = {
    "lane_tail": S(B=1, T=2, H=10, W=10, CIN=8, COUT=16, CHUNK=128),
    "no_tail": S(B=1, T=2, H=16, W=16, CIN=16, COUT=24, CHUNK=128),
    "odd_bt_w7": S(B=1, T=3, H=9, W=7, CIN=8, COUT=40, CHUNK=128),
}
FLOOR = 1e-6
# (name, layout) the planner can be asked for: row 11 the images of a work
# item, row 10 the ring depth or one window a dy ("w3"); None is the
# planner's
LAYOUTS = ([("ablate_matmul", None)] + [("ablate_matmul", l) for l in pc.MATMUL_LAYOUTS]
           + [("ablate_slabs", None), ("ablate_slabs", "w3")]
           + [("ablate_slabs", st) for st in (2, 5, pc.ABL_MAX_STAGES)])


def _layout_id(layout, name=None):
    if layout is None:
        return "planner"
    if isinstance(layout, str):
        return layout
    return f"imgs{layout}" if name == "ablate_matmul" else f"stages{layout}"


def _plan(shape, name, layout):
    if layout is None:
        return pc.ablation_plan(shape, name)
    if name == "ablate_matmul":
        return pc.ablation_plan(shape, name, imgs=layout)
    if layout == "w3":
        return pc.ablation_plan(shape, name, windows=3)
    return pc.ablation_plan(shape, name, stages=layout)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rows(plan, shape):
    """(first row, rows) of y each pass (row 11) or y box (row 10) writes."""
    if plan.name == "ablate_matmul":
        return list(plan.passes)
    rows = plan.boxes["y"][0][1]
    return [(r, min(rows, shape.COUT - r)) for r in range(0, shape.COUT, rows)]


@pytest.mark.parametrize("name,layout", LAYOUTS,
                         ids=[f"{n}-{_layout_id(l, n)}" for n, l in LAYOUTS])
@pytest.mark.parametrize("shape_name", sorted(PLAN_SHAPES))
def test_plan_invariants(shape_name, name, layout):
    shape = PLAN_SHAPES[shape_name]
    plan = _plan(shape, name, layout)
    if layout is None:
        assert plan.fits
    if not plan.fits:
        # a layout asked for that does not fit says so, by shared memory or
        # by the accumulators a thread would hold
        assert plan.smem > SMEM \
            or plan.imgs // pc.MATMUL_WGS * plan.np > pc.ACC_MAX
        return
    assert plan.name == name and plan.smem <= SMEM
    assert 2 <= plan.stages <= pc.ABL_MAX_STAGES
    # regions: in order, disjoint, in the block
    offs = list(plan.regions.values())
    assert offs[0][0] == 0
    assert all(a + n == b for (a, n), (b, _) in zip(offs, offs[1:]))
    assert offs[-1][0] + offs[-1][1] + 1024 == plan.smem
    assert 0 < plan.stage_tx <= TX_MAX
    # boxes the copy engine takes
    for box, swizzle in plan.boxes.values():
        assert all(0 < d <= 256 for d in box)
        assert box[0] * 2 % 16 == 0 and (swizzle == 0 or box[0] * 2 <= swizzle == 128)
    # the grid: contiguous ranges of items, none empty, at most one a SM
    assert plan.grid <= pc.SMS and plan.per * plan.grid >= plan.items
    assert (plan.grid - 1) * plan.per < plan.items
    if name == "ablate_matmul":
        wgs = pc.MATMUL_WGS
        per_wg = plan.imgs // wgs           # images of one warpgroup
        assert plan.imgs in pc.MATMUL_LAYOUTS and plan.bn == pc.TILE_P
        assert plan.resident == "p_const" and plan.imgs % wgs == 0 and plan.windows == 0
        assert plan.np in pc.WIDTHS and per_wg * plan.np <= pc.ACC_MAX
        assert plan.yt in (1, per_wg)
        assert plan.np == min(w for w in pc.WIDTHS
                              if w >= -(-shape.COUT // len(plan.passes)))
        assert plan.kb * pc.BOX_C >= shape.K > (plan.kb - 1) * pc.BOX_C
        for region in ("p", "w", "y"):   # read under the 128-byte swizzle
            assert plan.regions[region][0] % 1024 == 0
            assert plan.regions[region][1] % 1024 == 0
        assert plan.regions["p"][1] == plan.kb * pc.P_BOX < TX_MAX
        assert plan.regions["w"][1] == plan.stages * plan.stage_tx
        assert plan.stage_tx == plan.np * pc.ROW
        assert plan.regions["y"][1] == wgs * plan.yt * plan.np * pc.TILE_P * 2
        assert plan.regions["bars"][1] == (2 * plan.stages + 2) * 8
        assert plan.boxes == {"p": ((64, 64, 1), 128), "w": ((64, plan.np, 1), 128),
                              "y": ((64, plan.np, 1), 128)}
        assert plan.groups == -(-shape.BT // plan.imgs)
        assert plan.threads == wgs * 128 + 32
    else:
        assert plan.bn == pc.SLAB_BN and plan.resident == "none" and plan.imgs == 1
        assert plan.yt == 0
        assert plan.box_c == min(pc.BOX_C, shape.CIN) and plan.box_c % 8 == 0
        assert plan.kb * plan.box_c >= shape.CIN
        y_rows = plan.boxes["y"][0][1]
        assert y_rows % 8 == 0 and y_rows * len(_rows(plan, shape)) >= shape.COUT
        assert plan.regions["y"][1] == len(_rows(plan, shape)) * y_rows * pc.SLAB_BN * 2
        assert plan.regions["scratch"][1] == pc.BOX_C * pc.SLAB_BN * 2
        wrow = plan.boxes["x"][0][0]
        assert (plan.windows, wrow) == ((3, pc.SLAB_ROW) if layout == "w3"
                                        else pc.slab_window(shape))
        assert wrow % 8 == 0 and wrow <= 256
        assert plan.stage_tx == plan.box_c * wrow * 2
        assert plan.regions["x"][1] == plan.stages * plan.stage_tx
        assert all(plan.regions[r][0] % 128 == 0 for r in ("y", "scratch", "x"))
        assert plan.boxes == {"x": ((wrow, plan.box_c, 1), 0),
                              "y": ((pc.SLAB_BN, y_rows, 1), 0)}
        assert plan.groups == plan.tiles and plan.threads == pc.SLAB_FORMERS + 32
    assert plan.tiles == shape.HWP // plan.bn
    assert plan.items == plan.tiles * (plan.groups if name == "ablate_matmul"
                                       else shape.BT)


FITTING = [(s, n, l) for s in sorted(PLAN_SHAPES) for n, l in LAYOUTS
           if _plan(PLAN_SHAPES[s], n, l).fits]


@pytest.mark.parametrize("shape_name,name,layout", FITTING,
                         ids=[f"{s}-{n}-{_layout_id(l, n)}" for s, n, l in FITTING])
def test_plan_owns_every_output_once(shape_name, name, layout):
    """Blocks take contiguous ranges of work items; an item's tiles lie at
    one position tile; every (image, position) belongs to exactly one item
    of one block, and the passes (row 11) or y boxes (row 10) cover the
    rows below COUT once, so every (image, row < COUT, position) is owned
    once. Every box coordinate the walk gives the copy engine is on 16
    bytes: P^T boxes and y stores at multiples of 64 positions, W boxes at
    multiples of 64 k, row 10's windows 8-aligned, holding the three dx
    taps of their dy and the funnel's words past them."""
    shape = PLAN_SHAPES[shape_name]
    plan = _plan(shape, name, layout)
    owners = np.zeros((shape.BT, shape.HWP), np.int16)
    blocks_of = np.zeros(plan.items, np.int64)
    firsts = set()
    for block in range(plan.grid):
        items = plan.blocks_items(block)
        assert len(items) > 0
        for item in items:
            blocks_of[item] += 1
            tiles = plan.item_tiles(item, shape)
            assert len({p for _, p in tiles}) == 1
            assert 1 <= len(tiles) <= plan.imgs
            for b, p in tiles:
                owners[b, p:p + plan.bn] += 1
                firsts.add(p)
    assert (blocks_of == 1).all() and (owners == 1).all()
    rows = np.zeros(shape.COUT, np.int64)
    for r0, n in _rows(plan, shape):
        rows[r0:r0 + n] += 1
    assert (rows == 1).all()
    firsts = np.asarray(sorted(firsts))
    assert (firsts % 64 == 0).all()
    if name == "ablate_matmul":
        assert all(kb * pc.BOX_C * 2 % 16 == 0 for kb in range(plan.kb))
    else:
        wrow = plan.boxes["x"][0][0]
        for dy in (-1, 0, 1):
            a = shape.MARGIN + firsts + dy * shape.W
            start = pc.slab_window_start(shape, firsts, dy, plan.windows)
            assert (start % pc.TMA_ALIGN == 0).all() and (start >= 0).all()
            assert (start <= a - 1).all()
            # the funnel reads 16-byte words q + i and q + i + 1 (and at an
            # offset of 7 in the word, q + i + 2), q = (a - 1 - start) // 8
            q = (a - 1 - start) // 8
            assert (start + 8 * (q + 18) <= start + wrow).all()


def test_plan_numbers_at_the_probe_shape():
    """Row 11 at COUT 144: four images of N 144 exceed two warpgroups'
    accumulators, so two warpgroups on a 64-position tile, one image each,
    the P^T tile resident (9 boxes of 64 k, 72 KB) and a W ring of six
    slots; 12,800 items over 132 blocks of 97. COUT 128: two images a
    warpgroup, each in its own staging tile, five slots, 6,400 items over
    131 blocks of 49. Row 10: 12,800 tiles over 132 blocks, one window of
    256 positions x 64 channels a tile for all three dy in a ring of five,
    COUT 144 rows staged in one box."""
    mm = pc.ablation_plan(S(), "ablate_matmul")
    assert (mm.bn, mm.imgs, mm.yt) == (64, 2, 1)
    assert (mm.np, mm.stages, mm.kb, mm.threads) == (144, 6, 9, 288)
    assert mm.regions["p"] == (0, 73_728) and mm.smem == 222_320
    assert (mm.items, mm.per, mm.grid) == (12_800, 97, 132)
    # asked for four images, it takes two passes of N 128
    assert pc.ablation_plan(S(), "ablate_matmul", imgs=4).passes == \
        ((0, 128), (128, 16))
    four = pc.ablation_plan(S(COUT=128), "ablate_matmul")
    assert (four.imgs, four.yt, four.stages, four.smem) == (4, 2, 5, 222_304)
    assert (four.items, four.per, four.grid) == (6_400, 49, 131)
    sl = pc.ablation_plan(S(), "ablate_slabs")
    assert (sl.windows, sl.stages, sl.box_c, sl.kb) == (1, 5, 64, 1)
    assert (sl.items, sl.grid, sl.smem) == (12_800, 132, 218_192)
    assert sl.boxes == {"x": ((256, 64, 1), 0), "y": ((128, 144, 1), 0)}
    three = pc.ablation_plan(S(), "ablate_slabs", windows=3)
    assert three.boxes["x"][0] == (144, 64, 1) and three.stages == 8
    # W 100: 2W + 137 positions fit no box of 256
    assert pc.slab_window(S(H=30, W=100, MARGIN=128)) == (3, 144)
    # COUT 264: row 11 in two passes of 144; row 10 in two y boxes of 136
    wide = PLAN_SHAPES["cout264"]
    assert pc.ablation_plan(wide, "ablate_matmul").passes == ((0, 144), (144, 120))
    assert pc.ablation_plan(wide, "ablate_slabs").boxes["y"][0] == (128, 136, 1)


def test_plan_refuses_what_no_layout_fits():
    with pytest.raises(ValueError, match="name"):
        pc.ablation_plan(S(), "packed_conv")
    with pytest.raises(ValueError, match="no layout"):
        pc.ablation_plan(S(), "ablate_matmul", imgs=3)
    # K = 9 * 256: no P^T tile of 64 positions fits beside a W ring
    assert not pc.ablation_plan(S(CIN=256), "ablate_matmul").fits
    # two images of N 192 hold more accumulators than a thread can: two
    # passes of 128
    two = pc.ablation_plan(S(COUT=192), "ablate_matmul", imgs=4)
    assert two.fits and two.passes == ((0, 128), (128, 64))
    assert pc.ablation_plan(S(COUT=192), "ablate_matmul",
                            imgs=2).passes == ((0, 192),)
    assert not pc.ablation_plan(S(B=1, T=1, CIN=8, COUT=80), "ablate_slabs").fits
    # the conv's planner still refuses the ablations
    with pytest.raises(ValueError, match="mode"):
        pc.packed_plan(S(), "ablate_matmul")


def test_aligned_copies_only_what_is_off_16_bytes():
    x = torch.randn(3, 5, 16).to(torch.bfloat16)
    assert x.data_ptr() % 16 == 0 and pc._aligned(x) is x
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(x.shape)
    odd.copy_(x)
    assert odd.data_ptr() % 16 == 2 and odd.is_contiguous()
    got = pc._aligned(odd)
    assert got is not odd and got.data_ptr() % 16 == 0
    assert got.is_contiguous() and got.dtype == odd.dtype and got.device == odd.device
    assert torch.equal(got.view(torch.int16), odd.view(torch.int16))


# --- numpy runs of the walks ------------------------------------------------

def _bf16_exact(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _to_bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()


def _ulp_bf16(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _inputs(shape, seed=0):
    """x_cm with noise in the margins and the tail (read as given), w_cm /
    sqrt(K), p_const; values bf16 holds exactly, x with signed zeros."""
    rng = np.random.RandomState(seed)
    x = rng.randn(shape.B, shape.T, shape.H, shape.W, shape.CIN).astype(np.float32)
    w = (rng.randn(3, 3, shape.CIN, shape.COUT) / np.sqrt(shape.K)).astype(np.float32)
    x_cm = pc.pack_x(x, shape)
    live = np.zeros(shape.HWM, bool)
    live[shape.MARGIN:shape.MARGIN + shape.HW] = True
    x_cm[:, :, ~live] = rng.randn(*x_cm.shape).astype(np.float32)[:, :, ~live]
    p_const = rng.randn(shape.K, shape.HWP).astype(np.float32)
    return (_bf16_exact(x_cm), _bf16_exact(np.ascontiguousarray(pc.pack_w(w))),
            _bf16_exact(p_const))


def run_matmul_walk(p_const, w_cm, shape, plan, skip_last_image=False):
    """Row 11's walk in numpy -> y [BT, COUT, HWP] (bf16 values): per
    block, its items in order; the P^T tile loaded (64-k boxes, zeros past
    K) where the tile changes; per pass and 64-k box of W (zeros past K and
    COUT), fp32 products into each image's accumulators; bf16 at the end."""
    y = np.zeros((shape.BT, shape.COUT, shape.HWP), np.float32)
    kp = plan.kb * pc.BOX_C
    for block in range(plan.grid):
        held, pt = None, None
        for item in plan.blocks_items(block):
            tiles = plan.item_tiles(item, shape)
            p0 = tiles[0][1]
            if p0 != held:
                pt = np.zeros((plan.bn, kp), np.float32)        # P^T [m, k]
                pt[:, :shape.K] = p_const[:, p0:p0 + plan.bn].T
                held = p0
            for n0, n in plan.passes:
                acc = np.zeros((len(tiles), plan.bn, plan.np), np.float32)
                for kb in range(plan.kb):
                    wt = np.zeros((pc.BOX_C, plan.np), np.float32)   # W^T box
                    box = w_cm[n0:n0 + plan.np, kb * pc.BOX_C:(kb + 1) * pc.BOX_C]
                    wt[:box.shape[1], :box.shape[0]] = box.T
                    for m in range(len(tiles)):
                        acc[m] += pt[:, kb * pc.BOX_C:(kb + 1) * pc.BOX_C] @ wt
                for m, (b, _) in enumerate(tiles):
                    if skip_last_image and b == shape.BT - 1:
                        continue
                    y[b, n0:n0 + n, p0:p0 + plan.bn] = acc[m][:, :n].T
    return _to_bf16(y)


def run_slab_walk(x_cm, shape, plan, mask=True):
    """Row 10's walk in numpy -> y [BT, COUT, HWP]: per block, its tiles in
    order; per channel box, the x window(s) at their 8-aligned start
    (``slab_window_start``; the box's positions, zeros past CIN and HWM),
    per dy (+1, 0, -1) the three dx taps read out at their offsets, the
    x-edge columns multiplied by 0, every row of the P tile formed, rows <
    COUT into the staging tile, the rest into the scratch tile; the
    staging tile stored."""
    y = np.full((shape.BT, shape.COUT, shape.HWP), np.nan, np.float32)
    wrow = plan.boxes["x"][0][0]
    for block in range(plan.grid):
        for item in plan.blocks_items(block):
            (b, p0), = plan.item_tiles(item, shape)
            staging = np.full((shape.COUT, plan.bn), np.nan, np.float32)
            scratch = np.zeros((pc.BOX_C, plan.bn), np.float32)
            cols = (p0 + np.arange(plan.bn)) % shape.W
            for kc in range(plan.kb):
                c0 = kc * plan.box_c
                for dy in (1, 0, -1):
                    start = pc.slab_window_start(shape, p0, dy, plan.windows)
                    win = np.zeros((plan.box_c, wrow), np.float32)
                    rows = x_cm[b, c0:c0 + plan.box_c, start:start + wrow]
                    win[:rows.shape[0], :rows.shape[1]] = rows
                    for dx in (-1, 0, 1):
                        off = shape.MARGIN + p0 + dy * shape.W + dx - start
                        slab = win[:, off:off + plan.bn].copy()
                        if mask and dx:
                            edge = 0 if dx < 0 else shape.W - 1
                            slab[:, cols == edge] *= np.float32(0.0)
                        tap = (dy + 1) * 3 + dx + 1
                        for c in range(min(plan.box_c, shape.CIN - c0)):
                            k = tap * shape.CIN + c0 + c
                            if k < shape.COUT:
                                staging[k] = slab[c]
                            else:
                                scratch[k % pc.BOX_C] = slab[c]
            y[b, :, p0:p0 + plan.bn] = staging
    assert not np.isnan(y).any()
    return y


def _mm_limit(p_const, w_cm, y32):
    return _ulp_bf16(y32) + 1e-5 * (np.abs(w_cm) @ np.abs(p_const)) + FLOOR


def _bits(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16) \
        .view(torch.int16).numpy()


WALK_LAYOUTS = [(s, l) for s in sorted(WALK_SHAPES)
                for l in [None] + list(pc.MATMUL_LAYOUTS)
                if _plan(WALK_SHAPES[s], "ablate_matmul", l).fits]


@pytest.mark.parametrize("shape_name,layout", WALK_LAYOUTS,
                         ids=[f"{s}-{_layout_id(l, 'ablate_matmul')}" for s, l in WALK_LAYOUTS])
def test_matmul_walk_matches_reference(shape_name, layout):
    shape = WALK_SHAPES[shape_name]
    _, w_cm, p_const = _inputs(shape)
    got = run_matmul_walk(p_const, w_cm, shape, _plan(shape, "ablate_matmul", layout))
    want = pc.ablate_matmul_reference(torch.from_numpy(p_const), torch.from_numpy(w_cm),
                                      shape).float().numpy()
    y32 = w_cm @ p_const
    assert (np.abs(got - want) <= _mm_limit(p_const, w_cm, y32)).all()
    assert (np.abs(got - y32) <= _mm_limit(p_const, w_cm, y32)).all()


@pytest.mark.parametrize("shape_name", sorted(WALK_SHAPES))
def test_matmul_walk_without_the_last_image_is_refused(shape_name):
    """The check has power: a walk that leaves the last image's y
    unwritten falls outside the limit."""
    shape = WALK_SHAPES[shape_name]
    _, w_cm, p_const = _inputs(shape)
    got = run_matmul_walk(p_const, w_cm, shape,
                          pc.ablation_plan(shape, "ablate_matmul"), skip_last_image=True)
    y32 = w_cm @ p_const
    assert not (np.abs(got - y32) <= _mm_limit(p_const, w_cm, y32)).all()


@pytest.mark.parametrize("windows", [None, 3], ids=["planner", "w3"])
@pytest.mark.parametrize("shape_name", sorted(WALK_SHAPES))
def test_slab_walk_matches_reference_bit_for_bit(shape_name, windows):
    shape = WALK_SHAPES[shape_name]
    x_cm, w_cm, _ = _inputs(shape)
    x_cm[:, :, ::5] *= -0.0        # signed zeros, kept by the mask's x * 1
    plan = pc.ablation_plan(shape, "ablate_slabs", windows=windows)
    assert plan.windows == (windows or 1)
    got = run_slab_walk(x_cm, shape, plan)
    want = pc.ablate_slabs_reference(torch.from_numpy(x_cm).to(torch.bfloat16),
                                     torch.from_numpy(w_cm), shape)
    assert np.array_equal(_bits(got), want.view(torch.int16).numpy())


@pytest.mark.parametrize("shape_name", sorted(WALK_SHAPES))
def test_slab_walk_without_the_mask_is_refused(shape_name):
    """The check has power: the walk without the x-edge mask (the window
    reads the neighbouring row's far edge) is not the plain version's y."""
    shape = WALK_SHAPES[shape_name]
    x_cm, w_cm, _ = _inputs(shape)
    got = run_slab_walk(x_cm, shape, pc.ablation_plan(shape, "ablate_slabs"), mask=False)
    want = pc.ablate_slabs_reference(torch.from_numpy(x_cm).to(torch.bfloat16),
                                     torch.from_numpy(w_cm), shape)
    assert not np.array_equal(_bits(got), want.view(torch.int16).numpy())


def _load_script(monkeypatch, tmp_path, shape):
    """A fresh copy of the JAX script, its module globals set to ``shape``
    (its jitted functions read them when traced)."""
    monkeypatch.setenv("M3F_JAX_CACHE", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location("jax_probe_packed_ablate", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key in ("B", "T", "H", "W", "CIN", "COUT", "BT", "HW", "HWP", "HWM", "K",
                "CHUNK"):
        monkeypatch.setattr(mod, key, getattr(shape, key))
    assert mod.MARGIN == shape.MARGIN and mod.TAPS == pc.TAPS
    return mod


@pytest.mark.parametrize("name", pc.ABLATIONS)
@pytest.mark.parametrize("shape_name", ["lane_tail", "no_tail"])
def test_walks_match_pallas_kernels(monkeypatch, tmp_path, shape_name, name):
    """Each walk at the planner's layout against the JAX script's Pallas
    kernel in interpret mode, over all HWP columns."""
    shape = WALK_SHAPES[shape_name]
    mod = _load_script(monkeypatch, tmp_path, shape)
    x_cm, w_cm, p_const = _inputs(shape)
    wj = jnp.asarray(w_cm, jnp.bfloat16)
    plan = pc.ablation_plan(shape, name)
    with pltpu.force_tpu_interpret_mode():
        if name == "ablate_slabs":
            want = mod.ablate_slabs(jnp.asarray(x_cm, jnp.bfloat16), wj)
        else:
            want = mod.ablate_matmul(jnp.asarray(p_const, jnp.bfloat16), wj)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert want.shape == (shape.BT, shape.COUT, shape.HWP)
    if name == "ablate_slabs":
        got = run_slab_walk(x_cm, shape, plan)
        assert np.array_equal(_bits(got), _bits(want))
    else:
        got = run_matmul_walk(p_const, w_cm, shape, plan)
        assert (np.abs(got - want) <= _mm_limit(p_const, w_cm, w_cm @ p_const)).all()
