"""The packed conv walk's planner (``m3f_torch.ops.packed_conv.packed_plan``)
and its walk, on the CPU: at the probe's full shapes (COUT 144 and 128),
``chip_smoke.py``'s off-tiling shapes and a COUT of 264 (two N passes over
140 units: the persistent grid's last wave partial), for bf16 y, fp32 y and
the chunked walk, at the planner's layout and at each layout it can be
asked for. The regions fit a block's shared memory, 1024-aligned where the
128-byte swizzle reads them; the boxes are ones the copy engine takes
(dimensions <= 256, inner extent a multiple of 16 bytes and <= 128 under
the swizzle, innermost coordinates on 16 bytes); every (image, position) is
owned by exactly one unit of one block.

A numpy run of the walk (per tile of 64 positions, per pass, per channel
box and dy: the x window at its 8-aligned start with zeros past CIN and
HWM, the three dx taps read out of it at their offsets, the x-edge mask a
multiply by 0 at the swizzle-free coordinates, fp32 products in tap order,
bf16 at the end) is held against ``packed_conv_reference`` and against the
JAX script's ``packed_conv`` / ``packed_conv_chunked`` in interpret mode at
the shapes of ``tests/test_torch_packed_conv.py``. Limits are that file's:
fp32 y within 1e-5 of (|W_cm| @ |P|) plus 1e-6, bf16 y one bf16 ulp of the
fp32 value on top.
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
    # two N passes; 140 units over 132 blocks
    "cout264": S(B=5, T=7, H=20, W=20, CIN=32, COUT=264, CHUNK=128),
    # filter_sweep's check shapes: three channel boxes a tap; COUT 200 (no
    # single pass fits)
    "cin136": S(B=1, T=3, H=9, W=7, CIN=136, COUT=40, CHUNK=128),
    "cout200": S(B=3, T=2, H=9, W=15, CIN=48, COUT=200, CHUNK=128),
}
# tests/test_torch_packed_conv.py's shapes
WALK_SHAPES = {
    "lane_tail": S(B=1, T=2, H=10, W=10, CIN=8, COUT=16, CHUNK=128),
    "no_tail": S(B=1, T=2, H=16, W=16, CIN=16, COUT=24, CHUNK=128),
}
LAYOUTS = [None] + list(pc.LAYOUTS)
FLOOR = 1e-6


def _layout_id(layout):
    return "planner" if layout is None else f"bn{layout}_streamed"


def _plan(shape, mode, layout):
    return pc.packed_plan(shape, mode, bn=layout)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_id)
@pytest.mark.parametrize("mode", pc.CONV_MODES)
@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_plan_invariants(name, mode, layout):
    shape = PLAN_SHAPES[name]
    plan = _plan(shape, mode, layout)
    if layout is None:
        assert plan.fits
    if not plan.fits:
        # a layout asked for that does not fit says so, by shared memory
        assert plan.smem > SMEM or plan.stages < 2
        return
    assert plan.smem <= SMEM
    assert plan.warpgroups == plan.bn // pc.TILE_P and plan.bn in (64, 128)
    # N passes: one width of the kernel's instantiations, covering COUT
    assert plan.np in pc.WIDTHS and plan.np % 8 == 0 and plan.np <= 256
    assert plan.np == min(w for w in pc.WIDTHS
                          if w >= -(-shape.COUT // len(plan.passes)))
    assert plan.passes[0][0] == 0 and sum(n for _, n in plan.passes) == shape.COUT
    assert all(0 < n <= plan.np and n0 == i * plan.np
               for i, (n0, n) in enumerate(plan.passes))
    assert len(plan.passes) >= -(-shape.COUT // pc.WIDTHS[-1])
    # K per tap: boxes of 64 channels, four k-steps of 16 each
    assert plan.k_pad == plan.kc * pc.BOX_C >= shape.CIN > plan.k_pad - pc.BOX_C
    assert sum(plan.k16) * 16 == plan.k_pad
    # regions: in order, disjoint, 1024-aligned where swizzled, in the block
    offs = list(plan.regions.values())
    assert offs[0][0] == 0
    assert all(a + n == b for (a, n), (b, _) in zip(offs, offs[1:]))
    assert offs[-1][0] + offs[-1][1] + 1024 == plan.smem
    for name_ in ("b", "y"):
        assert plan.regions[name_][0] % 1024 == 0 and plan.regions[name_][1] % 1024 == 0
    assert plan.regions["x"][0] % 128 == 0 and plan.regions["bars"][0] % 8 == 0
    assert plan.regions["b"][1] == plan.stages * 3 * plan.np * pc.ROW
    assert 2 <= plan.stages <= pc.MAX_STAGES
    y_size = 4 if mode == "packed_conv_f32" else 2
    assert plan.regions["y"][1] == plan.warpgroups * plan.np * pc.TILE_P * y_size
    assert plan.regions["x"][1] == plan.stages * plan.warpgroups * pc.BOX_C * pc.WROW * 2
    # one mbarrier phase counts a slot's bytes: its windows and W tiles
    assert plan.stage_tx == (plan.regions["x"][1] + plan.regions["b"][1]) // plan.stages
    assert 0 < plan.stage_tx <= TX_MAX
    # boxes the copy engine takes
    for kind, (box, swizzle) in plan.boxes.items():
        assert all(0 < d <= 256 for d in box)
        inner = box[0] * (y_size if kind == "y" else 2)
        assert inner % 16 == 0 and (swizzle == 0 or inner <= swizzle == 128)
    assert plan.boxes["x"][0] == (pc.WROW, pc.BOX_C, 1)
    assert plan.boxes["w"][0] == (pc.BOX_C, 1, plan.np)
    assert plan.boxes["y"][0] == (pc.TILE_P, plan.np, 1)
    assert plan.boxes["y"][1] == (0 if y_size == 4 else 128)
    # the persistent grid and the units
    chunked = mode == "packed_conv_chunked"
    assert plan.unit == ("chunk" if chunked else "tile")
    assert plan.tiles_per_unit == (shape.CHUNK // plan.bn if chunked else 1)
    assert plan.units == shape.BT * shape.HWP // (plan.tiles_per_unit * plan.bn)
    assert plan.grid == min(pc.SMS, plan.units)


# (shape, mode, layout) cases whose layout fits (the planner is a pure
# function of the shape, so every worker collects the same cases)
FITTING = [(name, mode, layout) for name in sorted(PLAN_SHAPES)
           for mode in pc.CONV_MODES for layout in LAYOUTS
           if _plan(PLAN_SHAPES[name], mode, layout).fits]


@pytest.mark.parametrize("name,mode,layout", FITTING,
                         ids=[f"{n}-{m}-{_layout_id(l)}" for n, m, l in FITTING])
def test_plan_owns_every_position_once(name, mode, layout):
    """Blocks take units round-robin; a unit's tiles lie in one image, in
    order (a chunk's are CHUNK consecutive positions); every (image,
    position) belongs to exactly one tile of one unit of one block, and
    every window start the walk asks of the copy engine is 8-aligned and
    covers the tile's three dx taps of its dy."""
    shape = PLAN_SHAPES[name]
    plan = _plan(shape, mode, layout)
    owners = np.zeros((shape.BT, shape.HWP), np.int64)
    blocks_of = np.zeros(plan.units, np.int64)
    firsts = []
    for block in range(plan.grid):
        for unit in plan.blocks_units(block):
            blocks_of[unit] += 1
            tiles = plan.unit_tiles(unit, shape)
            assert len(tiles) == plan.tiles_per_unit
            assert len({b for b, _ in tiles}) == 1
            starts = [p for _, p in tiles]
            assert starts == list(range(starts[0], starts[0] + plan.bn * len(tiles),
                                        plan.bn))
            if plan.unit == "chunk":
                assert starts[0] % shape.CHUNK == 0
            for b, p in tiles:
                owners[b, p:p + plan.bn] += 1
                firsts.append(p)
    assert (blocks_of == 1).all()
    assert (owners == 1).all()
    p64 = (np.asarray(firsts)[:, None] + np.arange(0, plan.bn, pc.TILE_P)).ravel()
    for dy in (-1, 0, 1):
        a = shape.MARGIN + p64 + dy * shape.W
        start = pc.window_start(shape, p64, dy)
        assert (start % pc.TMA_ALIGN == 0).all() and (start >= 0).all()
        assert (start <= a - 1).all() and (start + pc.WROW >= a + pc.TILE_P + 1).all()


def test_plan_numbers_at_the_probe_shape():
    """COUT 144: two warpgroups on 128 positions (two slots of two 64 x 88
    windows and three 144-row W tiles), or one on 64 with three slots (two
    with fp32 y); 12,800 or 25,600 tiles, or 2,560 chunks, over 132 blocks.
    COUT 152 takes one pass of 192 on 64 positions (none fits on 128).
    COUT 264 streams W in two passes of 144 over 140 units: the last wave
    holds 8 of 132 blocks."""
    shape = S()
    bf16 = pc.packed_plan(shape, "packed_conv")
    assert (bf16.bn, bf16.np, bf16.stages) == (128, 144, 2)
    assert bf16.regions["b"] == (0, 2 * 3 * 18_432)
    assert bf16.regions["y"][1] == 2 * 18_432 and bf16.regions["x"][1] == 4 * 11_264
    assert (bf16.units, bf16.grid) == (12_800, 132)
    one = pc.packed_plan(shape, "packed_conv", bn=64)
    assert (one.np, one.stages, one.regions["b"]) == (144, 3, (0, 3 * 3 * 18_432))
    assert one.smem == 3 * 3 * 18_432 + 18_432 + 3 * 11_264 + 48 + 1024
    assert (one.units, one.grid) == (25_600, 132)
    f32 = pc.packed_plan(shape, "packed_conv_f32", bn=64)
    assert (f32.stages, f32.regions["y"][1]) == (2, 36_864)
    chunked = pc.packed_plan(shape, "packed_conv_chunked")
    assert (chunked.units, chunked.tiles_per_unit) == (2_560, 5)
    odd = pc.packed_plan(PLAN_SHAPES["cin24_cout152"], "packed_conv")
    assert (odd.bn, odd.np, odd.passes) == (64, 192, ((0, 152),))
    wide = pc.packed_plan(PLAN_SHAPES["cout264"], "packed_conv")
    assert wide.passes == ((0, 144), (144, 120)) and wide.bn == 128
    assert wide.units == 140 and wide.grid == 132 and wide.units % wide.grid == 8
    # a pass of 256 fits no ring: COUT 200 takes two of 128
    two = pc.packed_plan(PLAN_SHAPES["cout200"], "packed_conv")
    assert two.fits and two.passes == ((0, 128), (128, 72))


def test_plan_refuses_what_no_layout_fits():
    assert not pc.packed_plan(S(CHUNK=96), "packed_conv_chunked").fits
    with pytest.raises(ValueError, match="mode"):
        pc.packed_plan(S(), "ablate_slabs")
    with pytest.raises(ValueError, match="no layout"):
        pc.packed_plan(S(), "packed_conv", bn=96)


# --- a numpy run of the walk -------------------------------------------------

def _bf16_exact(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _ulp_bf16(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _inputs(shape, seed=0):
    """x_cm with noise in the margins and the tail (read as given), w_cm /
    sqrt(K); values bf16 holds exactly."""
    rng = np.random.RandomState(seed)
    x = rng.randn(shape.B, shape.T, shape.H, shape.W, shape.CIN).astype(np.float32)
    w = (rng.randn(3, 3, shape.CIN, shape.COUT) / np.sqrt(shape.K)).astype(np.float32)
    x_cm = pc.pack_x(x, shape)
    live = np.zeros(shape.HWM, bool)
    live[shape.MARGIN:shape.MARGIN + shape.HW] = True
    x_cm[:, :, ~live] = rng.randn(*x_cm.shape).astype(np.float32)[:, :, ~live]
    return _bf16_exact(x_cm), _bf16_exact(np.ascontiguousarray(pc.pack_w(w)))


def run_walk(x_cm: np.ndarray, w_cm: np.ndarray, shape, plan, mask: bool = True):
    """The kernel's walk in numpy -> y [BT, COUT, HWP] fp32 (rounded to
    bf16 values unless the plan's y is fp32)."""
    y = np.full((shape.BT, shape.COUT, shape.HWP), np.nan, np.float32)
    for block in range(plan.grid):
        for unit in plan.blocks_units(block):
            for b, p in plan.unit_tiles(unit, shape):
                for p0 in range(p, p + plan.bn, pc.TILE_P):   # a warpgroup each
                    for n0, n in plan.passes:
                        acc = np.zeros((pc.TILE_P, plan.np), np.float32)
                        for kc in range(plan.kc):
                            c0 = kc * pc.BOX_C
                            for dy in (-1, 0, 1):
                                start = pc.window_start(shape, p0, dy)
                                # the window box: zeros past CIN and past HWM
                                win = np.zeros((pc.BOX_C, pc.WROW), np.float32)
                                rows = x_cm[b, c0:c0 + pc.BOX_C, start:start + pc.WROW]
                                win[:rows.shape[0], :rows.shape[1]] = rows
                                for dx in (-1, 0, 1):
                                    off = shape.MARGIN + p0 + dy * shape.W + dx - start
                                    a = win[:, off:off + pc.TILE_P].T.copy()   # [m, c]
                                    if mask and dx:
                                        edge = 0 if dx < 0 else shape.W - 1
                                        cols = (p0 + np.arange(pc.TILE_P)) % shape.W
                                        a[cols == edge] *= np.float32(0.0)
                                    tap = (dy + 1) * 3 + dx + 1
                                    bt = np.zeros((pc.BOX_C, plan.np), np.float32)
                                    wk = w_cm[n0:n0 + plan.np,
                                              tap * shape.CIN + c0:
                                              tap * shape.CIN + min(c0 + pc.BOX_C,
                                                                    shape.CIN)]
                                    bt[:wk.shape[1], :wk.shape[0]] = wk.T
                                    acc += a @ bt
                        y[b, n0:n0 + n, p0:p0 + pc.TILE_P] = acc[:, :n].T
    assert not np.isnan(y).any()
    if plan.mode != "packed_conv_f32":
        y = torch.from_numpy(y).to(torch.bfloat16).float().numpy()
    return y


def _limits(x_cm, w_cm, shape, y32):
    scale = torch.matmul(torch.from_numpy(w_cm).abs(),
                         pc.im2col(torch.from_numpy(x_cm), shape).abs())
    lim32 = 1e-5 * scale.numpy() + FLOOR
    return lim32, _ulp_bf16(y32) + lim32


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_id)
@pytest.mark.parametrize("mode", pc.CONV_MODES)
@pytest.mark.parametrize("name", sorted(WALK_SHAPES))
def test_walk_matches_reference(name, mode, layout):
    shape = WALK_SHAPES[name]
    plan = _plan(shape, mode, layout)
    assert plan.fits
    x_cm, w_cm = _inputs(shape)
    got = run_walk(x_cm, w_cm, shape, plan)
    y32 = pc.packed_conv_reference(torch.from_numpy(x_cm), torch.from_numpy(w_cm),
                                   shape, out_f32=True).numpy()
    lim32, lim16 = _limits(x_cm, w_cm, shape, y32)
    lim = lim32 if mode == "packed_conv_f32" else lim16
    assert (np.abs(got - y32) <= lim).all()


@pytest.mark.parametrize("name", sorted(WALK_SHAPES))
def test_walk_without_the_mask_is_refused(name):
    """The check has power: the walk without the x-edge mask (the window
    reads the neighbouring row's far edge) falls outside the limit."""
    shape = WALK_SHAPES[name]
    plan = pc.packed_plan(shape, "packed_conv_f32")
    x_cm, w_cm = _inputs(shape)
    got = run_walk(x_cm, w_cm, shape, plan, mask=False)
    y32 = pc.packed_conv_reference(torch.from_numpy(x_cm), torch.from_numpy(w_cm),
                                   shape, out_f32=True).numpy()
    lim32, _ = _limits(x_cm, w_cm, shape, y32)
    assert not (np.abs(got - y32) <= lim32).all()


def _load_script(monkeypatch, tmp_path, shape):
    """A fresh copy of the JAX script, its module globals set to ``shape``
    (its jitted functions read them when traced)."""
    monkeypatch.setenv("M3F_JAX_CACHE", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location("jax_probe_packed_conv_plan", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key in ("B", "T", "H", "W", "CIN", "COUT", "BT", "HW", "HWP", "HWM", "K",
                "CHUNK"):
        monkeypatch.setattr(mod, key, getattr(shape, key))
    assert mod.MARGIN == shape.MARGIN and mod.TAPS == pc.TAPS
    return mod


@pytest.mark.parametrize("mode", pc.CONV_MODES)
@pytest.mark.parametrize("name", sorted(WALK_SHAPES))
def test_walk_matches_pallas_kernels(monkeypatch, tmp_path, name, mode):
    """The walk at the planner's layout against the JAX script's Pallas
    kernel in interpret mode, over all HWP columns."""
    shape = WALK_SHAPES[name]
    mod = _load_script(monkeypatch, tmp_path, shape)
    x_cm, w_cm = _inputs(shape)
    xj, wj = jnp.asarray(x_cm, jnp.bfloat16), jnp.asarray(w_cm, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want32 = np.asarray(jnp.asarray(mod.packed_conv(xj, wj, out_f32=True),
                                        jnp.float32))
        if mode == "packed_conv_chunked":
            want = mod.packed_conv_chunked(xj, wj)
        else:
            want = mod.packed_conv(xj, wj, out_f32=mode == "packed_conv_f32")
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = run_walk(x_cm, w_cm, shape, pc.packed_plan(shape, mode))
    assert got.shape == want.shape == (shape.BT, shape.COUT, shape.HWP)
    lim32, lim16 = _limits(x_cm, w_cm, shape, want32)
    assert (np.abs(got - want) <= (lim32 if mode == "packed_conv_f32" else lim16)).all()
