"""The port's packed-layout conv probe (m3f_torch/ops/packed_conv.py,
m3f_torch/scripts/probe_packed_conv.py) against the JAX script
``scripts/probe_packed_conv.py``: its four Pallas kernels run under
``pltpu.force_tpu_interpret_mode()`` at two small shapes (one with a lane
tail, HW < HWP, one without), its module globals set to the shape. Inputs
are numpy from a seed, the margins and the tail filled with noise (both
versions read them as given); every HWP column is compared.

Tolerances: ``ablate_slabs`` bit for bit (a copy and a multiply by 0 or 1);
fp32 y per element 1e-5 of (|W_cm| @ |P|) plus a 1e-6 floor (fp32 summation
order over K); bf16 outputs one bf16 ulp of the fp32 value plus the floor.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from m3f_torch.ops import cuda_lib, packed_conv as pc
from m3f_torch.scripts import probe_packed_conv as probe

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "probe_packed_conv.py"
SHAPES = {
    "lane_tail": pc.ProbeShape(B=1, T=2, H=10, W=10, CIN=8, COUT=16, CHUNK=128),
    "no_tail": pc.ProbeShape(B=1, T=2, H=16, W=16, CIN=16, COUT=24, CHUNK=128),
}
FLOOR = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _load_script(monkeypatch, tmp_path, shape: pc.ProbeShape):
    """A fresh copy of the JAX script (its jitted functions read the module
    globals when traced), its globals set to ``shape``."""
    monkeypatch.setenv("M3F_JAX_CACHE", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location("jax_probe_packed_conv", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("B", "T", "H", "W", "CIN", "COUT", "BT", "HW", "HWP", "HWM",
                 "K", "CHUNK"):
        monkeypatch.setattr(mod, name, getattr(shape, name))
    assert mod.MARGIN == shape.MARGIN and mod.TAPS == pc.TAPS
    return mod


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """fp32 values that bf16 holds exactly (so both frameworks cast alike)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(shape: pc.ProbeShape, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.randn(shape.B, shape.T, shape.H, shape.W, shape.CIN).astype(np.float32)
    w = (rng.randn(3, 3, shape.CIN, shape.COUT) / np.sqrt(shape.K)).astype(np.float32)
    x_cm = pc.pack_x(x, shape)
    noise = rng.randn(*x_cm.shape).astype(np.float32)
    live = np.zeros(x_cm.shape[-1], bool)
    live[shape.MARGIN:shape.MARGIN + shape.HW] = True
    x_cm[:, :, ~live] = noise[:, :, ~live]          # margins and tail as given
    p_const = rng.randn(shape.K, shape.HWP).astype(np.float32)
    return (_bf16_exact(x_cm), _bf16_exact(np.ascontiguousarray(pc.pack_w(w))),
            _bf16_exact(p_const))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _j(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16)


def _np(y) -> np.ndarray:
    return np.asarray(jnp.asarray(y, jnp.float32))


def _ulp_bf16(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _fp32_limit(x_cm, w_cm, shape):
    scale = torch.matmul(_t(w_cm).float().abs(), pc.im2col(_t(x_cm), shape).float().abs())
    return 1e-5 * scale.numpy() + FLOOR


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_conv_matches_pallas_kernels(monkeypatch, tmp_path, case):
    """packed_conv (fp32 and bf16 y) and packed_conv_chunked vs the JAX
    script's kernels in interpret mode, over all HWP columns."""
    shape = SHAPES[case]
    mod = _load_script(monkeypatch, tmp_path, shape)
    x_cm, w_cm, _ = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        want32 = _np(mod.packed_conv(_j(x_cm), _j(w_cm), out_f32=True))
        want16 = _np(mod.packed_conv(_j(x_cm), _j(w_cm)))
        want_chunked = _np(mod.packed_conv_chunked(_j(x_cm), _j(w_cm)))
    got32 = pc.packed_conv(_t(x_cm), _t(w_cm), shape, out_f32=True)
    assert got32.dtype == torch.float32
    assert want32.shape == tuple(got32.shape) == (shape.BT, shape.COUT, shape.HWP)
    lim32 = _fp32_limit(x_cm, w_cm, shape)
    assert (np.abs(got32.numpy() - want32) <= lim32).all()
    if shape.HWP > shape.HW:                         # the tail is real output
        assert np.abs(want32[:, :, shape.HW:]).max() > 0.1
    lim16 = _ulp_bf16(want32) + FLOOR
    for got, want in ((pc.packed_conv(_t(x_cm), _t(w_cm), shape), want16),
                      (pc.packed_conv_chunked(_t(x_cm), _t(w_cm), shape),
                       want_chunked)):
        assert got.dtype == torch.bfloat16
        assert (np.abs(got.float().numpy() - want) <= lim16).all()


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_ablations_match_pallas_kernels(monkeypatch, tmp_path, case):
    """ablate_slabs bit for bit, ablate_matmul within one bf16 ulp, vs the
    JAX script's kernels in interpret mode."""
    shape = SHAPES[case]
    mod = _load_script(monkeypatch, tmp_path, shape)
    x_cm, w_cm, p_const = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        want_slabs = np.asarray(mod.ablate_slabs(_j(x_cm), _j(w_cm)))
        want_mm = _np(mod.ablate_matmul(_j(p_const), _j(w_cm)))
    slabs = pc.ablate_slabs(_t(x_cm), _t(w_cm), shape)
    assert tuple(slabs.shape) == want_slabs.shape
    np.testing.assert_array_equal(slabs.view(torch.int16).numpy().view(np.uint16),
                                  want_slabs.view(np.uint16))
    mm = pc.ablate_matmul(_t(p_const), _t(w_cm), shape)
    want32 = w_cm @ p_const                                # fp32, [COUT, HWP]
    lim = _ulp_bf16(want32) + FLOOR
    assert tuple(mm.shape) == want_mm.shape == (shape.BT, shape.COUT, shape.HWP)
    assert (np.abs(mm.float().numpy() - want_mm) <= lim).all()


def test_pack_matches_script(monkeypatch, tmp_path):
    shape = SHAPES["lane_tail"]
    mod = _load_script(monkeypatch, tmp_path, shape)
    rng = np.random.RandomState(3)
    x = rng.randn(shape.B, shape.T, shape.H, shape.W, shape.CIN).astype(np.float32)
    w = rng.randn(3, 3, shape.CIN, shape.COUT).astype(np.float32)
    got, want = pc.pack_x(x, shape), mod.pack_x(x)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    got, want = pc.pack_w(w), mod.pack_w(w)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_reference_conv_matches_xla_reference(monkeypatch, tmp_path, case):
    """The probe's library conv vs the JAX script's XLA conv (fp32 out) on
    the same bf16 inputs: within one bf16 ulp (the port's y is bf16)."""
    shape = SHAPES[case]
    mod = _load_script(monkeypatch, tmp_path, shape)
    rng = np.random.RandomState(4)
    x = _bf16_exact(rng.randn(shape.BT, shape.H, shape.W, shape.CIN).astype(np.float32))
    w = _bf16_exact(rng.randn(3, 3, shape.CIN, shape.COUT).astype(np.float32) / 10)
    want = np.asarray(mod.xla_reference(_j(x), _j(w)))
    got = probe.reference_conv(_t(x), _t(w))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert (np.abs(got.float().numpy() - want) <= _ulp_bf16(want) + FLOOR).all()


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_probe_check_passes_on_plain_versions(case):
    """The probe's check phase on CPU tensors (the plain versions): both
    variants agree with reference_conv over the first HW positions well
    inside the script's 2e-2, and the errors are measured over all of them."""
    shape = SHAPES[case]
    inputs, _ = probe.make_inputs(shape, "cpu")
    errs = probe.check(inputs, shape)
    assert set(errs) == {"v1", "v2-chunked"}
    assert all(0 <= e < 1e-2 for e in errs.values())
    want = probe.reference_conv(inputs["x_nd"], inputs["w_nd"])
    y = pc.packed_conv(inputs["x_cm"], inputs["w_cm"], shape)
    y[:, :, shape.HW - 1] += 1.0                         # one wrong position
    assert probe.rel_err(y, want, shape) > probe.REL_LIMIT


def test_cpu_tensors_take_plain_versions_without_launching():
    shape = SHAPES["lane_tail"]
    x_cm, w_cm, p_const = (_t(a) for a in _inputs(shape))
    before = dict(cuda_lib.launches)
    assert torch.equal(pc.packed_conv(x_cm, w_cm, shape),
                       pc.packed_conv_reference(x_cm, w_cm, shape))
    assert torch.equal(pc.packed_conv_chunked(x_cm, w_cm, shape),
                       pc.packed_conv_reference(x_cm, w_cm, shape))
    assert torch.equal(pc.ablate_slabs(x_cm, w_cm, shape),
                       pc.ablate_slabs_reference(x_cm, w_cm, shape))
    assert torch.equal(pc.ablate_matmul(p_const, w_cm, shape),
                       pc.ablate_matmul_reference(p_const, w_cm, shape))
    assert cuda_lib.launches == before
    assert {"packed_conv", "ablate_slabs", "ablate_matmul",
            "packed_conv_chunked"} <= set(cuda_lib.launches)


def test_wrappers_refuse_what_the_kernels_do_not_compute():
    shape = SHAPES["lane_tail"]
    x_cm, w_cm, p_const = (_t(a) for a in _inputs(shape))
    partial = pc.ProbeShape(B=1, T=2, H=16, W=16, CIN=8, COUT=16, CHUNK=384)
    with pytest.raises(ValueError, match="CHUNK"):
        # HWP 256 is no multiple of 384: the TPU kernel leaves y unwritten
        pc.packed_conv_chunked(torch.zeros(2, 8, partial.HWM), w_cm, partial)
    with pytest.raises(ValueError, match="shapes"):
        pc.packed_conv(x_cm[:, :4], w_cm, shape)
    with pytest.raises(ValueError, match="shapes"):
        pc.ablate_matmul(p_const[:, :64], w_cm, shape)
    with pytest.raises(ValueError, match="MARGIN"):
        wide = pc.ProbeShape(B=1, T=1, H=2, W=200, CIN=8, COUT=16)
        pc.packed_conv(torch.zeros(1, 8, wide.HWM), torch.zeros(16, 72), wide)
    with pytest.raises(ValueError, match="COUT"):
        tall = pc.ProbeShape(B=1, T=1, H=4, W=4, CIN=8, COUT=80)
        pc.ablate_slabs(torch.zeros(1, 8, tall.HWM), torch.zeros(80, 72), tall)


def test_shape_defaults_are_the_scripts_full_shape():
    s = pc.ProbeShape()
    assert (s.BT, s.HW, s.HWP, s.HWM, s.K, s.CHUNK) == (512, 3136, 3200, 3456, 576, 640)
    assert s.HWP % s.CHUNK == 0


def test_probe_main_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the probe runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        probe.main(["--iters", "1"])
    with pytest.raises(ValueError, match="unknown phases"):
        probe.run(SHAPES["lane_tail"], ["check", "nope"])
