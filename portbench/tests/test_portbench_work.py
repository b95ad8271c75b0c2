"""The yardstick's frozen work counts, against hand counts."""

import json
import os

import pytest

from portbench import readers, work
from portbench.harness import Run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _model(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)["model"]


def _hand_r2plus1d18():
    """R(2+1)D-18 on 16x112x112, multiply-adds by layer, written out."""
    total = 16 * 56 * 56 * 45 * 3 * 49 + 16 * 56 * 56 * 64 * 45 * 3  # stem
    for (t, h, c), mids in (((16, 56, 64), (144, 144, 144, 144)),):
        for mid in mids:                   # 2 blocks x 2 factorized convs
            total += t * h * h * mid * c * 9 + t * h * h * c * mid * 3
    for cin, c, t, h in ((64, 128, 8, 28), (128, 256, 4, 14),
                         (256, 512, 2, 7)):
        m1 = 27 * cin * c // (9 * cin + 3 * c)
        m2 = 27 * c * c // (9 * c + 3 * c)
        total += 2 * t * h * h * m1 * cin * 9 + t * h * h * c * m1 * 3
        total += t * h * h * m1 * c * 9 + t * h * h * c * m1 * 3
        total += t * h * h * c * cin                            # downsample
        total += 2 * (t * h * h * m2 * c * 9 + t * h * h * c * m2 * 3)
    return total


def test_backbone_macs_match_the_hand_count_and_torchvision():
    v = _model("m3f_r2plus1d18")["visual"]
    macs = work.visual_macs(v, 16, 112)
    assert macs == _hand_r2plus1d18()
    assert macs == pytest.approx(40.52e9, rel=2e-3)      # torchvision's table
    v3 = _model("m3f_r3d18")["visual"]
    assert work.visual_macs(v3, 16, 112) == pytest.approx(40.70e9, rel=2e-3)


def test_window_and_train_flops():
    m = _model("m3f_r2plus1d18")
    per_frame = 2 * (768 * 768 + 256 * 768) + 512 * 2     # BiGRU and head
    audio = (8 * 32 * 32 * 9 + 4 * 16 * 64 * 32 * 9 + 2 * 8 * 128 * 64 * 9
             + 1 * 4 * 256 * 128 * 9 + 256 * 256)
    want = 2.0 * (work.visual_macs(m["visual"], 16, 112) + audio
                  + 16 * per_frame)
    assert work.window_flops(m, 16, 112) == want
    assert work.train_clip_flops(m, 16, 112) == 3 * want
    assert work.peak_flops(m) == 989e12
    assert work.peak_flops(dict(m, compute_dtype="float32")) == 67e12


def test_fused_units_of_a_forward():
    units = work.fused_units(_model("m3f_r2plus1d18")["visual"], 128, 16, 112)
    assert len(units) == 20          # 5 identity blocks x 4 units
    assert sum(u[0] == "spatial" for u in units) == 10
    assert units[0] == ("spatial", (128, 16, 56, 56, 64), (3, 3, 64, 144),
                        False)
    assert units[-1] == ("temporal", (128, 2, 7, 7, 1152), (3, 1152, 512),
                         True)
    assert work.fused_units(_model("m3f_r3d18")["visual"], 128, 16, 112) == []


def test_unit_bounds_by_hand():
    unit = ("temporal", (128, 16, 56, 56, 144), (3, 144, 64), True)
    m = 128 * 16 * 56 * 56
    flops = 2 * 128 * 56 * 56 * (3 * 16 - 2) * 144 * 64
    fwd = m * 144 * 2 + 3 * 144 * 64 * 2 + m * 64 * 2 + 2 * 144 * 4 + 2 * 64 * 4
    f, d, w = work.unit_bounds(unit)
    assert f == max(fwd / work.HBM, flops / work.PEAK_BF16)
    assert d >= flops / work.PEAK_BF16 and w >= flops / work.PEAK_BF16


def test_readers_arithmetic():
    m = _model("m3f_r2plus1d18")
    run = Run(setup_s=1.0, window_s=2.0, attempted=1, failed=0, memory_peak=0,
              e2e={}, checks={}, model=m,
              counts={"windows": 1000, "steps": 4, "clips_per_step": 128})
    assert readers.mfu_serve(run) == pytest.approx(
        100 * 1000 * work.window_flops(m, 16, 112) / 2.0 / 989e12)
    assert readers.mfu_train(run) == pytest.approx(
        100 * 512 * 3 * work.window_flops(m, 16, 112) / 2.0 / 989e12)
    assert readers.idle_share(run) is None          # no trace: nothing to read
    assert readers.conv_units_roofline_serve(run) is None
