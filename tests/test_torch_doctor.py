"""The port's dataset pre-flight (``m3f_torch/data/doctor.py``) against the
JAX package's: every ``check_video`` row of every split and every
``run_doctor`` return code and log line are equal on the same fake ABAW
trees — a healthy tree (the 25 fps video flagged off-rate), one with a
wav at the wrong rate, a stereo wav, a crop dir with most crops missing,
a missing crop dir, a video with no wav, an empty annotation and an empty
root."""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("cv2")

from m3f.pytorch_tpu import config as jconfig
from m3f.pytorch_tpu.data import affwild2 as jaff
from m3f.pytorch_tpu.data import doctor as jdoc

from m3f_torch import config as tconfig
from m3f_torch.data import affwild2 as taff
from m3f_torch.data import doctor as tdoc

from torch_abaw_fake import ANN, SR, make_tree, write_wav

SIZE = 16


def _cfgs(root):
    out = []
    for mod in (jconfig, tconfig):
        out.append(mod.apply_overrides(mod.fusion(), {
            "data.root": root, "data.synthetic": False,
            "data.image_size": SIZE}))
    return out


def _rows(root):
    jcfg, tcfg = _cfgs(root)
    rows = {}
    for split in ("train", "val", "test"):
        jds = jaff.AffWild2Dataset(jcfg.data, jcfg.model.mel, split=split)
        tds = taff.AffWild2Dataset(tcfg.data, tcfg.model.mel, split=split)
        assert tds.video_ids() == jds.video_ids()
        for vid in jds.video_ids():
            want, got = jdoc.check_video(jds, vid), tdoc.check_video(tds, vid)
            assert got == want, (split, vid)
            rows[vid] = got
    return rows


def _run(root, **kw):
    jcfg, tcfg = _cfgs(root)
    out = []
    for mod, cfg in ((jdoc, jcfg), (tdoc, tcfg)):
        lines = []
        rc = mod.run_doctor(cfg, log=lines.append, **kw)
        out.append((rc, lines))
    assert out[1] == out[0]
    return out[1]


@pytest.fixture
def tree(tmp_path):
    return make_tree(str(tmp_path / "abaw"), size=SIZE)


def test_healthy_tree(tree):
    rows = _rows(tree)
    off = sorted(v for v, r in rows.items() if r["fps"] != 30.0)
    assert off == ["vid_25"]
    assert not any(r["errors"] for r in rows.values())
    assert rows["vid_t"]["missing_crops"] == 5
    rc, lines = _run(tree)
    assert rc == 0
    assert "train: 3 videos, 0 with errors, 1 with warnings, 1 off-rate" in lines
    rc, lines = _run(tree, as_json=True, splits=("train", "test"))
    assert rc == 0
    assert {json.loads(l)["video"] for l in lines if l.startswith("{")} \
        == {"vid_a", "vid_b", "vid_25", "vid_t"}


def test_broken_tree(tree):
    audio = os.path.join(tree, "audio")
    write_wav(os.path.join(audio, "vid_b.wav"), np.zeros(1000), rate=44_100)
    import wave
    with wave.open(os.path.join(audio, "vid_v.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.zeros(2000, "<i2").tobytes())
    crops = os.path.join(tree, "cropped_aligned")
    for i in range(2, 41):
        p = os.path.join(crops, "vid_a", f"{i:05d}.jpg")
        if os.path.exists(p):
            os.unlink(p)
    shutil.rmtree(os.path.join(crops, "vid_25"))
    os.unlink(os.path.join(audio, "vid_t.wav"))
    with open(os.path.join(tree, *ANN, "Train_Set", "vid_e.txt"), "w") as f:
        f.write("valence,arousal\n")
    rows = _rows(tree)
    assert any("wav rate 44100" in e for e in rows["vid_b"]["errors"])
    assert any("channels" in e for e in rows["vid_v"]["errors"])
    assert any(">50% dropout" in w for w in rows["vid_a"]["warnings"])
    assert "crop dir missing" in rows["vid_25"]["errors"]
    assert any("no wav" in w for w in rows["vid_t"]["warnings"])
    assert any("empty timeline" in e for e in rows["vid_e"]["errors"])
    rc, lines = _run(tree)
    assert rc == 1
    rc, _ = _run(tree, splits=("test",))
    assert rc == 0


def test_empty_root(tmp_path):
    rc, lines = _run(str(tmp_path / "nowhere"))
    assert rc == 1 and any("no videos found" in l for l in lines)
