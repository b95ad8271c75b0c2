"""The port's Aff-Wild2 data layer (``m3f_torch/data/affwild2.py``) and its
multi-process stream (``data/windowing.process_sharded_stream``) against the
JAX package's, on the same fake ABAW trees (``tests/torch_abaw_fake.py``):
video ids of each split, frame counts, frame rates (25 fps from the wav, 30
with a 60 ms wav tail, a container's rate) and every ``load_video`` array
are equal exactly — the frames bit for bit, both loaders being the same
source on the same libjpeg; so are the first batches of
``process_sharded_stream`` for one and two processes, with and without
``skip_batches``, and ``needs_dynamic_hop``."""

import os
import wave

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from m3f.pytorch_tpu import config as jconfig
from m3f.pytorch_tpu.data import affwild2 as jaff
from m3f.pytorch_tpu.data import windowing as jwin

from m3f_torch import config as tconfig
from m3f_torch.data import affwild2 as taff
from m3f_torch.data import windowing as twin

from torch_abaw_fake import SR, TEST_GAP, add_containers, make_tree, write_wav

SIZE = 16


def _data(mod, root, **kw):
    return mod.DataConfig(root=root, synthetic=False, image_size=SIZE, **kw)


def _pair(root, split, **kw):
    return (jaff.AffWild2Dataset(_data(jconfig, root, **kw), jconfig.MelConfig(),
                                 split=split),
            taff.AffWild2Dataset(_data(tconfig, root, **kw), tconfig.MelConfig(),
                                 split=split))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(str(tmp_path_factory.mktemp("abaw")), size=SIZE)


def _same_video(jv, tv):
    assert jv.keys() == tv.keys()
    for k in jv:
        a, b = np.asarray(jv[k]), np.asarray(tv[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("split,ids", [
    ("train", ["vid_25", "vid_a", "vid_b"]), ("val", ["vid_v"]),
    ("test", ["vid_t"])])
def test_splits_frame_counts_rates_and_videos_equal(tree, split, ids):
    jds, tds = _pair(tree, split)
    assert tds.video_ids() == jds.video_ids() == ids
    for vid in ids:
        assert tds.num_frames(vid) == jds.num_frames(vid)
        assert tds.video_fps(vid) == jds.video_fps(vid)
        _same_video(jds.load_video(vid), tds.load_video(vid))


def test_what_the_tree_holds(tree):
    """The cases the tree was built for read as intended: -5 rows and a
    missing crop are invalid, the 60 ms tail reads 30 fps, the 25 fps wav
    25, the test timeline keeps its gap as invalid slots with zeroed
    frames."""
    _, tds = _pair(tree, "train")
    a = tds.load_video("vid_a")
    assert not a["valid"][3] and not a["valid"][39] and a["valid"][:3].all()
    assert (a["labels"][3] == -5).all() and (a["frames"][39] == 0).all()
    assert len(a["waveform"]) == int(round(40 / 30.0 * SR))
    assert tds.video_fps("vid_b") == 30.0
    assert tds.video_fps("vid_25") == 25.0
    v25 = tds.load_video("vid_25")
    assert v25["fps"] == 25.0 and len(v25["waveform"]) == 2 * SR
    _, tt = _pair(tree, "test")
    t = tt.load_video("vid_t")
    gap = [i - 1 for i in TEST_GAP]
    assert t["frames"].shape == (30, SIZE, SIZE, 3)
    assert np.flatnonzero(~t["valid"]).tolist() == gap
    assert (t["frames"][gap] == 0).all() and (t["labels"] == -5).all()


def test_container_rates_and_test_timeline(tmp_path):
    root = make_tree(str(tmp_path / "abaw"), size=SIZE)
    if not add_containers(root, size=SIZE):
        pytest.skip("no MJPG codec in this cv2 build")
    jds, tds = _pair(root, "train")
    assert tds.video_fps("vid_a") == jds.video_fps("vid_a")
    assert abs(tds.video_fps("vid_a") - 25.0) < 1e-6
    _same_video(jds.load_video("vid_a"), tds.load_video("vid_a"))
    jt, tt = _pair(root, "test")
    assert tt.num_frames("vid_t") == jt.num_frames("vid_t") == 34
    _same_video(jt.load_video("vid_t"), tt.load_video("vid_t"))


def test_read_wav_refuses_a_wrong_rate(tmp_path):
    p = str(tmp_path / "bad.wav")
    write_wav(p, np.zeros(1000), rate=44_100)
    with pytest.raises(ValueError, match="extract_audio"):
        taff.read_wav_16k_mono(p, expected_rate=SR)
    np.testing.assert_array_equal(taff.read_wav_16k_mono(p),
                                  jaff.read_wav_16k_mono(p))
    q = str(tmp_path / "pcm32.wav")
    with wave.open(q, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(4)
        w.setframerate(SR)
        w.writeframes(np.arange(-50, 50, dtype="<i4").tobytes() * 1000)
    np.testing.assert_array_equal(taff.read_wav_16k_mono(q),
                                  jaff.read_wav_16k_mono(q))


def test_annotation_reader_equal(tree):
    p = os.path.join(tree, "annotations", "VA_Estimation_Challenge",
                     "Train_Set", "vid_a.txt")
    np.testing.assert_array_equal(taff.read_annotation_txt(p),
                                  jaff.read_annotation_txt(p))


@pytest.mark.parametrize("tail,fps", [(0.12, 30.0), (0.12, 25.0),
                                      (0.0, 13.7), (0.0, 30000 / 1001)])
def test_wav_rate_resolution_equal(tmp_path, tail, fps):
    """The wav-duration estimate resolved against the canonical rates (an
    ffmpeg tail, a true odd rate, 29.97 long enough to keep its clock)."""
    root = str(tmp_path)
    n = 5400 if fps == 30000 / 1001 else 150
    ann = os.path.join(root, "annotations", "VA_Estimation_Challenge",
                       "Train_Set")
    os.makedirs(ann)
    os.makedirs(os.path.join(root, "audio"))
    os.makedirs(os.path.join(root, "cropped_aligned", "v"))
    with open(os.path.join(ann, "v.txt"), "w") as f:
        f.write("valence,arousal\n" + "0.1,0.2\n" * n)
    write_wav(os.path.join(root, "audio", "v.wav"),
              np.zeros(int(round((n / fps + tail) * SR))))
    jds, tds = _pair(root, "train")
    assert tds.video_fps("v") == jds.video_fps("v")
    assert abs(tds.video_fps("v") - fps) < 0.01


def _batches(mod, ds, n=6, **kw):
    cfg = (jconfig if mod is jwin else tconfig)
    seq = mod.WindowSequencer(cfg.WindowConfig(windows_per_clip=2),
                              cfg.MelConfig(), mel_frames=16, hop_aware=True)
    it = mod.process_sharded_stream(ds, seq, 2, seed=3, **kw)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("pi,pc,skip,buf", [(0, 1, 0, 0), (0, 2, 0, 0),
                                            (1, 2, 0, 0), (1, 2, 2, 0),
                                            (0, 1, 3, 16), (0, 4, 1, 0)])
def test_process_sharded_stream_equal(tree, pi, pc, skip, buf):
    """The first six batches, per process, bit for bit; pc 4 > 3 videos
    takes the example-level interleave."""
    jds, tds = _pair(tree, "train")
    kw = dict(process_index=pi, process_count=pc, skip_batches=skip,
              shuffle_buffer=buf)
    want, got = _batches(jwin, jds, **kw), _batches(twin, tds, **kw)
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_process_grid_defaults_to_one_process(tree):
    _, tds = _pair(tree, "train")
    assert twin.process_grid() == (0, 1)
    a = _batches(twin, tds, n=2)
    b = _batches(twin, tds, n=2, process_index=0, process_count=1)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_partition_and_subset():
    ids = [f"v{i}" for i in range(7)]
    parts = [twin.partition_video_ids(ids, i, 3) for i in range(3)]
    assert parts == [jwin.partition_video_ids(ids, i, 3) for i in range(3)]
    assert sorted(sum(parts, [])) == ids
    with pytest.raises(ValueError):
        twin.partition_video_ids(ids, 3, 3)

    class NoCount:
        def video_ids(self):
            return ids

        def load_video(self, vid):
            return vid

    sub = twin.SubsetDataset(NoCount(), ids[:2])
    assert sub.num_frames is None and sub.load_video("v1") == "v1"


def test_needs_dynamic_hop_equal(tree, tmp_path):
    jds, tds = _pair(tree, "train")
    mel_j, mel_t = jconfig.MelConfig(), tconfig.MelConfig()
    assert twin.needs_dynamic_hop(tds, mel_t, 30.0) \
        == jwin.needs_dynamic_hop(jds, mel_j, 30.0) is True
    jv, tv = _pair(tree, "val")
    assert twin.needs_dynamic_hop(tv, mel_t, 30.0) \
        == jwin.needs_dynamic_hop(jv, mel_j, 30.0) is False
