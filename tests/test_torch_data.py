"""The port's data layer (m3f_torch/data) against the JAX package's: the
synthetic set video for video, and ``example_stream`` batch for batch,
bitwise (both are numpy with the same RandomState calls), with and without
the shuffle buffer, the decode cache and ``skip_batches`` (exact resume)."""

import itertools

import numpy as np
import pytest

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.data import synthetic as jsyn, windowing as jwin
from m3f_torch.data import synthetic as tsyn, windowing as twin


def _data(mod, frames=48, videos=3, per_frame=True, hop_aware=False):
    dcfg = mod.DataConfig(synthetic_num_videos=videos,
                          synthetic_video_frames=frames, image_size=16)
    mel = mod.MelConfig()
    ds = (jsyn if mod is jc else tsyn).SyntheticAVDataset(dcfg, mel, seed=2)
    seq = (jwin if mod is jc else twin).WindowSequencer(
        mod.WindowConfig(windows_per_clip=2), mel, per_frame=per_frame,
        hop_aware=hop_aware)
    return ds, seq


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_synthetic_videos_equal():
    (jds, _), (tds, _) = _data(jc), _data(tc)
    assert jds.video_ids() == tds.video_ids()
    for vid in jds.video_ids():
        _equal(jds.load_video(vid), tds.load_video(vid))
        assert jds.num_frames(vid) == tds.num_frames(vid)


@pytest.mark.parametrize("per_frame,hop_aware", [(True, False), (False, False),
                                                 (True, True)])
def test_window_cut_equal(per_frame, hop_aware):
    (jds, jseq), (tds, tseq) = (_data(jc, per_frame=per_frame, hop_aware=hop_aware),
                                _data(tc, per_frame=per_frame, hop_aware=hop_aware))
    video = jds.load_video("synth_0001")
    video["fps"] = 25.0
    assert jseq.example_starts(48, 8) == tseq.example_starts(48, 8)
    for start in jseq.example_starts(48, 8):
        _equal(jseq.cut(video, start), tseq.cut(video, start))
    mel = tc.MelConfig()
    assert twin.samples_per_window(mel, 16) == jwin.samples_per_window(mel, 16)
    assert twin.samples_per_window_max(mel, 16) == jwin.samples_per_window_max(mel, 16)


@pytest.mark.parametrize("shuffle_buffer,skip,cache", [(0, 0, 1), (5, 0, 1),
                                                       (0, 3, 1), (5, 4, 2)])
def test_example_stream_bitwise_equal(shuffle_buffer, skip, cache):
    (jds, jseq), (tds, tseq) = _data(jc), _data(tc)
    kw = dict(seed=7, shuffle_buffer=shuffle_buffer, skip_batches=skip,
              cache_videos=cache)
    js = jwin.example_stream(jds, jseq, 2, **kw)
    ts = twin.example_stream(tds, tseq, 2, **kw)
    for a, b in itertools.islice(zip(js, ts), 8):
        _equal(a, b)


def test_skip_batches_is_exact_resume():
    tds, tseq = _data(tc)
    full = list(itertools.islice(twin.example_stream(tds, tseq, 2, seed=3), 7))
    rest = list(itertools.islice(twin.example_stream(tds, tseq, 2, seed=3,
                                                     skip_batches=4), 3))
    for a, b in zip(full[4:], rest):
        _equal(a, b)


def test_finite_stream_and_helpers():
    (jds, jseq), (tds, tseq) = _data(jc), _data(tc)
    a = list(jwin.example_stream(jds, jseq, 2, seed=1, loop=False))
    b = list(twin.example_stream(tds, tseq, 2, seed=1, loop=False))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        _equal(x, y)
    assert twin.video_num_frames(tds, "synth_0000") == 48
    assert not twin.needs_dynamic_hop(tds, tc.MelConfig(), 30.0)
    labels = np.array([[0.5, -0.5], [1.0, 0.0]], np.float32)
    for valid in (np.array([True, False]), np.array([False, False])):
        np.testing.assert_array_equal(twin.window_label(labels, valid),
                                      jwin.window_label(labels, valid))
    with pytest.raises(ValueError, match="no videos"):
        next(twin.example_stream(_data(tc, videos=0)[0], tseq, 2))
