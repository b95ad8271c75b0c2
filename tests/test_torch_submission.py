"""The port's submission writer (``m3f_torch/infer/submission.py``) and
``stitch_overlap_average`` (``m3f_torch/ops/stitch.py``) against the JAX
package's, on numpy inputs from seeds: the files byte for byte, the stitch
within 1e-6."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from m3f.pytorch_tpu.infer.submission import write_submission as jwrite_submission
from m3f.pytorch_tpu.infer.submission import write_video_txt as jwrite_video_txt
from m3f.pytorch_tpu.ops.stitch import stitch_overlap_average as jstitch
from m3f.pytorch_tpu.ops.stitch import window_starts as jwindow_starts
from m3f_torch.infer.submission import write_submission, write_video_txt
from m3f_torch.ops.stitch import stitch_overlap_average, window_starts


def _preds(n, seed, scale=1.3):
    """Predictions past [-1, 1], near-zero and negative values, and values
    on the edge of the sixth decimal."""
    rng = np.random.RandomState(seed)
    p = (rng.randn(n, 2) * scale).astype(np.float32)
    edge = np.asarray([[-1e-7, 5e-7], [0.0000005, -0.0000015], [1.0, -1.0]],
                      np.float32)
    p[:3] = edge[:n]
    return p


@pytest.mark.parametrize("n", [1, 7, 300])
def test_write_video_txt_is_byte_identical(tmp_path, n):
    preds = _preds(n, seed=n)
    write_video_txt(str(tmp_path / "port" / "v.txt"), preds)
    jwrite_video_txt(str(tmp_path / "jax" / "v.txt"), preds)
    got = (tmp_path / "port" / "v.txt").read_bytes()
    assert got == (tmp_path / "jax" / "v.txt").read_bytes()
    assert got.startswith(b"valence,arousal\n") and got.count(b"\n") == n + 1


@pytest.mark.parametrize("smooth", [1, 5])
@pytest.mark.parametrize("with_valid", [False, True])
def test_write_submission_is_byte_identical(tmp_path, smooth, with_valid):
    rng = np.random.RandomState(3)
    preds = {"video_a": _preds(120, 1), "video_b_left": _preds(33, 2),
             "video_b_right": _preds(64, 4)}
    valid = None
    if with_valid:
        valid = {vid: rng.rand(len(p)) > 0.3 for vid, p in preds.items()}
        valid["video_b_left"][:] = False          # no valid frame at all
    write_submission(str(tmp_path / "port"), preds, valid, smooth)
    jwrite_submission(str(tmp_path / "jax"), preds, valid, smooth)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(vid + ".txt" for vid in preds)
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("n_frames,window,stride", [(16, 16, 8), (100, 16, 8),
                                                     (257, 16, 5), (40, 8, 8)])
def test_stitch_overlap_average_matches_the_reference(n_frames, window, stride):
    starts = window_starts(n_frames, window, stride)
    np.testing.assert_array_equal(starts, jwindow_starts(n_frames, window, stride))
    preds = np.random.RandomState(n_frames).randn(len(starts), 2).astype(np.float32)
    got = stitch_overlap_average(torch.from_numpy(preds),
                                 torch.from_numpy(starts), n_frames, window)
    want = jstitch(jnp.asarray(preds), jnp.asarray(starts), n_frames, window)
    assert got.dtype == torch.float32 and got.shape == (n_frames, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_stitch_overlap_average_past_the_end_and_uncovered_frames():
    """Frames past ``num_frames`` are dropped (the last frame gets nothing
    from them), and a frame no window covers is 0, as the reference's."""
    starts = np.asarray([0, 10], np.int32)
    preds = np.asarray([[1.0, 2.0], [3.0, -4.0]], np.float32)
    got = stitch_overlap_average(torch.from_numpy(preds),
                                 torch.from_numpy(starts), 14, 8).numpy()
    want = np.asarray(jstitch(jnp.asarray(preds), jnp.asarray(starts), 14, 8))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[8:10], 0.0)
    np.testing.assert_array_equal(got[13], [3.0, -4.0])
