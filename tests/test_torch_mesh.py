"""``train.mesh`` in the port's ``Trainer`` beside the JAX package's: a mesh
that cannot be built is refused before the model is, with the reference's
wording (``parallel/mesh.py`` ``order_devices_for_mesh``: ``mesh {data}x
{model} needs {n} devices, have {m}``), a tensor-parallel mesh
(``num_model`` > 1) whose rows the processes cannot fill too, naming
``num_model``; ``num_data`` -1 (every device) and 1 build a trainer that
takes a step. A tensor-parallel mesh that the processes fill builds and
trains in tests/test_torch_parallel.py (1 x 2 on two ranks) and
tests/test_torch_tensor_parallel.py (2 x 2 and 1 x 4 on four). The JAX side runs on the suite's 8
fake CPU devices (tests/conftest.py), the port on one process without a
``torch.distributed`` group (one device)."""

import re

import jax
import numpy as np
import pytest
import torch

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import WindowSequencer, example_stream
from m3f_torch.train.loop import Trainer

REFUSAL = re.compile(r"mesh (\d+)x1 needs (\d+) devices, have (\d+)")


def _cfg(mod, num_data, num_model=1):
    return mod.ExperimentConfig(
        name="t",
        model=mod.ModelConfig(
            use_video=False,
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype="float32"),
        window=mod.WindowConfig(windows_per_clip=2),
        data=mod.DataConfig(synthetic_num_videos=2, synthetic_video_frames=64,
                            image_size=32),
        train=mod.TrainConfig(batch_size=2, num_steps=1, log_every=1,
                              eval_every=0, checkpoint_every=0,
                              mesh=mod.MeshConfig(num_data=num_data,
                                                  num_model=num_model)))


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    m = REFUSAL.search(str(e.value))
    assert m, str(e.value)
    return tuple(int(v) for v in m.groups())


@pytest.mark.parametrize("extra", [1, 3])
def test_a_mesh_wider_than_the_devices_is_refused_as_by_jax(extra):
    """One more device row than there are devices (and three more): the
    JAX ``Trainer`` and the port's both raise ValueError with the same
    words, each naming its own device count."""
    n_jax = jax.device_count()
    want = _refusal(lambda: JTrainer(_cfg(jc, n_jax + extra)))
    assert want == (n_jax + extra, n_jax + extra, n_jax)
    got = _refusal(lambda: Trainer(_cfg(tc, 1 + extra), device="cpu"))
    assert got == (1 + extra, 1 + extra, 1)


def test_tensor_parallel_mesh_is_refused_by_name():
    """One process cannot fill a row of two: ``num_data`` -1 names the
    multiple of ``num_model`` it needs, ``num_data`` 1 the device count, in
    the JAX ``Trainer``'s words for a mesh wider than its devices (here 5
    rows of 2 on its 8)."""
    with pytest.raises(ValueError, match=r"mesh -1x2 needs a multiple of 2 "
                                         r"devices, have 1"):
        Trainer(_cfg(tc, -1, num_model=2), device="cpu")
    pat = r"mesh (\d+)x2 needs (\d+) devices, have (\d+)"
    with pytest.raises(ValueError, match=pat) as port:
        Trainer(_cfg(tc, 1, num_model=2), device="cpu")
    assert re.search(pat, str(port.value)).groups() == ("1", "2", "1")
    with pytest.raises(ValueError, match=pat) as ref:
        JTrainer(_cfg(jc, jax.device_count() // 2 + 1, num_model=2))
    assert re.search(pat, str(ref.value)).groups() == (
        str(jax.device_count() // 2 + 1), str(jax.device_count() + 2),
        str(jax.device_count()))
    with pytest.raises(ValueError, match=r"num_model must be at least 1"):
        Trainer(_cfg(tc, 1, num_model=0), device="cpu")


@pytest.mark.parametrize("num_data", [0, -2])
def test_a_mesh_without_rows_is_refused(num_data):
    with pytest.raises(ValueError, match=r"num_data"):
        Trainer(_cfg(tc, num_data), device="cpu")


@pytest.mark.parametrize("num_data", [-1, 1])
def test_every_device_or_one_row_trains(num_data):
    """``num_data`` -1 and 1 build the trainer as before and take a step
    with a finite loss."""
    torch.set_num_threads(1)
    cfg = _cfg(tc, num_data)
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state()
    batch = next(example_stream(SyntheticAVDataset(cfg.data, cfg.model.mel),
                                WindowSequencer(cfg.window, cfg.model.mel,
                                                mel_frames=16),
                                cfg.train.batch_size, seed=0))
    metrics = tr.train_step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
