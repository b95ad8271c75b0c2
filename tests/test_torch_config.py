"""The port's config (m3f_torch/config.py) equals the JAX package's: every
preset's dict and hash, overrides, and the per-video hop plan."""

import pytest
import torch

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc

PRESETS = sorted(jc.PRESETS)
OVERRIDES = {"train.optim.learning_rate": "3e-4",
             "model.visual.blocks_per_stage": "3,4,6,3",
             "model.gru.hidden_size": 128,
             "window.eval_max_windows": "64",
             "model.use_audio": "false"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_same_presets():
    assert sorted(tc.PRESETS) == PRESETS


@pytest.mark.parametrize("name", PRESETS)
def test_preset_dict_hash_overrides_and_hop_plan(name):
    j, t = jc.PRESETS[name](), tc.PRESETS[name]()
    assert t.to_dict() == j.to_dict()
    assert t.to_json() == j.to_json()
    assert t.config_hash() == j.config_hash()
    jo, to = jc.apply_overrides(j, OVERRIDES), tc.apply_overrides(t, OVERRIDES)
    assert to.to_dict() == jo.to_dict()
    assert to.config_hash() == jo.config_hash()
    for cfg_j, cfg_t in ((j, t), (jo, to)):
        for backend in ("xla", "pallas"):
            mj = jc.apply_overrides(cfg_j, {"model.mel_backend": backend}).model
            mt = tc.apply_overrides(cfg_t, {"model.mel_backend": backend}).model
            for fps in (24.0, 25.0, 29.97, 30.0, 60.0):
                assert mt.hop_plan(fps, 30.0) == mj.hop_plan(fps, 30.0)
