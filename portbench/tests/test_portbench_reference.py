"""The plain reference against the port at a tiny width on the CPU, on the
seeded weights both are given: in float32 the port's plain versions and the
reference compute the same function, so the runners' comparisons read
rounding alone."""

import pytest
import torch

from m3f_torch.config import MelConfig
from m3f_torch.ops.melspec import log_mel_spectrogram_reference
from portbench.reference.mel import log_mel
from portbench_tiny import cell, run, tiny_config


def test_log_mel_matches_the_port():
    mel = tiny_config()["model"]["mel"]
    wav = 0.1 * torch.randn(3, 7995, generator=torch.Generator().manual_seed(0))
    want = log_mel_spectrogram_reference(wav, MelConfig())
    got = log_mel(wav, mel)
    assert got.shape == want.shape == (3, 16, 64)
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("conv_mode", ["2plus1d", "3d"])
def test_serving_matches_the_port(conv_mode):
    r = run(cell("serve", conv_mode))
    assert r.attempted >= 3 and r.failed == 0
    assert r.checks["pred_max_gap"]["value"] < 1e-4
    assert r.correct


def test_training_matches_the_port():
    r = run(cell("train"))
    assert r.attempted >= 1 and r.failed == 0
    got = r.host["readings"]
    assert got["loss_gap"] < 1e-4
    assert got["grad_gap"] < 1e-2
    assert got["change_gap"] < 0.05
    assert r.correct

