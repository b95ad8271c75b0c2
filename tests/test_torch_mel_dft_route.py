"""The log-mel frontend for an n_fft that is not a power of two
(m3f_torch/ops/melspec.py), which once took a DFT-product kernel and now
takes the one mixed-radix FFT kernel: the plan every such n_fft gets (a
power of two keeps its radix-2-then-4 stages), and the plain version at
n_fft = win_length = 400 and at an odd n_fft against the JAX package's
``log_mel_spectrogram`` (XLA rFFT) and its Pallas kernel in interpret mode
(1e-4: fp32 rFFT against fp32 rFFT or DFT product). Inputs are numpy from
a seed."""

import dataclasses
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from m3f.pytorch_tpu.config import MelConfig as JMelConfig
from m3f.pytorch_tpu.ops.melspec import log_mel_spectrogram as jax_log_mel
from m3f.pytorch_tpu.ops.pallas.melspec_pallas import log_mel_spectrogram_pallas
from m3f_torch.config import MelConfig
from m3f_torch.ops import cuda_lib, melspec

CFG400 = MelConfig(n_fft=400, win_length=400)
JCFG400 = JMelConfig(**dataclasses.asdict(CFG400))
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _wav(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("n_fft,fft", [(1024, True), (512, True), (4, True),
                                       (400, False), (1000, False), (2, False),
                                       (6, False)])
def test_route_choice(n_fft, fft):
    """Every n_fft has a plan for the one kernel: a power of two (at least
    4, the FFT's only sizes before) keeps exactly its stages, a radix 2
    first where log2 N is odd, then 4s; the others (the DFT product's
    before) get radix 3, 5 or prime stages, or none at N = 1."""
    cfg = dataclasses.replace(MelConfig(), n_fft=n_fft, win_length=n_fft)
    plan = melspec.fft_plan(cfg)
    n = melspec.fft_size(n_fft)
    assert math.prod(plan.radices) == n
    log2n = n.bit_length() - 1
    if fft:
        assert plan.radices == (2,) * (log2n & 1) + (4,) * (log2n // 2)
    else:
        assert set(plan.radices) - {2, 4} or plan.radices == ()


def test_plain_n_fft_400_matches_jax():
    wav = _wav((2, 3, 15 * CFG400.hop_length), 1)
    before = dict(cuda_lib.launches)
    got = melspec.log_mel_spectrogram(torch.from_numpy(wav), CFG400).numpy()
    assert cuda_lib.launches == before       # no kernel on a CPU tensor
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_log_mel(jnp.asarray(wav), JCFG400))
        pal = np.asarray(log_mel_spectrogram_pallas(
            jnp.asarray(wav[0]), JCFG400, interpret=True))
    assert got.shape == want.shape == (2, 3, 16, CFG400.n_mels)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[0], pal, atol=ATOL, rtol=0)


def test_plain_n_fft_400_dynamic_hop_matches_jax():
    wav = _wav((2, 15 * CFG400.max_hop_length), 2)
    hop = np.asarray([[600], [667]], np.int32)
    got = melspec.log_mel_spectrogram(torch.from_numpy(wav), CFG400,
                                      hop=torch.from_numpy(hop[:, 0]),
                                      n_frames_out=16).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_log_mel(jnp.asarray(wav), JCFG400,
                                      hop=jnp.asarray(hop[:, 0]),
                                      n_frames_out=16))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_fft", [401, 405])
def test_plain_odd_n_fft_matches_jax(n_fft):
    """An odd n_fft over rows a whole number of hops long: the last frame
    reaches one sample past the reflect-padded row, which the reference's
    gather reads as the row's last; the plain version keeps its frame
    count and values."""
    cfg = dataclasses.replace(MelConfig(), n_fft=n_fft, win_length=n_fft)
    wav = _wav((2, 15 * cfg.hop_length), n_fft)
    got = melspec.log_mel_spectrogram(torch.from_numpy(wav), cfg).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_log_mel(jnp.asarray(wav),
                                      JMelConfig(**dataclasses.asdict(cfg))))
    assert got.shape == want.shape == (2, 16, cfg.n_mels)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
