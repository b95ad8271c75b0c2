"""The log-mel frontend for an n_fft that is not a power of two
(m3f_torch/ops/melspec.py): the route choice (the FFT kernel for a power of
two, at least 4; the DFT-product kernel otherwise), the DFT route's host
constants ``windowed_dft_mats`` against the JAX Pallas kernel's
``_windowed_dft_mats`` (the same float64 values cast to fp32: exact), a
numpy run of the route's product with those constants against the plain
version (fp32: summation order, 1e-4 in the log domain), and the plain
version at n_fft = win_length = 400 against the JAX package's
``log_mel_spectrogram`` (XLA rFFT) and its Pallas kernel in interpret mode
(1e-4: fp32 rFFT against fp32 rFFT or DFT product). Inputs are numpy from
a seed."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from m3f.pytorch_tpu.config import MelConfig as JMelConfig
from m3f.pytorch_tpu.ops.melspec import log_mel_spectrogram as jax_log_mel
from m3f.pytorch_tpu.ops.pallas.melspec_pallas import (
    _windowed_dft_mats, log_mel_spectrogram_pallas)
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
    """A power of two (at least 4) takes the FFT; the plan refuses the rest,
    which take the DFT product."""
    cfg = dataclasses.replace(MelConfig(), n_fft=n_fft, win_length=n_fft)
    assert melspec.fft_route(cfg) == fft
    if not fft:
        with pytest.raises(ValueError, match="power of two"):
            melspec.fft_plan(cfg)


@pytest.mark.parametrize("cfg", [CFG400, MelConfig(),
                                 MelConfig(n_fft=600, win_length=400)],
                         ids=["n_fft400", "n_fft1024", "n_fft600_win400"])
def test_windowed_dft_mats_match_jax(cfg):
    """The kept bins [lo, lo + nb) are the JAX bases' columns bit for bit;
    the padding columns are zero; the JAX filterbank weighs no bin outside
    them."""
    c, s, fbp, lo = melspec.windowed_dft_mats(cfg)
    jc, js, jfb = _windowed_dft_mats(JMelConfig(**dataclasses.asdict(cfg)))
    nb = int(np.nonzero(jfb.any(axis=1))[0][-1]) - lo + 1
    assert c.shape == s.shape == (cfg.n_fft, fbp.shape[0])
    assert fbp.shape[0] % 256 == 0 and fbp.shape[0] >= nb
    np.testing.assert_array_equal(c[:, :nb], jc[:, lo:lo + nb])
    np.testing.assert_array_equal(s[:, :nb], js[:, lo:lo + nb])
    np.testing.assert_array_equal(fbp[:nb], jfb[lo:lo + nb])
    assert not c[:, nb:].any() and not s[:, nb:].any() and not fbp[nb:].any()
    assert not jfb[:lo].any() and not jfb[lo + nb:].any()


def test_dft_product_matches_plain():
    """The DFT route's arithmetic in numpy: frames @ C', @ S', power, @ fb',
    log, at n_fft 400 over reflect-padded frames."""
    wav = _wav((2, 15 * CFG400.hop_length), 0)
    c, s, fbp, _ = melspec.windowed_dft_mats(CFG400)
    n, hop = CFG400.n_fft, CFG400.hop_length
    x = np.pad(wav, ((0, 0), (n // 2, n // 2)), mode="reflect")
    f = melspec.num_frames(wav.shape[-1], CFG400)
    frames = np.stack([x[:, i * hop:i * hop + n] for i in range(f)], 1)
    power = (frames @ c) ** 2 + (frames @ s) ** 2
    got = np.log(power @ fbp + CFG400.log_eps)
    want = melspec.log_mel_spectrogram(torch.from_numpy(wav), CFG400).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


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
