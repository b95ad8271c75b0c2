"""The log-mel kernel's FFT plan (m3f_torch/ops/melspec.py ``fft_plan``, run
by csrc/melspec.cu): a numpy run of the plan as the kernel runs it — the
host-built twiddle table, the Stockham stage order and the real split, in
complex64 — against ``np.fft.rfft`` of the windowed frames (1e-4 of the
frame's largest bin: fp32 round-off over log2(n) stages), and the per-band
bin ranges against the filterbank (exact). The JAX package's constants
(``_windowed_dft_mats``) give the reference window and filterbank."""

import dataclasses

import numpy as np
import pytest

from m3f.pytorch_tpu.config import MelConfig as JMelConfig
from m3f.pytorch_tpu.ops.pallas.melspec_pallas import _windowed_dft_mats
from m3f_torch.config import MelConfig
from m3f_torch.ops import melspec

FFT_REL = 1e-4


def run_plan(frames: np.ndarray, plan: melspec.MelFftPlan) -> np.ndarray:
    """[F, n_fft] raw samples → the bins [bin_lo, bin_hi) of their windowed
    rFFT, computed as log_mel_kernel does."""
    n = len(plan.window)
    N = n // 2
    e = (plan.twiddles[:, 0] + 1j * plan.twiddles[:, 1]).astype(np.complex64)
    xw = frames.astype(np.float32) * plan.window
    src = (xw[:, 0::2] + 1j * xw[:, 1::2]).astype(np.complex64)
    ns = 1
    for r_ in plan.radices:
        j = np.arange(N // r_)
        k = j % ns
        v = [src[:, j + r * (N // r_)] * e[2 * r * k * (N // (ns * r_))]
             for r in range(r_)]
        if r_ == 2:
            out = [v[0] + v[1], v[0] - v[1]]
        else:
            a0, a1 = v[0] + v[2], v[0] - v[2]
            a2, a3 = v[1] + v[3], -1j * (v[1] - v[3])
            out = [a0 + a2, a1 + a3, a0 - a2, a1 - a3]
        dst = np.empty_like(src)
        d = (j // ns) * ns * r_ + k
        for r in range(r_):
            dst[:, d + r * ns] = out[r]
        src, ns = dst, ns * r_
    k = np.arange(plan.bin_lo, plan.bin_hi)
    z, zc = src[:, k % N], np.conj(src[:, (N - k) % N])
    return 0.5 * (z + zc) - 0.5j * e[k] * (z - zc)


def _frames(cfg, seed, count=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(count, cfg.n_fft) * 0.3).astype(np.float32)


CONFIGS = {"default": {}, "n_fft_512": {"n_fft": 512, "win_length": 512},
           "win_400_of_512": {"n_fft": 512, "win_length": 400},
           "n_fft_2048": {"n_fft": 2048, "win_length": 1600, "n_mels": 80},
           "n_fft_64": {"n_fft": 64, "win_length": 64, "n_mels": 8}}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_run_equals_rfft(name):
    cfg = dataclasses.replace(MelConfig(), **CONFIGS[name])
    plan = melspec.fft_plan(cfg)
    n = cfg.n_fft
    assert np.prod(plan.radices) == n // 2
    assert list(plan.radices) == sorted(plan.radices)   # radix 2 first
    # the window, centred when win_length < n_fft, is the reference's
    jc, _, _ = _windowed_dft_mats(JMelConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(plan.window, jc[:, 0], rtol=0, atol=1e-7)
    frames = _frames(cfg, seed=n)
    got = run_plan(frames, plan)
    want = np.fft.rfft(frames.astype(np.float64) * plan.window.astype(np.float64),
                       axis=-1)[:, plan.bin_lo:plan.bin_hi]
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= FFT_REL * scale).all()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_band_ranges_cover_the_filterbank(name):
    cfg = dataclasses.replace(MelConfig(), **CONFIGS[name])
    plan = melspec.fft_plan(cfg)
    fb = melspec.mel_filterbank(cfg)
    for m in range(cfg.n_mels):
        lo, hi = int(plan.band_lo[m]), int(plan.band_hi[m])
        inside = np.zeros(len(fb), bool)
        inside[lo:hi] = True
        assert (fb[inside, m] > 0).all() and not fb[~inside, m].any()
        np.testing.assert_array_equal(plan.weights[m, :hi - lo], fb[lo:hi, m])
        assert not plan.weights[m, hi - lo:].any()
        assert plan.bin_lo <= lo and (hi <= plan.bin_hi or hi == lo)
    # the default config leaves out bins 0 and n/2: they weigh nothing
    if name == "default":
        assert plan.bin_lo >= 1 and plan.bin_hi <= cfg.n_fft // 2


@pytest.mark.parametrize("n_fft", [1000, 3, 0])
def test_plan_refuses_other_sizes(n_fft):
    with pytest.raises(ValueError, match="power of two"):
        melspec.fft_plan(dataclasses.replace(MelConfig(), n_fft=n_fft))
