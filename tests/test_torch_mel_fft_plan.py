"""The log-mel kernel's FFT plan (m3f_torch/ops/melspec.py ``fft_plan``, run
by csrc/melspec.cu): a numpy run of the plan as the kernel runs it — the
host-built twiddle table, the mixed-radix Stockham stages (radix 2, 3, 4
and 5 butterflies, a p-term sum with an integer twiddle index for any other
prime), the real split of an even n_fft or the plain bins of an odd one, in
complex64 — against ``np.fft.rfft`` of the windowed frames (1e-4 of the
frame's largest bin: fp32 round-off over the stages), the per-band bin
ranges against the filterbank (exact), the launch layout's shared memory
against a block's 227 KB, and the plan's bins through the band sums and log
against the JAX package's Pallas kernel (interpret mode) and XLA path
(1e-4). The JAX package's constants (``_windowed_dft_mats``) give the
reference window and filterbank."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from m3f.pytorch_tpu.config import MelConfig as JMelConfig
from m3f.pytorch_tpu.ops.melspec import log_mel_spectrogram as jax_log_mel
from m3f.pytorch_tpu.ops.pallas.melspec_pallas import (
    _windowed_dft_mats, log_mel_spectrogram_pallas)
from m3f_torch.config import MelConfig
from m3f_torch.ops import melspec

FFT_REL = 1e-4
LOG_ATOL = 1e-4
S3 = np.float32(np.sqrt(3.0) / 2)
C1, C2 = np.float32(np.cos(2 * np.pi / 5)), np.float32(np.cos(4 * np.pi / 5))
S1, S2 = np.float32(np.sin(2 * np.pi / 5)), np.float32(np.sin(4 * np.pi / 5))


def _butterfly(v, r_, w):
    """A stage's outputs from its inputs v (twiddled): the kernel's radix
    2-5 butterflies, or for any other p each output's p-term sum with
    w_p^(rs) = ``w[(r s) mod p]``."""
    if r_ == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if r_ == 3:
        s = v[1] + v[2]
        t1, t2 = v[0] - np.float32(0.5) * s, -1j * S3 * (v[1] - v[2])
        return [v[0] + s, t1 + t2, t1 - t2]
    if r_ == 4:
        a0, a1 = v[0] + v[2], v[0] - v[2]
        a2, a3 = v[1] + v[3], -1j * (v[1] - v[3])
        return [a0 + a2, a1 + a3, a0 - a2, a1 - a3]
    if r_ == 5:
        a1, b1, a2, b2 = v[1] + v[4], v[1] - v[4], v[2] + v[3], v[2] - v[3]
        p1, p2 = v[0] + C1 * a1 + C2 * a2, v[0] + C2 * a1 + C1 * a2
        q1, q2 = S1 * b1 + S2 * b2, S2 * b1 - S1 * b2
        return [v[0] + a1 + a2, p1 - 1j * q1, p2 - 1j * q2, p2 + 1j * q2,
                p1 + 1j * q1]
    r = np.arange(r_)
    wm = w[(r[:, None] * r[None, :]) % r_]                  # [r, s]
    return list(np.einsum("rs,sfj->rfj", wm, np.stack(v)).astype(np.complex64))


def run_plan(frames: np.ndarray, plan: melspec.MelFftPlan, bins=None
             ) -> np.ndarray:
    """[F, n_fft] raw samples → the bins ``bins`` (default [bin_lo,
    bin_hi)) of their windowed rFFT, computed as log_mel_kernel does."""
    n = len(plan.window)
    odd = n % 2
    N, ts = melspec.fft_size(n), 1 if odd else 2
    e = (plan.twiddles[:, 0] + 1j * plan.twiddles[:, 1]).astype(np.complex64)
    xw = frames.astype(np.float32) * plan.window
    src = xw.astype(np.complex64) if odd else \
        (xw[:, 0::2] + 1j * xw[:, 1::2]).astype(np.complex64)
    ns = 1
    for r_ in plan.radices:
        nr = N // r_
        j = np.arange(nr)
        k = j % ns
        v = [src[:, j + r * nr] * e[ts * r * k * (N // (ns * r_))]
             for r in range(r_)]
        out = _butterfly(v, r_, e[ts * nr * np.arange(r_)])
        dst = np.empty_like(src)
        d = (j // ns) * ns * r_ + k
        for r in range(r_):
            dst[:, d + r * ns] = out[r]
        src, ns = dst, ns * r_
    k = np.arange(plan.bin_lo, plan.bin_hi) if bins is None else bins
    if odd:
        return src[:, k]
    z, zc = src[:, k % N], np.conj(src[:, (N - k) % N])
    return 0.5 * (z + zc) - 0.5j * e[k] * (z - zc)


def _frames(cfg, seed, count=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(count, cfg.n_fft) * 0.3).astype(np.float32)


def _cfg(n_fft, **kw):
    return dataclasses.replace(MelConfig(), n_fft=n_fft, win_length=n_fft, **kw)


CONFIGS = {"default": {}, "n_fft_512": {"n_fft": 512, "win_length": 512},
           "win_400_of_512": {"n_fft": 512, "win_length": 400},
           "n_fft_2048": {"n_fft": 2048, "win_length": 1600, "n_mels": 80},
           "n_fft_64": {"n_fft": 64, "win_length": 64, "n_mels": 8},
           # the speech windows at 16 kHz: 25, 20 and 30 ms
           "n_fft_400": {"n_fft": 400, "win_length": 400},
           "n_fft_320": {"n_fft": 320, "win_length": 320},
           "n_fft_480": {"n_fft": 480, "win_length": 480},
           "n_fft_1000": {"n_fft": 1000, "win_length": 1000},   # 4 5 5 5
           "n_fft_448": {"n_fft": 448, "win_length": 448},      # radix 7
           "n_fft_998": {"n_fft": 998, "win_length": 998},      # one 499
           "n_fft_405": {"n_fft": 405, "win_length": 405},      # odd, 3s
           "n_fft_401": {"n_fft": 401, "win_length": 401},      # odd prime
           "n_fft_6": {"n_fft": 6, "win_length": 6, "n_mels": 8},
           "n_fft_4096": {"n_fft": 4096, "win_length": 4096}}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_run_equals_rfft(name):
    cfg = dataclasses.replace(MelConfig(), **CONFIGS[name])
    plan = melspec.fft_plan(cfg)
    n = cfg.n_fft
    assert np.prod(plan.radices) == melspec.fft_size(n)
    assert list(plan.radices) == sorted(plan.radices)   # ascending
    # the window, centred when win_length < n_fft, is the reference's
    jc, _, _ = _windowed_dft_mats(JMelConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(plan.window, jc[:, 0], rtol=0, atol=1e-7)
    frames = _frames(cfg, seed=n)
    want = np.fft.rfft(frames.astype(np.float64) * plan.window.astype(np.float64),
                       axis=-1)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    got = run_plan(frames, plan)
    assert (np.abs(got - want[:, plan.bin_lo:plan.bin_hi]) <= FFT_REL * scale).all()
    # every bin, the edge bins 0 and n/2 (or (n-1)/2) included
    got = run_plan(frames, plan, np.arange(n // 2 + 1))
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
        # a band with no bins (n_fft 6) sums none
        assert hi == lo or plan.bin_lo <= lo and hi <= plan.bin_hi
    # the default config leaves out bins 0 and n/2: they weigh nothing
    if name == "default":
        assert plan.bin_lo >= 1 and plan.bin_hi <= cfg.n_fft // 2


@pytest.mark.parametrize("n_fft", [1000, 3, 0])
def test_plan_refuses_other_sizes(n_fft):
    """Every n_fft one frame of the kernel fits has a plan (1000: radices
    4 5 5 5; 3: one radix-3 stage); 0 and an n_fft past the largest, odd
    or even, are refused before any launch, naming the block's limit."""
    for too_large in (melspec.largest_n_fft() + 1, melspec.largest_n_fft() + 2):
        with pytest.raises(ValueError, match="227 KB"):
            melspec.fft_plan(_cfg(too_large))
    if n_fft == 0:
        with pytest.raises(ValueError, match="n_fft >= 1"):
            melspec.fft_plan(_cfg(n_fft))
    else:
        plan = melspec.fft_plan(_cfg(n_fft))
        assert plan.radices == {1000: (4, 5, 5, 5), 3: (3,)}[n_fft]


@pytest.mark.parametrize("n_fft,fpb,shared,at_3000",
                         [(4096, 4, True, (2, True)),
                          (8192, 1, True, (1, True)),
                          (None, 1, False, (1, False))],
                         ids=["4096", "8192", "largest"])
def test_layout_fits_a_block(n_fft, fpb, shared, at_3000):
    """Frames a block and where the buffers and tables live: the most that
    fit the 227 KB a block may opt in to, the segment counted at the largest
    hop a config frames at, and at a hop of 3000; the largest n_fft (58112:
    one frame, buffers and tables in device memory, its samples alone in
    shared memory) fits and the next does not."""
    n = melspec.largest_n_fft() if n_fft is None else n_fft
    cfg = _cfg(n)
    melspec.fft_plan(cfg)
    hop = max(cfg.hop_length, cfg.max_hop_length)
    assert melspec.block_layout(n, hop) == (fpb, shared)
    limit = 227 * 1024
    smem = melspec.mel_smem(n, fpb, hop, shared)
    assert smem == 4 * ((4 * fpb * melspec.fft_size(n) + 3 * n) * shared
                        + (fpb - 1) * hop + n) <= limit
    bigger = 2 * fpb if shared else 1        # the next layout up, all shared
    assert melspec.mel_smem(n, bigger, hop, True) > limit
    if n_fft is None:
        assert n == 58112 and melspec.mel_smem(n + 1, 1, hop, False) > limit
    # a call framing at a larger hop than the config's gets its own layout
    assert melspec.block_layout(n, 3000) == at_3000


@pytest.mark.parametrize("n_fft", [400, 448, 401])
def test_plan_log_mel_matches_jax(n_fft):
    """The plan's bins through the band sums and log, as the kernel does
    them, against the Pallas kernel in interpret mode and the XLA path, on
    reflect-padded frames of one row."""
    cfg = _cfg(n_fft)
    jcfg = JMelConfig(**dataclasses.asdict(cfg))
    plan = melspec.fft_plan(cfg)
    # 4 frames (the interpreted kernel's cost grows with them); 100 samples
    # past 3 hops, so an odd n_fft's last frame lies inside the padded row
    # (the Pallas kernel refuses a slice past it)
    nf = 4
    wav = (np.random.RandomState(n_fft).randn(1, (nf - 1) * cfg.hop_length
                                              + 100) * 0.3).astype(np.float32)
    x = np.pad(wav[0], n_fft // 2, mode="reflect")
    frames = np.stack([x[f * cfg.hop_length:f * cfg.hop_length + n_fft]
                       for f in range(nf)])
    spec = run_plan(frames, plan)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    mel = np.zeros((nf, cfg.n_mels), np.float32)
    for m in range(cfg.n_mels):
        lo, hi = plan.band_lo[m], plan.band_hi[m]
        mel[:, m] = power[:, lo - plan.bin_lo:hi - plan.bin_lo] \
            @ plan.weights[m, :hi - lo]
    got = np.log(mel + cfg.log_eps)
    with jax.default_matmul_precision("highest"):
        xla = np.asarray(jax_log_mel(jnp.asarray(wav), jcfg))[0]
        pal = np.asarray(log_mel_spectrogram_pallas(
            jnp.asarray(wav), jcfg, interpret=True))[0]
    assert got.shape == xla.shape == pal.shape == (nf, cfg.n_mels)
    np.testing.assert_allclose(got, xla, atol=LOG_ATOL, rtol=0)
    np.testing.assert_allclose(got, pal, atol=LOG_ATOL, rtol=0)
