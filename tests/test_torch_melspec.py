"""The port's log-mel frontend (m3f_torch/ops/melspec.py) against the JAX
package: the plain rFFT version against ``log_mel_spectrogram`` (static and
per-example hop) and ``log_mel_spectrogram_pallas`` in interpret mode, and
the CUDA kernel's host constants (its FFT plan) against the rFFT. Inputs
are numpy from a seed; tolerances are per test."""

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

CFG, JCFG = MelConfig(), JMelConfig()
SPW = 15 * CFG.hop_length                   # one window's static samples
SPW_MAX = 15 * CFG.max_hop_length           # the dynamic-hop buffer
FP32_ATOL = 1e-4                            # both fp32 rFFT; order only


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _wav(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 0.3).astype(np.float32)


def test_static_hop_matches_jax():
    wav = _wav((2, 3, SPW), 0)
    got = melspec.log_mel_spectrogram(torch.from_numpy(wav), CFG).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_log_mel(jnp.asarray(wav), JCFG))
    assert got.shape == want.shape == (2, 3, 16, CFG.n_mels)
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("hop", [640, [[600], [667]]], ids=["scalar", "per_example"])
def test_dynamic_hop_matches_jax(hop):
    wav = _wav((2, 3, SPW_MAX), 1)
    hop_np = np.asarray(hop, np.int32)
    got = melspec.log_mel_spectrogram(torch.from_numpy(wav), CFG,
                                      hop=torch.from_numpy(hop_np),
                                      n_frames_out=16).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_log_mel(jnp.asarray(wav), JCFG,
                                      hop=jnp.asarray(hop_np), n_frames_out=16))
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)


def test_nominal_dynamic_hop_equals_static():
    """At the nominal hop the index-space reflection gathers the static
    path's samples exactly (the reference's own invariant)."""
    wav = torch.from_numpy(_wav((2, SPW), 2))
    static = melspec.log_mel_spectrogram(wav, CFG)
    dyn = melspec.log_mel_spectrogram(wav, CFG, hop=CFG.hop_length,
                                      n_frames_out=16)
    np.testing.assert_array_equal(dyn.numpy(), static.numpy())


def test_matches_jax_pallas_kernel_interpret():
    wav = _wav((2, 3, SPW), 3)
    got = melspec.log_mel_spectrogram(torch.from_numpy(wav), CFG).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(wav), JCFG,
                                                     interpret=True))
    # DFT-as-matmul vs FFT round-off (tests/test_melspec_pallas.py:41)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-4)


def test_kernel_constants_reproduce_rfft_mel():
    """The CUDA kernel's inputs — its FFT plan (window, twiddles, stages,
    real split) over the bins the filterbank weighs, and each band's packed
    weights over its own bin range — give the plain version's log-mel
    (complex64 here, as the kernel's fp32)."""
    from test_torch_mel_fft_plan import run_plan
    plan = melspec.fft_plan(CFG)
    fb = melspec.mel_filterbank(CFG)
    dropped = np.ones(len(fb), bool)
    dropped[plan.bin_lo:plan.bin_hi] = False
    assert not fb[dropped].any()            # trimmed bins weigh exactly zero
    wav = _wav((1, SPW), 4)
    x = np.pad(wav[0], CFG.n_fft // 2, mode="reflect")
    frames = np.stack([x[f * CFG.hop_length:f * CFG.hop_length + CFG.n_fft]
                       for f in range(16)])
    spec = run_plan(frames, plan)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    mel = np.zeros((16, CFG.n_mels), np.float32)
    for m in range(CFG.n_mels):
        lo, hi = plan.band_lo[m], plan.band_hi[m]
        mel[:, m] = power[:, lo - plan.bin_lo:hi - plan.bin_lo] \
            @ plan.weights[m, :hi - lo]
    got = np.log(mel + CFG.log_eps)
    want = melspec.log_mel_spectrogram(torch.from_numpy(wav), CFG).numpy()[0]
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_cpu_tensor_takes_plain_version_and_out_dtype():
    wav = torch.from_numpy(_wav((4, SPW), 5))
    before = dict(cuda_lib.launches)
    out = melspec.log_mel_spectrogram(wav, CFG, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 16, CFG.n_mels)
    ref = melspec.log_mel_spectrogram_reference(wav, CFG)
    np.testing.assert_array_equal(out.float().numpy(),
                                  ref.to(torch.bfloat16).float().numpy())
    assert cuda_lib.launches == before      # no kernel on a CPU tensor
