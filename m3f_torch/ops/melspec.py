"""Log-mel frontend: host constants, the plain PyTorch version, the kernel.

Counterpart of ``m3f/pytorch_tpu/ops/melspec.py`` (host constants, the plain
rFFT path, static reflect-pad and dynamic-hop framing) and of
``ops/pallas/melspec_pallas.py`` (the fused kernel, here ``csrc/melspec.cu``):

    framing → Hann window → real DFT → |·|² → mel filterbank → log

``log_mel_spectrogram`` is the one entry point: on a CPU tensor it runs the
plain ``log_mel_spectrogram_reference`` (``torch.fft.rfft``); on a CUDA
tensor it launches one kernel, which frames straight from the wav rows
(reflection in index space, no padded copy), supports the per-row hop, so
the port needs no fixed-hop fallback, and does the real DFT of any
``n_fft`` as a mixed-radix FFT whose host constants are ``fft_plan`` and
whose launch layout is ``block_layout``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from m3f_torch.config import MelConfig
from m3f_torch.ops import cuda_lib

SMEM_BLOCK_MAX = 227 << 10   # a block's shared memory on sm_90 (opt-in)
_FRAMES_PER_BLOCK = (8, 4, 2, 1)

# ---------------------------------------------------------------------------
# Host-side constants (numpy, computed once per config)
# ---------------------------------------------------------------------------

def hz_to_mel(hz, scale: str = "slaney"):
    hz = np.asarray(hz, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + hz / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (hz - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(hz >= min_log_hz,
                    min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep,
                    mel)


def mel_to_hz(mel, scale: str = "slaney"):
    mel = np.asarray(mel, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    hz = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)),
                    hz)


@functools.lru_cache(maxsize=8)
def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """Triangular mel filterbank, shape [n_fft//2 + 1, n_mels], float32
    (librosa.filters.mel(htk=False, norm='slaney') up to float error)."""
    n_bins = cfg.n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, n_bins)
    mel_min = hz_to_mel(cfg.fmin, cfg.mel_scale)
    mel_max = hz_to_mel(cfg.fmax, cfg.mel_scale)
    mel_pts = np.linspace(mel_min, mel_max, cfg.n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, cfg.mel_scale)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))

    if cfg.norm == "slaney":
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[:, None]
    return np.ascontiguousarray(fb.T, dtype=np.float32)


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann (librosa/scipy fftbins=True convention)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def num_frames(num_samples: int, cfg: MelConfig) -> int:
    if cfg.center:
        return 1 + num_samples // cfg.hop_length
    return 1 + (num_samples - cfg.n_fft) // cfg.hop_length


def _padded_window(cfg: MelConfig) -> np.ndarray:
    win = hann_window(cfg.win_length)
    if cfg.win_length < cfg.n_fft:  # centre-pad window to n_fft (librosa)
        lpad = (cfg.n_fft - cfg.win_length) // 2
        win = np.pad(win, (lpad, cfg.n_fft - cfg.win_length - lpad))
    return win


class MelFftPlan(NamedTuple):
    """The FFT kernel's host constants for one config (csrc/melspec.cu).

    A frame of n_fft real samples x goes through one N-point complex FFT in
    Stockham stages of ``radices`` (in order): for an even n_fft N = n_fft/2
    and z[j] = w[2j]·x[2j] + i·w[2j+1]·x[2j+1], then the real split
    X[k] = (Z[k] + Z*[N-k])/2 − i·e[k]·(Z[k] − Z*[N-k])/2; for an odd n_fft
    N = n_fft, z[j] = w[j]·x[j] and X[k] = Z[k]. Only the bins
    ``[bin_lo, bin_hi)`` that some band weighs are formed; band m sums bins
    ``[band_lo[m], band_hi[m])`` with ``weights[m, k - band_lo[m]]``.
    e[m] = ``twiddles[m]`` = exp(−2πim/n_fft); the FFT's twiddles w_N^m are
    e[2m] (even n_fft) or e[m] (odd). A call's launch layout is
    ``block_layout`` at its largest hop."""
    window: np.ndarray       # [n_fft] fp32, centred in n_fft (librosa)
    twiddles: np.ndarray     # [n_fft, 2] fp32 (re, im), from float64
    radices: Tuple[int, ...]
    band_lo: np.ndarray      # [n_mels] int32
    band_hi: np.ndarray      # [n_mels] int32
    weights: np.ndarray      # [n_mels, width] fp32, zero past a band's range
    bin_lo: int
    bin_hi: int


def fft_size(n_fft: int) -> int:
    """N, the complex FFT's size: n_fft/2 for an even n_fft (packed real
    FFT), n_fft for an odd one."""
    return n_fft if n_fft % 2 else n_fft // 2


def fft_radices(n: int) -> Tuple[int, ...]:
    """The stages of an n-point FFT, ascending: as many 4s as the power of
    two allows, one 2 where it is odd, then 3s, 5s and any other primes (a
    power of two: 2 first where log2 n is odd, then 4s)."""
    e2 = (n & -n).bit_length() - 1
    rad = [4] * (e2 // 2) + [2] * (e2 % 2)
    n >>= e2
    p = 3
    while p * p <= n:
        while n % p == 0:
            rad.append(p)
            n //= p
        p += 2
    if n > 1:
        rad.append(n)
    return tuple(sorted(rad))


def mel_smem(n_fft: int, frames_per_block: int, hop: int, shared: bool,
             n_frames: Optional[int] = None) -> int:
    """A block's shared memory (mel_smem in csrc/melspec.cu): where
    ``shared``, two complex buffers of ``frames_per_block`` frames of N
    points (the power reuses one), the twiddle table and the window (else
    all three live in device memory); always the segment its frames touch
    at ``hop`` (``n_frames`` bounds its frames)."""
    fpb = frames_per_block
    seg_frames = fpb if n_frames is None else max(1, min(n_frames, fpb))
    return 4 * ((4 * fpb * fft_size(n_fft) + 3 * n_fft if shared else 0)
                + (seg_frames - 1) * hop + n_fft)


@functools.lru_cache(maxsize=64)
def block_layout(n_fft: int, hop: int) -> Tuple[int, bool]:
    """(frames a block, buffers and tables in shared memory) at hops up to
    ``hop``: the most frames of 8, 4, 2, 1 whose block fits 227 KB with
    everything in shared memory, else one frame whose FFT buffers, twiddles
    and window are in device memory beside its segment in shared memory;
    raises where even the segment does not fit (n_fft > ``largest_n_fft``)."""
    if n_fft < 1:
        raise ValueError(f"the log-mel kernel needs n_fft >= 1, got {n_fft}")
    for fpb in _FRAMES_PER_BLOCK:
        if mel_smem(n_fft, fpb, hop, True) <= SMEM_BLOCK_MAX:
            return fpb, True
    if mel_smem(n_fft, 1, hop, False) > SMEM_BLOCK_MAX:
        raise ValueError(
            f"n_fft {n_fft} does not fit the log-mel kernel: one frame's "
            f"samples need {mel_smem(n_fft, 1, hop, False)} bytes of shared "
            f"memory, a block has {SMEM_BLOCK_MAX} (227 KB); the largest "
            f"n_fft is {largest_n_fft()}")
    return 1, False


def largest_n_fft() -> int:
    """The largest n_fft with a layout, even or odd: one frame a block, its
    4-byte samples alone in shared memory."""
    return SMEM_BLOCK_MAX // 4


@functools.lru_cache(maxsize=16)
def fft_plan(cfg: MelConfig) -> MelFftPlan:
    """The kernel's constants for ``cfg``; raises where no launch layout
    fits its n_fft."""
    n = cfg.n_fft
    block_layout(n, cfg.hop_length)
    ang = -2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    fb = mel_filterbank(cfg)                             # [n//2 + 1, n_mels]
    lo = np.zeros(cfg.n_mels, np.int32)
    hi = np.zeros(cfg.n_mels, np.int32)
    for m in range(cfg.n_mels):
        nz = np.nonzero(fb[:, m])[0]
        if len(nz):
            lo[m], hi[m] = nz[0], nz[-1] + 1
    width = max(1, int((hi - lo).max()))
    weights = np.zeros((cfg.n_mels, width), np.float32)
    for m in range(cfg.n_mels):
        weights[m, :hi[m] - lo[m]] = fb[lo[m]:hi[m], m]
    used = hi > lo
    bin_lo = int(lo[used].min()) if used.any() else 0
    bin_hi = int(hi[used].max()) if used.any() else 0
    return MelFftPlan(_padded_window(cfg), tw, fft_radices(fft_size(n)), lo,
                      hi, weights, bin_lo, bin_hi)


@functools.lru_cache(maxsize=16)
def _device_plan(cfg: MelConfig, device: torch.device):
    p = fft_plan(cfg)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (p.window, p.twiddles, p.band_lo, p.band_hi,
                           p.weights))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _frame_dynamic(x: torch.Tensor, hop: torch.Tensor, n_fft: int,
                   n_frames: int) -> torch.Tensor:
    """Per-example-hop centred framing [..., S] → [..., n_frames, n_fft].

    Reflection in index space about each example's own end
    T = (n_frames−1)·hop, so an example never reads the buffer's tail."""
    hop = hop.to(torch.int64)
    hop = hop.reshape(hop.shape + (1,) * (x.ndim - 1 - hop.ndim) + (1, 1))
    i = torch.arange(n_frames, device=x.device)[:, None]
    j = torch.arange(n_fft, device=x.device)[None, :]
    idx = (hop * i + (j - n_fft // 2)).abs()
    end = hop * (n_frames - 1) - 1
    idx = torch.where(idx > end, 2 * end - idx, idx)
    idx = idx.expand(x.shape[:-1] + (n_frames, n_fft))
    src = x.unsqueeze(-2).expand(x.shape[:-1] + (n_frames, x.shape[-1]))
    return torch.gather(src, -1, idx)


def log_mel_spectrogram_reference(waveform: torch.Tensor, cfg: MelConfig,
                                  out_dtype: torch.dtype = torch.float32,
                                  hop=None, n_frames_out: Optional[int] = None
                                  ) -> torch.Tensor:
    """[..., num_samples] wav → [..., n_frames, n_mels] log-mel via rFFT,
    fp32 throughout; ``hop`` (int or int tensor broadcastable over the
    leading dims) selects the per-example dynamic-hop framing."""
    x = waveform.float()
    t = x.shape[-1]
    if hop is not None:
        if not cfg.center or n_frames_out is None:
            raise ValueError("dynamic hop needs cfg.center and n_frames_out")
        frames = _frame_dynamic(x, torch.as_tensor(hop, device=x.device),
                                cfg.n_fft, n_frames_out)
    else:
        lead = x.shape[:-1]
        x = x.reshape(-1, t)
        if cfg.center:
            x = F.pad(x, (cfg.n_fft // 2, cfg.n_fft // 2), mode="reflect")
        n_fr = num_frames(t, cfg)
        # an odd n_fft's last frame can reach one sample past the padded
        # row: it reads the last one again, as the reference's gather does
        short = (n_fr - 1) * cfg.hop_length + cfg.n_fft - x.shape[-1]
        if short > 0:
            x = F.pad(x, (0, short), mode="replicate")
        frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :n_fr]
        frames = frames.reshape(lead + frames.shape[1:])
    win = torch.from_numpy(_padded_window(cfg)).to(x.device)
    spec = torch.fft.rfft(frames * win, n=cfg.n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filterbank(cfg)).to(x.device)
    mel = torch.matmul(power, fb)
    return torch.log(mel + cfg.log_eps).to(out_dtype)


# ---------------------------------------------------------------------------
# Entry point: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def row_hops(hop: torch.Tensor, lead) -> torch.Tensor:
    """One hop per row of a ``[*lead, samples]`` wav, contiguous: ``hop``
    broadcast over the leading dims from the left, as the plain version's
    framing does (a batch's ``[B]`` hops over its ``[B, W]`` windows)."""
    hop = hop.reshape(hop.shape + (1,) * (len(lead) - hop.ndim))
    return hop.expand(tuple(lead)).reshape(-1).contiguous()


def log_mel_spectrogram(waveform: torch.Tensor, cfg: MelConfig,
                        out_dtype: torch.dtype = torch.float32,
                        hop: Union[None, int, torch.Tensor] = None,
                        n_frames_out: Optional[int] = None) -> torch.Tensor:
    """[..., num_samples] float wav → [..., n_frames, n_mels] log-mel.

    ``hop``: optional per-example mel hop (int, or an int tensor
    broadcastable over the leading dims) with ``n_frames_out`` frames and
    reflection about each example's own end; None frames the static
    ``cfg.hop_length`` path over a reflect-padded signal.
    """
    if waveform.device.type == "cpu":
        return log_mel_spectrogram_reference(waveform, cfg, out_dtype, hop,
                                             n_frames_out)
    cuda_lib.require_cuda("log_mel_spectrogram", waveform)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"log_mel_spectrogram kernel writes float32 or "
                         f"bfloat16, got {out_dtype}")
    plan = fft_plan(cfg)
    lead, t = waveform.shape[:-1], waveform.shape[-1]
    x = waveform.reshape(-1, t).float().contiguous()
    n_rows = x.shape[0]
    hops = None
    if hop is None:
        n_fr = num_frames(t, cfg)
        hop0, end0, hop_max = cfg.hop_length, t - 1, cfg.hop_length
        if cfg.center and t <= cfg.n_fft // 2:
            raise ValueError(f"reflect padding by {cfg.n_fft // 2} needs more "
                             f"than that many samples, got {t}")
    else:
        if not cfg.center or n_frames_out is None:
            raise ValueError("dynamic hop needs cfg.center and n_frames_out")
        n_fr = n_frames_out
        if isinstance(hop, torch.Tensor):
            hops = row_hops(hop.to(device=x.device, dtype=torch.int32), lead)
            hop0 = hop_max = int(hops.max())
        else:
            hop0 = hop_max = int(hop)
        end0 = hop0 * (n_fr - 1) - 1
    out = torch.empty((n_rows, n_fr, cfg.n_mels), dtype=out_dtype,
                      device=x.device)
    left = cfg.n_fft // 2 if cfg.center else 0
    # the static path reads no further than the padded row's last sample
    jmax = t - 1 + left if hop is None else 2 ** 31 - 1
    frames = (x.data_ptr(), n_rows, t, n_fr,
              None if hops is None else hops.data_ptr(), hop0, end0, left,
              jmax, hop_max)
    fpb, shared = block_layout(cfg.n_fft, hop_max)
    work, n_blocks = None, 0
    if not shared:
        # one frame a block, its FFT buffers in device memory: a grid of two
        # blocks an SM, each with its own two N-point complex buffers, walks
        # the (row, frame) pairs
        n_blocks = min(n_rows * n_fr, 2 * _sm_count(x.device))
        work = torch.empty((n_blocks, 2, fft_size(cfg.n_fft), 2),
                           dtype=torch.float32, device=x.device)
    win, tw, band_lo, band_hi, weights = _device_plan(cfg, x.device)
    radices = (ctypes.c_int * len(plan.radices))(*plan.radices)
    lib = cuda_lib.library("melspec")
    with torch.cuda.device(x.device):
        err = lib.m3f_log_mel(
            *frames, win.data_ptr(), tw.data_ptr(), ctypes.addressof(radices),
            len(plan.radices), band_lo.data_ptr(), band_hi.data_ptr(),
            weights.data_ptr(), weights.shape[1], plan.bin_lo, plan.bin_hi,
            cfg.n_fft, cfg.n_mels, cfg.log_eps, fpb, int(shared),
            mel_smem(cfg.n_fft, fpb, hop_max, shared, n_fr),
            None if work is None else work.data_ptr(), n_blocks,
            out.data_ptr(), int(out_dtype == torch.bfloat16),
            cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "log_mel_spectrogram melspec kernel")
    cuda_lib.launches["melspec"] += 1
    return out.reshape(lead + (n_fr, cfg.n_mels))
