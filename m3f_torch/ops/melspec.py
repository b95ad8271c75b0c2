"""Log-mel frontend: host constants, the plain PyTorch version, the kernel.

Counterpart of ``m3f/pytorch_tpu/ops/melspec.py`` (host constants, the plain
rFFT path, static reflect-pad and dynamic-hop framing) and of
``ops/pallas/melspec_pallas.py`` (the fused kernel, here ``csrc/melspec.cu``):

    framing → Hann window → real DFT → |·|² → mel filterbank → log

``log_mel_spectrogram`` is the one entry point: on a CPU tensor it runs the
plain ``log_mel_spectrogram_reference`` (``torch.fft.rfft``); on a CUDA
tensor it launches a kernel, which frames straight from the wav rows
(reflection in index space, no padded copy) and supports the per-row hop,
so the port needs no fixed-hop fallback. For an ``n_fft`` that is a power
of two (at least 4) the kernel does the real DFT as an FFT in shared memory
whose host constants are ``fft_plan``; for any other ``n_fft`` a second
kernel does it as a product with window-folded DFT bases
(``windowed_dft_mats``), as the TPU kernel does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from m3f_torch.config import MelConfig
from m3f_torch.ops import cuda_lib

_BINS_PER_PASS = 256   # the DFT route's pass width (csrc/melspec.cu DFT_NB)

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

    A frame of n_fft real samples x goes through one n_fft/2-point complex
    FFT of z[n] = w[2n]·x[2n] + i·w[2n+1]·x[2n+1] in Stockham stages of
    ``radices`` (in order), then the real split
    X[k] = (Z[k] + Z*[N-k])/2 − i·e[k]·(Z[k] − Z*[N-k])/2, N = n_fft/2,
    for the bins ``[bin_lo, bin_hi)`` that some band weighs; band m sums
    bins ``[band_lo[m], band_hi[m])`` with ``weights[m, k - band_lo[m]]``.
    e[k] = ``twiddles[k]`` = exp(−2πik/n_fft); the FFT's twiddles are
    e[2m]."""
    window: np.ndarray       # [n_fft] fp32, centred in n_fft (librosa)
    twiddles: np.ndarray     # [n_fft, 2] fp32 (re, im), from float64
    radices: Tuple[int, ...]
    band_lo: np.ndarray      # [n_mels] int32
    band_hi: np.ndarray      # [n_mels] int32
    weights: np.ndarray      # [n_mels, width] fp32, zero past a band's range
    bin_lo: int
    bin_hi: int


def fft_route(cfg: MelConfig) -> bool:
    """Whether the card takes the FFT kernel for ``cfg`` (n_fft a power of
    two, at least 4); else the DFT-product kernel."""
    n = cfg.n_fft
    return n >= 4 and not n & (n - 1)


@functools.lru_cache(maxsize=8)
def fft_plan(cfg: MelConfig) -> MelFftPlan:
    """The kernel's plan for ``cfg``; n_fft must be a power of two (at
    least 4): the kernel has no other FFT."""
    n = cfg.n_fft
    if not fft_route(cfg):
        raise ValueError(f"the log-mel kernel's FFT needs n_fft a power of "
                         f"two, at least 4; got {n}")
    log2n = n.bit_length() - 2               # log2 of the complex FFT's size
    radices = (2,) * (log2n & 1) + (4,) * (log2n // 2)
    ang = -2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    fb = mel_filterbank(cfg)                             # [n/2 + 1, n_mels]
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
    return MelFftPlan(_padded_window(cfg), tw, radices, lo, hi, weights,
                      bin_lo, bin_hi)


@functools.lru_cache(maxsize=8)
def _device_plan(cfg: MelConfig, device: torch.device):
    p = fft_plan(cfg)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (p.window, p.twiddles, p.band_lo, p.band_hi,
                           p.weights))


@functools.lru_cache(maxsize=8)
def windowed_dft_mats(cfg: MelConfig):
    """(C', S', fb', lo): the DFT route's window-folded bases over the bins
    the mel filterbank weighs, and the matching filterbank rows.

    Bins outside ``[lo, hi]`` (the first and last bins with a non-zero
    filter weight) add exactly zero to every mel sum, so they are left out;
    the kept bins are zero-padded to a multiple of the kernel's pass width.
    C'[k, i] = win[k]·cos(-2πk(lo+i)/n), S' likewise with sin, both
    [n_fft, nbp] float32; fb' [nbp, n_mels].
    """
    n = cfg.n_fft
    fb = mel_filterbank(cfg)
    nz = np.nonzero(fb.any(axis=1))[0]
    lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (0, 0)
    nb = hi - lo + 1
    nbp = -(-nb // _BINS_PER_PASS) * _BINS_PER_PASS
    win = _padded_window(cfg).astype(np.float64)
    k = np.arange(n, dtype=np.float64)[:, None]
    b = np.arange(lo, hi + 1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * k * b / n
    c = np.zeros((n, nbp), np.float32)
    s = np.zeros((n, nbp), np.float32)
    c[:, :nb] = win[:, None] * np.cos(ang)
    s[:, :nb] = win[:, None] * np.sin(ang)
    fbp = np.zeros((nbp, fb.shape[1]), np.float32)
    fbp[:nb] = fb[lo:hi + 1]
    return c, s, fbp, lo


@functools.lru_cache(maxsize=8)
def _device_mats(cfg: MelConfig, device: torch.device):
    c, s, fbp, _ = windowed_dft_mats(cfg)
    return tuple(torch.from_numpy(a).to(device) for a in (c, s, fbp))


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
        frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :num_frames(t, cfg)]
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
    frames = (x.data_ptr(), n_rows, t, n_fr,
              None if hops is None else hops.data_ptr(), hop0, end0, left,
              hop_max)
    lib = cuda_lib.library("melspec")
    with torch.cuda.device(x.device):
        if fft_route(cfg):
            plan = fft_plan(cfg)
            win, tw, band_lo, band_hi, weights = _device_plan(cfg, x.device)
            err = lib.m3f_log_mel(
                *frames, win.data_ptr(), tw.data_ptr(), band_lo.data_ptr(),
                band_hi.data_ptr(), weights.data_ptr(), weights.shape[1],
                plan.bin_lo, plan.bin_hi, cfg.n_fft, cfg.n_mels, cfg.log_eps,
                out.data_ptr(), int(out_dtype == torch.bfloat16),
                cuda_lib.stream_ptr(x))
            counter = "melspec"
        else:
            c, s, fbp = _device_mats(cfg, x.device)
            err = lib.m3f_log_mel_dft(
                *frames, c.data_ptr(), s.data_ptr(), fbp.data_ptr(),
                fbp.shape[0], cfg.n_fft, cfg.n_mels, cfg.log_eps,
                out.data_ptr(), int(out_dtype == torch.bfloat16),
                cuda_lib.stream_ptr(x))
            counter = "melspec_dft"
    cuda_lib.check(err, f"log_mel_spectrogram {counter} kernel")
    cuda_lib.launches[counter] += 1
    return out.reshape(lead + (n_fr, cfg.n_mels))
