"""Log-mel frontend of the plain reference: ``torch.stft`` and a Slaney mel
filterbank, float32.

A window's wav (``spw`` samples) is reflect-padded by n_fft // 2 at both
ends, framed every ``hop`` samples under a periodic Hann window, and its
power spectrum is summed into ``n_mels`` Slaney-normalised triangles
between ``fmin`` and ``fmax`` (librosa's ``filters.mel(htk=False)``); the
output is ``log(mel + log_eps)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _hz_to_mel(hz: np.ndarray) -> np.ndarray:
    """Slaney's scale: linear below 1 kHz, logarithmic above."""
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    lin = hz / f_sp
    log = min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep
    return np.where(hz >= min_log_hz, log, lin)


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)),
                    f_sp * mel)


def filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
               fmax: float) -> np.ndarray:
    """[n_fft // 2 + 1, n_mels] float32 Slaney-normalised triangles."""
    bins = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mels = np.linspace(_hz_to_mel(np.float64(fmin)),
                       _hz_to_mel(np.float64(fmax)), n_mels + 2)
    edges = _mel_to_hz(mels)
    out = np.zeros((n_mels, len(bins)))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        rise = (bins - lo) / (mid - lo)
        fall = (hi - bins) / (hi - mid)
        out[m] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return out.T.astype(np.float32)


def log_mel(wav: torch.Tensor, mel: dict) -> torch.Tensor:
    """[N, spw] float wav → [N, frames, n_mels] float32 log-mel, with
    frames = 1 + spw // hop_length."""
    if (mel["mel_scale"], mel["norm"], mel["center"]) != ("slaney", "slaney",
                                                         True):
        raise ValueError("the reference computes Slaney-scale, Slaney-"
                         "normalised, centred log-mel only")
    n_fft = mel["n_fft"]
    win = torch.hann_window(mel["win_length"], periodic=True,
                            dtype=torch.float32, device=wav.device)
    spec = torch.stft(wav.float(), n_fft=n_fft, hop_length=mel["hop_length"],
                      win_length=mel["win_length"], window=win, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2                 # [N, bins, frames]
    fb = torch.from_numpy(filterbank(mel["sample_rate"], n_fft, mel["n_mels"],
                                     mel["fmin"], mel["fmax"])).to(wav.device)
    return torch.log(power.transpose(1, 2) @ fb + mel["log_eps"])
