"""STFT, spectrogram and mel ops (port of ``rvc_tpu/ops/stft.py``).

Numerics mirror the JAX package's (and the reference torch pipeline's):
  - ``spectrogram``: reflect-pad by (n_fft - hop)/2, non-centered STFT with
    a periodic Hann window, sqrt(re^2 + im^2 + 1e-6) magnitude;
  - ``spec_to_mel``: slaney mel filterbank product and a log clamped at 1e-5;
  - ``multiscale_mel_window``: the multi-scale mel loss's window sizes.

Waveforms are [B, T]; spectrograms are time-major [B, frames, bins].
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from .mel import mel_filterbank

MAG_EPS = 1e-6
LOG_CLAMP = 1e-5


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window's default)."""
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / win_length)).float()


def frame_signal(y: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """Slice [B, T] into overlapping frames [B, n_frames, frame_length]
    (a strided view; its gradient is the overlap-add)."""
    return y.unfold(-1, frame_length, hop_length)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: Optional[int] = None, center: bool = False,
                   eps: float = MAG_EPS) -> torch.Tensor:
    """Magnitude STFT of [B, T] -> [B, n_frames, n_fft // 2 + 1]."""
    win_length = win_length or n_fft
    y = y.float()
    if center:
        pad = n_fft // 2
        y = torch.nn.functional.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    window = hann_window(win_length, y.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(window, (lpad, n_fft - win_length - lpad))
    frames = frame_signal(y, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + eps)


def spectrogram(y: torch.Tensor, n_fft: int, hop_length: int,
                win_length: int) -> torch.Tensor:
    """Linear spectrogram with the reference's edge padding: T % hop == 0
    gives exactly T // hop frames."""
    pad = (n_fft - hop_length) // 2
    y = torch.nn.functional.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    return stft_magnitude(y, n_fft, hop_length, win_length, center=False)


@functools.lru_cache(maxsize=64)
def mel_basis(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
              fmax: Optional[float], device: torch.device) -> torch.Tensor:
    """The slaney filterbank transposed, [bins, n_mels] float32 on
    ``device`` (built once per configuration and device)."""
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    return torch.from_numpy(fb.T.copy()).to(device)


def spec_to_mel(spec: torch.Tensor, n_fft: int, n_mels: int, sample_rate: int,
                fmin: float = 0.0, fmax: Optional[float] = None) -> torch.Tensor:
    """Project [B, frames, bins] magnitude onto log-mel [B, frames, n_mels]."""
    fb = mel_basis(sample_rate, n_fft, n_mels, fmin, fmax, spec.device)
    return torch.log(torch.clamp(spec.float() @ fb, min=LOG_CLAMP))


def mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int, sample_rate: int,
                    hop_length: int, win_length: int, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> torch.Tensor:
    """Log-mel spectrogram [B, frames, n_mels] (reference parity path)."""
    spec = spectrogram(y, n_fft, hop_length, win_length)
    return spec_to_mel(spec, n_fft, n_mels, sample_rate, fmin, fmax)


@dataclass(frozen=True)
class MelSpec:
    """One STFT/mel configuration; callable on [B, T] waveforms."""

    sample_rate: int
    n_fft: int
    hop_length: int
    win_length: int
    n_mels: int
    fmin: float = 0.0
    fmax: Optional[float] = None

    def linear(self, y: torch.Tensor) -> torch.Tensor:
        return spectrogram(y, self.n_fft, self.hop_length, self.win_length)

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        return mel_spectrogram(y, self.n_fft, self.n_mels, self.sample_rate,
                               self.hop_length, self.win_length, self.fmin,
                               self.fmax)


def multiscale_mel_window(n_mels: int, sample_rate: int) -> int:
    """Window size of the multi-scale mel loss (reference
    compute_window_length): the power of two at or below 8 * n_mels /
    (sr / 2) seconds of samples."""
    window_length = int(8 * n_mels / (sample_rate / 2) * sample_rate)
    return 2 ** (window_length.bit_length() - 1)
