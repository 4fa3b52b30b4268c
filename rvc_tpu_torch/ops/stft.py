"""Magnitude STFT (the part of ``rvc_tpu/ops/stft.py`` RMVPE uses):
periodic Hann window, optional centered reflect padding,
sqrt(re^2 + im^2 + eps) magnitude, time-major [B, frames, bins] output."""

from __future__ import annotations

from typing import Optional

import torch

MAG_EPS = 1e-6


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window's default)."""
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / win_length)).float()


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
    frames = y.unfold(-1, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + eps)
