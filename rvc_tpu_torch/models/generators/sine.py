"""Harmonic sine excitation for NSF vocoders (port of
``rvc_tpu/models/generators/sine.py``'s ``SineGenerator``).

Per-frame phase on the upsample grid; the per-frame advance is wrapped to
[-0.5, 0.5], accumulated with a cumulative sum and wrapped again (cumsum
then mod), so the float32 phase stays bounded over long outputs exactly as
in the JAX module."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class SineGenerator(nn.Module):
    def __init__(self, sampling_rate: int, num_harmonics: int = 0,
                 sine_amplitude: float = 0.1, noise_stddev: float = 0.003,
                 voiced_threshold: float = 0.0, zero_noise: bool = False):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.num_harmonics = num_harmonics
        self.sine_amplitude = sine_amplitude
        self.noise_stddev = noise_stddev
        self.voiced_threshold = voiced_threshold
        self.zero_noise = zero_noise

    def forward(self, f0: torch.Tensor, upsampling_factor: int,
                generator: Optional[torch.Generator] = None):
        """f0 [B, L] (float32) -> (sines [B, L*upp, H+1], uv, noise)."""
        b, length = f0.shape
        upp = upsampling_factor
        n_waves = self.num_harmonics + 1
        f0 = f0.float()[..., None]                                  # [B, L, 1]
        grid = torch.arange(1, upp + 1, dtype=torch.float32,
                            device=f0.device)[None, None, :]
        phase = (f0 / self.sampling_rate) * grid                    # [B, L, upp]
        frame_adv = torch.remainder(phase[:, :-1, -1:] + 0.5, 1.0) - 0.5
        cum = torch.remainder(torch.cumsum(frame_adv, dim=1), 1.0)
        phase = phase + torch.nn.functional.pad(cum, (0, 0, 1, 0))
        phase = phase.reshape(b, length * upp, 1)
        harmonic_scale = torch.arange(1, n_waves + 1, dtype=torch.float32,
                                      device=f0.device)[None, None, :]
        phase = phase * harmonic_scale
        if n_waves > 1 and not self.zero_noise:
            rand_phase = torch.rand((b, 1, n_waves), generator=generator,
                                    device=f0.device)
            rand_phase[..., 0] = 0.0
            phase = phase + rand_phase
        sine = torch.sin(2.0 * torch.pi * phase) * self.sine_amplitude
        uv = (f0 > self.voiced_threshold).float()
        uv = torch.repeat_interleave(uv, upp, dim=1)
        noise_amp = uv * self.noise_stddev + (1.0 - uv) * (self.sine_amplitude / 3.0)
        if self.zero_noise:
            noise = torch.zeros_like(sine)
        else:
            noise = noise_amp * torch.randn(sine.shape, generator=generator,
                                            device=sine.device)
        return sine * uv + noise, uv, noise
