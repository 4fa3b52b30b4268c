"""Harmonic sine excitation for the vocoders (port of
``rvc_tpu/models/generators/sine.py``).

``SineGenerator`` (NSF HiFi-GAN): per-frame phase on the upsample grid; the
per-frame advance is wrapped to [-0.5, 0.5], accumulated with a cumulative
sum and wrapped again (cumsum then mod), so the float32 phase stays bounded
over long outputs exactly as in the JAX module. ``CumsumSineGenerator``
(MRF HiFi-GAN, RefineGAN): per-sample increments at the audio rate,
accumulated by the blocked ``wrapped_phase_cumsum``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..commons import draw


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
            rand_phase = draw("rand", (b, 1, n_waves), generator, f0.device)
            rand_phase[..., 0] = 0.0
            phase = phase + rand_phase
        sine = torch.sin(2.0 * torch.pi * phase) * self.sine_amplitude
        uv = (f0 > self.voiced_threshold).float()
        uv = torch.repeat_interleave(uv, upp, dim=1)
        noise_amp = uv * self.noise_stddev + (1.0 - uv) * (self.sine_amplitude / 3.0)
        if self.zero_noise:
            noise = torch.zeros_like(sine)
        else:
            noise = noise_amp * draw("randn", sine.shape, generator,
                                     sine.device)
        return sine * uv + noise, uv, noise


def wrapped_phase_cumsum(rad: torch.Tensor, frame: int = 1024) -> torch.Tensor:
    """mod(cumsum(rad), 1) over time, blocked so that float32 stays exact
    over long outputs: a cumulative sum within frames of ``frame`` samples,
    each frame's total wrapped and carried into the frames after it, and
    everything reduced mod 1 (one ``cumsum`` over minutes of audio drifts
    by audible fractions of a cycle).

    rad [B, T, D] per-sample phase increments in cycles -> phase in [0, 1)
    of the same shape."""
    b, t, d = rad.shape
    pad = (-t) % frame
    if pad:
        rad = torch.nn.functional.pad(rad, (0, 0, 0, pad))
    nf = rad.shape[1] // frame
    intra = torch.cumsum(rad.reshape(b, nf, frame, d), dim=2)
    totals = torch.remainder(intra[:, :, -1, :], 1.0)                # [B, nf, D]
    carry = torch.remainder(torch.cumsum(totals, dim=1), 1.0)
    carry = torch.nn.functional.pad(carry[:, :-1, :], (0, 0, 1, 0))  # exclusive
    phase = torch.remainder(torch.remainder(intra, 1.0) + carry[:, :, None, :], 1.0)
    return phase.reshape(b, nf * frame, d)[:, :t, :]


class CumsumSineGenerator(nn.Module):
    """Sine bank at the sample rate (the MRF HiFi-GAN and RefineGAN
    sources): per-sample increments f0 / sr accumulated by
    ``wrapped_phase_cumsum``, a random initial phase per harmonic drawn
    from the caller's generator (the fundamental keeps phase 0; nothing is
    drawn with ``zero_noise``), the voiced mask and its noise. Computes in
    float32 whatever the decoder's dtype."""

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

    def forward(self, f0: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """f0 [B, T, 1] at the sample rate -> (sines [B, T, H+1], uv, noise)."""
        f0 = f0.float()
        n_waves = self.num_harmonics + 1
        harmonic_scale = torch.arange(1, n_waves + 1, dtype=torch.float32,
                                      device=f0.device)[None, None, :]
        rad = torch.remainder(f0 * harmonic_scale / self.sampling_rate, 1.0)
        if not self.zero_noise:
            rand_ini = draw("rand", (f0.shape[0], 1, n_waves), generator,
                            f0.device)
            rand_ini[..., 0] = 0.0
            rad = torch.cat([rad[:, :1] + rand_ini, rad[:, 1:]], dim=1)
        phase = wrapped_phase_cumsum(rad)
        sine = torch.sin(2.0 * torch.pi * phase) * self.sine_amplitude
        uv = (f0 > self.voiced_threshold).float()
        noise_amp = uv * self.noise_stddev + (1.0 - uv) * (self.sine_amplitude / 3.0)
        if self.zero_noise:
            noise = torch.zeros_like(sine)
        else:
            noise = noise_amp * draw("randn", sine.shape, generator,
                                     sine.device)
        return sine * uv + noise, uv, noise
