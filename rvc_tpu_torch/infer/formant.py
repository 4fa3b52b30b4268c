"""Formant shifting on the device (port of ``rvc_tpu/infer/formant.py``).

Cepstral envelope/excitation split: lifter the log magnitude at the
quefrency cutoff, warp the envelope's frequency axis by the timbre factor,
recombine it with the excitation and the original phases. The STFT pair is
scipy's (``ops/sps_stft.py``); each step runs in the dtype numpy runs it in
(float32 spectra of a float32 signal, the float64 lifter and warp).
"""

from __future__ import annotations

import torch

from ..ops.sps_stft import istft, stft


def formant_shift(audio: torch.Tensor, sr: int, quefrency_ms: float = 1.0,
                  timbre: float = 1.0, n_fft: int = 1024) -> torch.Tensor:
    """Warp the spectral envelope by ``timbre``: env'(f) = env(f / timbre),
    so timbre > 1 moves the formants up. A [T] tensor in, a float32 [T]
    tensor out on the same device."""
    audio = audio.to(torch.float32)
    if abs(timbre - 1.0) < 1e-6:
        return audio
    hop = n_fft // 4
    z = stft(audio, n_fft, hop)
    phase = torch.angle(z)
    logm = torch.log(torch.clamp(torch.abs(z), min=1e-10))
    ceps = torch.fft.irfft(logm, dim=0)
    cutoff = max(1, int(quefrency_ms * 1e-3 * sr))
    n_q = ceps.shape[0]
    lifter = torch.zeros(n_q, 1, dtype=torch.float64, device=audio.device)
    lifter[:cutoff] = 1.0
    if cutoff > 1:  # cutoff == 1: `[-0:]` would select every bin, not none
        lifter[-(cutoff - 1):] = 1.0  # the symmetric low-quefrency window
    env_log = torch.fft.rfft(ceps * lifter, dim=0).real
    exc_log = logm - env_log

    n_bins = env_log.shape[0]
    src = torch.arange(n_bins, dtype=torch.float64, device=audio.device) / timbre
    lo = torch.clamp(torch.floor(src).long(), 0, n_bins - 1)
    hi = torch.clamp(lo + 1, 0, n_bins - 1)
    frac = (src - lo)[:, None]
    env_warp = env_log[lo] * (1 - frac) + env_log[hi] * frac

    y = istft(torch.exp(env_warp + exc_log) * torch.exp(1j * phase), n_fft,
              hop)[:audio.shape[0]]
    y = torch.nn.functional.pad(y, (0, audio.shape[0] - y.shape[0]))
    return y.to(torch.float32)
