"""YIN fundamental-frequency estimation, no learned weights (port of
``rvc_tpu/predictors/dsp_f0.py``).

Frames the reflect-padded signal, takes the windowed difference function
through an FFT cross-correlation, normalizes it by its cumulative mean, and
picks the first period under the threshold (descending to the local
minimum within 1.5 times it; the global minimum when none crosses), refined
by parabolic interpolation. Every frame at once, on the tensor's device.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's ``np.pad(y, pad, mode="reflect")`` for a [T] tensor,
    reflecting again where ``pad`` exceeds the signal."""
    n = y.shape[0]
    if n == 1:
        return y.repeat(2 * pad + 1)
    period = 2 * (n - 1)
    idx = torch.abs(torch.arange(-pad, n + pad, device=y.device)) % period
    return y[torch.where(idx > n - 1, period - idx, idx)]


def yin_f0(audio: torch.Tensor, sample_rate: int = 16000, hop: int = 160,
           frame: int = 1024, fmin: float = 50.0, fmax: float = 1100.0,
           threshold: float = 0.15) -> torch.Tensor:
    """audio [T] -> f0 [T // hop + 1] in Hz (0 where unvoiced), float32."""
    dev = audio.device
    y = _reflect_pad(audio.float(), frame // 2)
    x = y.unfold(0, frame, hop)                                 # [n, frame]
    n_frames = x.shape[0]
    tau_max = int(sample_rate / fmin)
    tau_min = max(2, int(sample_rate / fmax))
    w = frame // 2

    # d(tau) = sum_{t<w} (x[t] - x[t+tau])^2; the cross term restricted to
    # the window: corr[tau] = irfft(conj(fft(x[:w])) * fft(x))
    xw = x * (torch.arange(frame, device=dev) < w)[None, :]
    fft_full = torch.fft.rfft(x, n=2 * frame, dim=-1)
    fft_win = torch.fft.rfft(xw, n=2 * frame, dim=-1)
    corr = torch.fft.irfft(torch.conj(fft_win) * fft_full, n=2 * frame,
                           dim=-1)[:, :w + 1]
    cumsq = torch.cumsum(x ** 2, dim=-1)
    e0 = cumsq[:, w - 1:w]
    taus = torch.arange(w + 1, device=dev)
    e_tau = cumsq[:, taus + w - 1] - torch.where(
        taus > 0, cumsq[:, torch.clamp(taus - 1, min=0)], 0.0)
    d = torch.clamp(e0 + e_tau - 2.0 * corr, min=0.0)           # [n, w+1]

    cum = torch.cumsum(d[:, 1:], dim=-1)
    tau_idx = torch.arange(1, w + 1, dtype=torch.float32, device=dev)
    cmnd = d[:, 1:] * tau_idx / torch.clamp(cum, min=1e-12)
    cmnd = torch.cat([torch.ones((n_frames, 1), device=dev), cmnd], dim=-1)

    rng_mask = (taus >= tau_min) & (taus <= min(tau_max, w))
    inf = torch.tensor(float("inf"), device=dev)
    masked = torch.where(rng_mask[None, :], cmnd, inf)
    under = masked < threshold
    any_under = torch.any(under, dim=-1)
    first_under = torch.argmax(under.to(torch.int32), dim=-1)
    global_min = torch.argmin(masked, dim=-1)
    c = first_under[:, None]
    descent = (taus[None, :] >= c) & (taus[None, :] <= c + c // 2 + 2)
    local_min = torch.argmin(
        torch.where(descent & rng_mask[None, :], cmnd, inf), dim=-1)
    tau = torch.where(any_under, local_min, global_min)

    tau_c = torch.clamp(tau, 1, w - 1)
    vals = torch.gather(cmnd, 1, torch.stack([tau_c - 1, tau_c, tau_c + 1], -1))
    a, b, cc = vals[:, 0], vals[:, 1], vals[:, 2]
    denom = a - 2 * b + cc
    shift = torch.where(torch.abs(denom) > 1e-12, 0.5 * (a - cc) / denom,
                        torch.zeros_like(denom))
    tau_f = tau_c.float() + torch.clamp(shift, -0.5, 0.5)

    f0 = sample_rate / torch.clamp(tau_f, min=1.0)
    best = torch.gather(cmnd, 1, tau[:, None])[:, 0]
    voiced = (best < 0.5) & (f0 >= fmin) & (f0 <= fmax)
    return torch.where(voiced, f0, torch.zeros_like(f0))


def yin_f0_np(audio: np.ndarray, device: Union[str, torch.device] = "cuda",
              **kw) -> np.ndarray:
    """``yin_f0`` of a numpy waveform, run on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(device)
    return yin_f0(x, **kw).cpu().numpy()
