"""Audio analyzer: spectral statistics and an optional plot (port of
``rvc_tpu/utils/analyzer.py``).

The statistics are computed in torch on the caller's device (the card by
default): a centered, reflect-padded STFT (n_fft 1024, hop 256, periodic
Hann) in float64, then the spectral centroid, 85% roll-off and bandwidth
per frame, averaged, with the zero-crossing rate, RMS and peak levels. The
plot is drawn only when ``matplotlib`` imports.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .audio_io import load_audio

STAT_KEYS = ("duration_seconds", "rms_db", "peak_db", "spectral_centroid_hz",
             "spectral_rolloff_hz", "spectral_bandwidth_hz",
             "zero_crossing_rate_hz")


def analyze_audio(input_path: str, save_plot_path: Optional[str] = None,
                  sr: int = 16000, device: Union[str, torch.device] = "cuda"
                  ) -> Tuple[Dict[str, float], Optional[str]]:
    """(the seven statistics, the plot's path or None) of an audio file."""
    dev = resolve_device(device)
    audio = load_audio(input_path, sr)
    x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev).double()
    n_fft, hop = 1024, 256
    y = torch.nn.functional.pad(x[None, None], (n_fft // 2, n_fft // 2),
                                mode="reflect")[0, 0]
    n = torch.arange(n_fft, dtype=torch.float64, device=dev)
    win = 0.5 - 0.5 * torch.cos(2 * math.pi * n / n_fft)
    spec = torch.abs(torch.fft.rfft(y.unfold(0, n_fft, hop) * win, dim=1))
    freqs = torch.fft.rfftfreq(n_fft, 1.0 / sr, dtype=torch.float64, device=dev)

    power = spec ** 2
    total = power.sum(dim=1) + 1e-12
    centroid = (power * freqs).sum(dim=1) / total
    reached = torch.cumsum(power, dim=1) >= 0.85 * total[:, None]
    rolloff = freqs[torch.argmax(reached.to(torch.uint8), dim=1)]
    bandwidth = torch.sqrt((power * (freqs - centroid[:, None]) ** 2).sum(dim=1)
                           / total)
    crossings = torch.abs(torch.diff(torch.signbit(x).to(torch.int8)))
    values = torch.stack([
        20 * torch.log10(torch.sqrt(torch.mean(x ** 2)) + 1e-12),
        20 * torch.log10(torch.abs(x).max() + 1e-12),
        centroid.mean(), rolloff.mean(), bandwidth.mean(),
        crossings.double().mean() * sr / 2]).cpu().tolist()
    stats = dict(zip(STAT_KEYS, [len(audio) / sr, *values]))

    plot_path = None
    if save_plot_path:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError as e:
            print(f"plot skipped ({e})")
        else:
            fig, axes = plt.subplots(2, 1, figsize=(12, 6))
            axes[0].plot(np.arange(len(audio)) / sr, audio, linewidth=0.4)
            axes[0].set_title("waveform")
            db = 20 * torch.log10(spec.T + 1e-6).cpu().numpy()
            axes[1].imshow(db, origin="lower", aspect="auto",
                           extent=[0, len(audio) / sr, 0, sr / 2])
            axes[1].set_title("spectrogram (dB)")
            fig.tight_layout()
            fig.savefig(save_plot_path, dpi=120)
            plt.close(fig)
            plot_path = save_plot_path

    for k, v in stats.items():
        print(f"{k}: {v:.3f}")
    return stats, plot_path
