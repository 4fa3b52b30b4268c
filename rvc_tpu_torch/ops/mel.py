"""Mel filterbank (librosa-compatible; port of ``rvc_tpu/ops/mel.py``): htk
or slaney mel scale, slaney norm, for RMVPE's front end and the training
mels."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np


def _hz_to_mel(freq, htk: bool):
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz, min_log_mel = 1000.0, 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels)


def _mel_to_hz(mels, htk: bool):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz, min_log_mel = 1000.0, 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False,
                   norm: Optional[str] = "slaney") -> np.ndarray:
    """Triangular mel filterbank, float32 [n_mels, n_fft // 2 + 1]."""
    if fmax is None:
        fmax = float(sr) / 2
    fft_freqs = np.linspace(0.0, float(sr) / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])).reshape(-1, 1)
    elif norm is not None:
        raise ValueError(f"unsupported mel norm {norm!r}")
    return weights.astype(np.float32)
