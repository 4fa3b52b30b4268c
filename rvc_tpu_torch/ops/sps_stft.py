"""``scipy.signal.stft`` / ``istft`` on tensors, on the tensor's device.

The JAX package computes its output effects, formant shifting and the
spectral gate with scipy's pair at ``nperseg=n_fft``, ``noverlap=n_fft -
hop`` and the other arguments at their defaults. This pair reproduces that
framing and scaling, which ``torch.stft`` does not (it frames the tail and
scales otherwise):

- a periodic Hann window;
- ``boundary="zeros"``: ``n_fft // 2`` zeros at each end;
- ``padded=True``: zeros at the end up to a whole frame;
- ``scaling="spectrum"``: the spectrum divided by the window's sum;
- a signal shorter than ``n_fft`` is framed with ``nperseg`` cut to its
  length, as scipy does (and refused as scipy refuses it when the overlap
  is then not below that length);
- ``istft`` divides the overlap-added frames by the overlapped squared
  window where that exceeds 1e-10, and trims ``n_fft // 2`` at each end.

Frames come from ``unfold`` and go back through ``fold`` (overlap-add), so
neither direction loops over frames. Dtypes follow scipy's: a float32
signal gives a complex64 spectrum, a float64 one complex128, and ``istft``
returns the real dtype of its input. Spectra are [..., bins, frames], as
scipy lays them out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NOLA_EPS = 1e-10


def _window(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """scipy's ``get_window("hann", n)``: periodic, made in float64."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * i / n)).to(dtype)


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype in (torch.float64, torch.complex128) else torch.float32


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``scipy.signal.stft(x, nperseg=n_fft, noverlap=n_fft - hop)[2]`` of
    a real [..., T] tensor: complex [..., nperseg // 2 + 1, frames]."""
    real = _real_dtype(x.dtype)
    x = x.to(real)
    nperseg = min(n_fft, x.shape[-1])
    noverlap = n_fft - hop
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg.")
    step = nperseg - noverlap
    half = nperseg // 2
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    n = x.shape[-1] + 2 * half
    nadd = (-(n - nperseg) % step) % nperseg
    x = F.pad(x, (half, half + nadd))
    win = _window(nperseg, real, x.device)
    frames = x.unfold(-1, nperseg, step) * win
    spec = torch.fft.rfft(frames, dim=-1) * (1.0 / win.sum())
    return spec.transpose(-1, -2).reshape(*lead, nperseg // 2 + 1, -1)


def istft(z: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``scipy.signal.istft(z, nperseg=n_fft, noverlap=n_fft - hop)[1]``:
    the real [..., (frames - 1) * hop] signal of a complex
    [..., n_fft // 2 + 1, frames] spectrum."""
    if z.shape[-2] != n_fft // 2 + 1:
        raise ValueError(f"spectrum has {z.shape[-2]} bins; n_fft={n_fft} "
                         f"needs {n_fft // 2 + 1}")
    real = _real_dtype(z.dtype)
    lead, n_frames = z.shape[:-2], z.shape[-1]
    z = z.reshape(-1, *z.shape[-2:])
    win = _window(n_fft, real, z.device)
    frames = torch.fft.irfft(z, n=n_fft, dim=-2) * (win.sum() * win[:, None])
    length = n_fft + (n_frames - 1) * hop
    x = F.fold(frames, (1, length), (1, n_fft), stride=(1, hop))[:, 0, 0]
    norm = F.fold((win * win)[None, :, None].expand(1, n_fft, n_frames),
                  (1, length), (1, n_fft), stride=(1, hop))[0, 0, 0]
    half = n_fft // 2
    x, norm = x[:, half:length - half], norm[half:length - half]
    x = x / torch.where(norm > NOLA_EPS, norm, torch.ones_like(norm))
    return x.reshape(*lead, -1)
