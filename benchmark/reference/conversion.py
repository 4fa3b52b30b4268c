"""The steps of one RVC conversion around the models, plain NumPy and
PyTorch: the 48 Hz high-pass, the 3 s reflect pad a side, the whole-second
bucket, the f0 median filter, pitch shift and 255-bin mel quantisation, the
exact k-nearest retrieval blend, the protect blend, and the trim and peak
normalisation of the output."""

from __future__ import annotations

import numpy as np
import torch
from scipy import signal as sps

from .ops import _MODE, mm
from .rmvpe import decode

SR = 16000
WINDOW = 160
PAD_S = 3


def highpass(audio: np.ndarray) -> np.ndarray:
    bh, ah = sps.butter(5, 48, btype="high", fs=SR)
    return sps.filtfilt(bh, ah, audio).astype(np.float32)


def padded(audio: np.ndarray) -> np.ndarray:
    """The high-passed input with 3 s of reflection a side."""
    return np.pad(highpass(audio), (PAD_S * SR, PAD_S * SR), mode="reflect")


def bucket(n: int) -> int:
    """Samples of the whole-second bucket that holds ``n``."""
    return -(-n // SR) * SR


def in_bucket(audio_pad: np.ndarray) -> np.ndarray:
    out = np.zeros(bucket(len(audio_pad)), np.float32)
    out[:len(audio_pad)] = audio_pad
    return out


def p_len(n_real: int, n_bucket: int) -> int:
    """Frames of the synthesizer's input that carry the request."""
    return min(n_real // WINDOW, 2 * ((n_bucket - 400) // 320 + 1))


def shape_f0(f0: torch.Tensor, pitch_shift: float, radius: int = 3):
    """Median filter (zero-padded edges, odd radius >= 3), shift by
    ``pitch_shift`` semitones, quantise: (coarse int64, f0) over [T]."""
    f0 = f0.double()
    if radius >= 3:
        r = radius if radius % 2 == 1 else radius + 1
        f0 = torch.nn.functional.pad(f0[None], (r // 2, r // 2))[0]
        f0 = torch.median(f0.unfold(0, r, 1), dim=-1).values
    f0 = f0 * 2.0 ** (pitch_shift / 12.0)
    lo, hi = 1127.0 * np.log(1.0 + 50.0 / 700.0), 1127.0 * np.log(1.0 + 1100.0 / 700.0)
    mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    mel = torch.where(mel > 0, (mel - lo) * 254.0 / (hi - lo) + 1.0, mel)
    return torch.round(torch.clamp(mel, 1.0, 255.0)).long(), f0


def retrieve(feats: torch.Tensor, index: torch.Tensor, rate: float, k: int = 8,
             rows: int = 512) -> torch.Tensor:
    """Each frame of [T, D] blended with its k nearest index rows by squared
    L2 (inverse-square-distance weights), exact in float64 (the product in
    the current lower precision otherwise)."""
    out = []
    v = index.double()
    v2 = (v * v).sum(1)
    for s in range(0, feats.shape[0], rows):
        f = feats[s:s + rows].double()
        prod = (f @ v.T if _MODE["kind"] == "fp32"
                else mm(f.float(), index.float().T).double())
        d2 = (f * f).sum(1, keepdim=True) + v2[None] - 2.0 * prod
        d2, idx = torch.topk(d2, k, dim=1, largest=False)
        w = 1.0 / torch.clamp(d2, min=1e-12) ** 2
        w = w / w.sum(1, keepdim=True)
        out.append(rate * (v[idx] * w[..., None]).sum(1) + (1.0 - rate) * f)
    return torch.cat(out).float()


def synth_inputs(sal: torch.Tensor, feats: torch.Tensor, index: torch.Tensor,
                 settings: dict, frames: int):
    """The synthesizer's inputs from one request's salience [F, 360] and
    features [N, 768]: (feats [t, 768], pitch [t], pitchf [t])."""
    coarse, f0 = shape_f0(decode(sal), settings["pitch_shift"], settings["filter_radius"])
    feats0 = feats.float()
    blend = (retrieve(feats0, index, settings["index_rate"])
             if settings["index_rate"] > 0 else feats0)
    blend = torch.repeat_interleave(blend, 2, dim=0)
    feats0 = torch.repeat_interleave(feats0, 2, dim=0)
    t = min(blend.shape[0], frames)
    blend, feats0, coarse, f0 = blend[:t], feats0[:t], coarse[:t], f0[:t]
    protect = settings["protect"]
    if protect < 0.5:
        m = torch.where(f0 > 0, 1.0, protect).float()[:, None]
        blend = blend * m + feats0 * (1.0 - m)
    return blend, coarse, f0.float()


def finish(out: np.ndarray, tgt_sr: int) -> np.ndarray:
    """Drop the 3 s pads at the output rate and keep the peak at 0.99."""
    out = out[PAD_S * tgt_sr:-PAD_S * tgt_sr]
    peak = np.abs(out).max() / 0.99 if out.size else 0.0
    return (out / peak if peak > 1.0 else out).astype(np.float32)
