"""The windowed path's steps, plain NumPy and PyTorch: the cut points (for
an input longer than ``x_max``, every ``x_center`` the quietest point
within ``x_query`` of the 160-sample moving sum of the high-passed input),
the windows they cut the reflect-padded input into (each overlapping the
next by the two pads), each window's slice of the whole input's pitch, the
rows that carry a window to the device (zero-padded audio, ones and zeros
past the pitch), and RMVPE's whole-input bucket (a reflection up to the
next second). ``win`` holds the windowing in seconds: ``x_pad``,
``x_query``, ``x_center`` and ``x_max``."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .conversion import SR, WINDOW, p_len, retrieve


def cut_points(audio: np.ndarray, win: dict) -> List[int]:
    """Cut points in samples of the high-passed input ``audio``."""
    if audio.shape[0] <= SR * win["x_max"]:
        return []
    query = SR * win["x_query"]
    padded = np.pad(audio, (WINDOW // 2, WINDOW // 2), mode="reflect")
    moving = np.zeros_like(audio)
    for i in range(WINDOW):
        moving += padded[i:i - WINDOW]
    return [t - query + int(np.argmin(np.abs(moving[t - query:t + query])))
            for t in range(SR * win["x_center"], audio.shape[0], SR * win["x_center"])]


def windows(n_padded: int, cuts: List[int], win: dict
            ) -> List[Tuple[int, int, int, Optional[int]]]:
    """The windows of a padded input of ``n_padded`` samples: (first
    sample, end sample, first pitch frame, end pitch frame or None for the
    rest)."""
    pads = 2 * SR * win["x_pad"]
    out, start = [], 0
    for cut in cuts:
        t = cut // WINDOW * WINDOW
        out.append((start, t + pads + WINDOW, start // WINDOW, (t + pads) // WINDOW))
        start = t
    out.append((start, n_padded, start // WINDOW, None))
    return out


def reflect_to(audio: np.ndarray, target: int) -> np.ndarray:
    """``audio`` right-padded to ``target`` samples by repeated reflection."""
    out = np.asarray(audio, np.float32)
    while len(out) < target:
        n = min(target - len(out), max(len(out) - 1, 1))
        out = np.pad(out, (0, n), mode="reflect" if len(out) > 1 else "edge")
    return out


def window_inputs(feats: torch.Tensor, coarse: torch.Tensor, f0: torch.Tensor,
                  index: torch.Tensor, settings: dict, seg_len: int, bucket_len: int):
    """One window's synthesizer inputs from its features [N, 768] and its
    slice of the whole input's quantised pitch and f0: (feats [t, 768],
    pitch [t], pitchf [t])."""
    frames = bucket_len // WINDOW
    n = min(p_len(seg_len, bucket_len), coarse.shape[0])
    pitch = torch.ones(frames, dtype=torch.long, device=feats.device)
    pitchf = torch.zeros(frames, dtype=torch.float64, device=feats.device)
    pitch[:n], pitchf[:n] = coarse[:n], f0[:n]
    feats0 = feats.float()
    blend = (retrieve(feats0, index, settings["index_rate"])
             if settings["index_rate"] > 0 else feats0)
    blend = torch.repeat_interleave(blend, 2, dim=0)
    feats0 = torch.repeat_interleave(feats0, 2, dim=0)
    t = min(blend.shape[0], frames)
    blend, feats0, pitch, pitchf = blend[:t], feats0[:t], pitch[:t], pitchf[:t]
    if settings["protect"] < 0.5:
        m = torch.where(pitchf > 0, 1.0, settings["protect"]).float()[:, None]
        blend = blend * m + feats0 * (1.0 - m)
    return blend, pitch, pitchf.float()
