"""360-bin cents decode shared by the pitch predictors (port of
``rvc_tpu/predictors/cents.py``)."""

from __future__ import annotations

import numpy as np
import torch

N_CLASS = 360
CENTS_MAPPING = 20.0 * np.arange(N_CLASS) + 1997.3794084376191
_PAD = 4  # 9-tap window half-width


def weighted_cents_decode(salience: torch.Tensor,
                          center: torch.Tensor) -> torch.Tensor:
    """9-tap weighted average of cents around ``center`` bins.

    salience [T, 360] float32, center [T] int -> [T] average cents."""
    cents = torch.from_numpy(
        np.pad(CENTS_MAPPING, (_PAD, _PAD)).astype(np.float32)).to(salience.device)
    padded = torch.nn.functional.pad(salience, (_PAD, _PAD))
    idx = center[:, None] + torch.arange(2 * _PAD + 1, device=salience.device)[None, :]
    w = torch.gather(padded, 1, idx)
    c = cents[idx]
    return (w * c).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1e-12)
