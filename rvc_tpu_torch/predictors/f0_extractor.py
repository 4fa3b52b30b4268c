"""The f0 predictor registry (port of the registry half of
``rvc_tpu/predictors/f0_extractor.py``): method names, the staged
checkpoints' places, hybrid-method parsing and predictor construction.

Only ``rmvpe`` is ported; ``yin``, ``crepe``, ``crepe-tiny``, ``fcpe`` and
the hybrids raise ``NotImplementedError`` until ROADMAP A.10 brings them.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

# staged checkpoints, relative to the working directory
DEFAULT_CKPTS = {
    "rmvpe": "models/predictors/rmvpe.pt",
    "fcpe": "models/predictors/fcpe.pt",
    "crepe": "models/predictors/crepe.pt",
}
KNOWN_METHODS = ("rmvpe", "fcpe", "crepe", "crepe-tiny", "yin")


def interp_f0_to_grid(f0: np.ndarray, n_frames: int) -> np.ndarray:
    """Resample an f0 contour to ``n_frames`` on the 10 ms grid, with
    unvoiced frames (< 0.001 Hz) as NaN so that interpolation never bridges
    a voiced value across silence."""
    if len(f0) <= 1:
        return np.asarray(f0, np.float32)
    src = np.asarray(f0, np.float64).copy()
    src[src < 0.001] = np.nan
    tgt = np.interp(np.arange(0, len(src) * n_frames, len(src)) / n_frames,
                    np.arange(len(src)), src)
    return np.nan_to_num(tgt)


def parse_f0_methods(f0_method: str) -> list:
    """'hybrid[a+b]' -> ['a', 'b']; a plain name -> [name]."""
    if f0_method.startswith("hybrid[") and f0_method.endswith("]"):
        return [m.strip()
                for m in f0_method[len("hybrid["):-1].split("+") if m.strip()]
    return [f0_method]


def check_f0_method(f0_method: str) -> None:
    """Raise unless the port serves this method: ``rmvpe`` alone."""
    methods = parse_f0_methods(f0_method)
    for m in methods:
        if m not in KNOWN_METHODS:
            raise ValueError(f"unknown f0 method {m!r}; expected one of "
                             f"{'/'.join(KNOWN_METHODS)}")
    if methods != ["rmvpe"]:
        raise NotImplementedError(
            f"f0 method {f0_method!r} is not ported yet (ROADMAP A.10); "
            "the port serves 'rmvpe'")


def _resolve_ckpt(explicit: Optional[str], kind: str) -> Optional[str]:
    """The explicit path if it exists, else the staged path, else None
    (random weights, with a warning)."""
    for cand in (explicit, DEFAULT_CKPTS.get(kind)):
        if cand and os.path.exists(cand):
            return cand
    print(f"WARNING: no {kind} checkpoint found (looked for "
          f"{explicit or DEFAULT_CKPTS.get(kind)}); using RANDOM-INIT weights "
          "- f0 output will be garbage. Stage the file under models/predictors/.")
    return None


def build_predictors(f0_methods: Sequence[str] = ("rmvpe",),
                     rmvpe_ckpt: Optional[str] = None,
                     device: Union[str, torch.device] = "cuda",
                     ) -> Dict[str, Callable[[np.ndarray], np.ndarray]]:
    """The requested predictors as audio -> f0 callables on ``device``; a
    missing checkpoint gives random weights and a warning."""
    from .rmvpe import RMVPE

    out: Dict[str, Callable] = {}
    for m in f0_methods:
        check_f0_method(m)
        ck = _resolve_ckpt(rmvpe_ckpt, "rmvpe")
        mdl = (RMVPE.from_torch_checkpoint(ck, device) if ck
               else RMVPE(device=device))
        out[m] = mdl.infer_from_audio
    return out
