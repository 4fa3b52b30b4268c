"""The f0 predictor registry and the F0 extraction utility (port of
``rvc_tpu/predictors/f0_extractor.py``): method names, the staged
checkpoints' places, hybrid-method parsing, predictor construction on a
device (rmvpe, fcpe, crepe, crepe-tiny, yin), and ``F0Extractor``, which
extracts a file's contour, transcribes it to MIDI and plots it.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..utils.audio_io import load_audio

SR = 16000
HOP = 160

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
    """Raise ``ValueError`` unless every method of ``f0_method`` (a name or
    ``hybrid[a+b+...]``) is known."""
    methods = parse_f0_methods(f0_method)
    for m in methods or [f0_method]:
        if m not in KNOWN_METHODS:
            raise ValueError(f"unknown f0 method {m!r}; expected one of "
                             f"{'/'.join(KNOWN_METHODS)} or hybrid[...] of them")


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
                     fcpe_ckpt: Optional[str] = None,
                     crepe_ckpt: Optional[str] = None,
                     device: Union[str, torch.device] = "cuda",
                     ) -> Dict[str, Callable[..., np.ndarray]]:
    """The requested predictors as audio -> f0 callables on ``device``;
    a missing checkpoint gives random weights and a warning."""
    out: Dict[str, Callable] = {}
    for m in f0_methods:
        check_f0_method(m)
        if m == "rmvpe":
            from .rmvpe import RMVPE

            ck = _resolve_ckpt(rmvpe_ckpt, "rmvpe")
            mdl = (RMVPE.from_torch_checkpoint(ck, device) if ck
                   else RMVPE(device=device))
            out[m] = mdl.infer_from_audio
        elif m == "fcpe":
            from .fcpe import FCPE

            ck = _resolve_ckpt(fcpe_ckpt, "fcpe")
            out[m] = (FCPE.from_torch_checkpoint(ck, device) if ck
                      else FCPE(device=device)).compute_f0
        elif m in ("crepe", "crepe-tiny"):
            from .crepe import CREPE

            cap = "tiny" if m.endswith("tiny") else "full"
            ck = _resolve_ckpt(crepe_ckpt, "crepe")
            out[m] = (CREPE.from_torch_checkpoint(ck, cap, device) if ck
                      else CREPE(cap, device=device)).predict
        else:
            from .dsp_f0 import yin_f0_np

            out[m] = functools.partial(yin_f0_np, device=resolve_device(device))
    return out


@dataclasses.dataclass
class F0Extractor:
    """A file's f0 contour on the 10 ms grid, its MIDI transcription and
    its plot. ``sample_rate`` is accepted for the reference's signature:
    every predictor reads 16 kHz, so the file is loaded at 16 kHz."""

    wav_path: str
    sample_rate: int = SR
    method: str = "rmvpe"
    device: Union[str, torch.device] = "cuda"

    @property
    def hop_size_ms(self) -> float:
        return HOP / SR * 1000.0

    def extract_f0(self, predictor: Optional[Callable] = None) -> np.ndarray:
        audio = load_audio(self.wav_path, SR)
        if predictor is None:
            predictor = build_predictors((self.method,), device=self.device)[self.method]
        return np.asarray(predictor(audio))

    def to_midi(self, output_path: Optional[str] = None,
                tempo: Optional[float] = None,
                f0: Optional[np.ndarray] = None) -> list:
        """Transcribe the contour to MIDI note segments and write a .mid
        file; the tempo is estimated from the audio when not given."""
        from .f0_midi import f0_to_midi

        if f0 is None:
            f0 = self.extract_f0()
        audio = load_audio(self.wav_path, SR) if tempo is None else None
        out = output_path or self.wav_path.rsplit(".", 1)[0] + ".mid"
        return f0_to_midi(f0, tempo=tempo, audio=audio, sr=SR, output_path=out)

    def plot_f0(self, f0: Optional[np.ndarray] = None,
                save_path: Optional[str] = None) -> Optional[str]:
        """Plot the voiced frames to a PNG; None when matplotlib is absent."""
        try:
            import matplotlib
        except ImportError:
            print("f0 plot skipped: matplotlib is not installed")
            return None
        if f0 is None:
            f0 = self.extract_f0()
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = np.arange(len(f0)) * self.hop_size_ms / 1000.0
        fig, ax = plt.subplots(figsize=(10, 3))
        voiced = f0 > 0
        ax.plot(t[voiced], f0[voiced], ".", markersize=2)
        ax.set_xlabel("time (s)")
        ax.set_ylabel("f0 (Hz)")
        ax.set_title(f"F0 ({self.method})")
        out = save_path or self.wav_path.rsplit(".", 1)[0] + "_f0.png"
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        return out
