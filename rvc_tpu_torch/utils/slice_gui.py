"""The audio slicer's core (port of ``rvc_tpu/utils/slice_gui.py``'s
``slice_file``): cut one file into fixed-length or silence-separated
chunks for a dataset. Its display-bound launcher is part of the UI, which
the port does not have yet.

Two modes: "fixed", back-to-back windows of ``slice_ms`` milliseconds;
"silence", the preprocessing ``Slicer`` (RMS silence detection), each
slice written whole.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..train.preprocess import Slicer
from .audio_io import read_audio, resample, save_audio, to_mono


def slice_file(input_path: str, output_dir: str, mode: str = "fixed",
               slice_ms: int = 3000, sample_rate: Optional[int] = None,
               min_keep_ms: int = 300) -> List[str]:
    """Cut ``input_path`` into chunk WAVs under ``output_dir``; returns the
    written paths. Chunks shorter than ``min_keep_ms`` are dropped."""
    audio, sr = read_audio(input_path)
    audio = to_mono(audio).astype(np.float32)
    if sample_rate is not None and sr != sample_rate:
        audio = resample(audio, sr, sample_rate)
        sr = sample_rate
    if mode == "fixed":
        step = max(1, int(sr * slice_ms / 1000))
        chunks = [audio[i:i + step] for i in range(0, len(audio), step)]
    elif mode == "silence":
        chunks = Slicer(sr=sr).slice(audio)
    else:
        raise ValueError(f"unknown slice mode {mode!r} (fixed|silence)")
    os.makedirs(output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(input_path))[0]
    min_keep = int(sr * min_keep_ms / 1000)
    written = []
    for i, chunk in enumerate(chunks):
        if len(chunk) < min_keep:
            continue
        out = os.path.join(output_dir, f"{base}_{i:04d}.wav")
        save_audio(out, chunk, sr)
        written.append(out)
    return written
