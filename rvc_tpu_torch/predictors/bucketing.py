"""Length buckets for the f0 predictors (port of
``rvc_tpu/predictors/bucketing.py``).

Audio is padded up to a whole second by reflection and the true frame count
is sliced off after, as the JAX package does for its compiled programs; the
port keeps the same padding so that edge frames agree with it (reflection
extends the signal with the values a centered, reflect-padded STFT would
see anyway)."""

from __future__ import annotations

import numpy as np

SR = 16000


def bucket_samples(t: int, step: int = SR) -> int:
    """Round a sample count up to the next multiple of ``step`` (at least one)."""
    return max(step, ((t + step - 1) // step) * step)


def reflect_to(audio: np.ndarray, target: int) -> np.ndarray:
    """Right-pad ``audio`` to ``target`` samples by (repeated) reflection."""
    out = np.asarray(audio, np.float32)
    while len(out) < target:
        pad = min(target - len(out), max(len(out) - 1, 1))
        mode = "reflect" if len(out) > 1 else "edge"
        out = np.pad(out, (0, pad), mode=mode)
    return out
