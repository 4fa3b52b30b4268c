"""CREPE's work, counted from shapes: the operations of its six blocks and
its classifier for each frame, and the bytes of one call on a batch of
frames (the frames read, the weights read, the salience written, float32),
as ``work/flops.py`` counts (two operations a multiply-add, each input
read once and each output written once). ``arch`` is a configuration's
``f0`` section: ``filters``, ``kernels``, ``strides`` and ``classifier``."""

from __future__ import annotations

import math
from typing import List, Tuple

from .flops import bound_s as _bound_s

WINDOW, N_CLASS = 1024, 360


def blocks(arch: dict) -> List[Tuple[int, int, int, int]]:
    """Each block's conv as (output length, input channels, output
    channels, kernel): "same" padding, ceil(length / stride) outputs, then
    a 2x max pool."""
    out, length, c_in = [], WINDOW, 1
    for c_out, k, s in zip(arch["filters"], arch["kernels"], arch["strides"]):
        n = math.ceil(length / s)
        out.append((n, c_in, c_out, k))
        length, c_in = n // 2, c_out
    return out


def frame_flops(arch: dict) -> int:
    """Operations of one frame: the six convs and the classifier."""
    convs = sum(2 * n * c_in * c_out * k for n, c_in, c_out, k in blocks(arch))
    return convs + 2 * arch["classifier"][0] * arch["classifier"][1]


def parameters(arch: dict) -> int:
    """Weights and biases of the convs, the batch norms' four vectors, the
    classifier."""
    convs = sum(c_in * c_out * k + c_out + 4 * c_out for _, c_in, c_out, k in blocks(arch))
    return convs + (arch["classifier"][0] + 1) * arch["classifier"][1]


def salience(frames: int, arch: dict) -> Tuple[int, int]:
    """(flops, bytes) of one call on ``frames`` frames."""
    return (frames * frame_flops(arch),
            4 * (frames * WINDOW + parameters(arch) + frames * N_CLASS))


def bound_s(frames: int, arch: dict) -> float:
    """The least time of one call on ``frames`` frames: operations at
    TF32's peak or bytes at the memory's, whichever is longer."""
    return _bound_s(*salience(frames, arch), "tf32")
