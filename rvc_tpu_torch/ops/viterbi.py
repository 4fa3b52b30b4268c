"""CREPE's Viterbi decode on the card: kernel V ``viterbi``.

``viterbi_path`` takes a masked salience [T, 360] f32 on the card to the
most likely bin path [T] int64 on the card, in two launches of V
(``csrc/viterbi.cu``): the observations, a warp a frame, then one block that
runs the frames in order with the 360 scores in shared memory and follows
the back pointers home. It computes ``predictors/crepe.py``'s
``_viterbi_path`` (V's plain version, numpy on the host, which a CPU
salience keeps) in float64: the transition band (``band``) is the host's,
the row sums are numpy's pairwise order, the log is CUDA's (within an ulp),
and ties go to the first maximum as the host's do. V replaces no TPU kernel:
the JAX package decodes in numpy too. It is bound by latency, one barrier
a frame (about 0.3 us a step on one SM), far above its 100 MB of HBM
traffic for a 240 s song. Each decoded frame counts in the counter
``viterbi_device_frames``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import profiling

N_BINS = 360
# triangular transition prior: zero outside |bin distance| < 12 (torchcrepe)
WIDTH = 12

launches = {"viterbi": 0}


def reset_launches() -> None:
    launches["viterbi"] = 0


def band(n: int = N_BINS):
    """The transition band over ``n`` bins, float64: the offsets -11..11,
    their log weights, and the log of each destination's row sum."""
    r = WIDTH - 1
    offs = np.arange(-r, WIDTH)
    w_band = (WIDTH - np.abs(offs)).astype(np.float64)
    logw = np.log(w_band)
    log_rowsum = np.log(np.convolve(np.ones(n), w_band, mode="same"))
    return offs, logw, log_rowsum


@functools.lru_cache(maxsize=None)
def _band_on(device: torch.device) -> torch.Tensor:
    """logw, log_rowsum and log(1 / 360) as one float64 tensor on
    ``device``, built once a device."""
    _, logw, log_rowsum = band(N_BINS)
    return torch.from_numpy(np.concatenate([logw, log_rowsum, [np.log(1.0 / N_BINS)]])).to(device)


def _lib():
    from ._build import load

    lib = load("viterbi")
    if not getattr(lib, "_rvc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rvc_viterbi_obs.argtypes = [p, p, i, p]
        lib.rvc_viterbi_obs.restype = i
        for name in ("rvc_viterbi_dp", "rvc_viterbi_floor"):
            getattr(lib, name).argtypes = [p, p, p, p, i, p]
            getattr(lib, name).restype = i
        lib._rvc_typed = True
    return lib


def _check(sal: torch.Tensor) -> None:
    if sal.device.type != "cuda":
        raise ValueError(f"viterbi: a CUDA tensor, got one on {sal.device}")
    if sal.dtype != torch.float32:
        raise ValueError(f"viterbi: float32 salience, got {sal.dtype}")
    if sal.dim() != 2 or sal.shape[1] != N_BINS or not sal.is_contiguous():
        raise ValueError(f"viterbi: a contiguous [T, {N_BINS}] salience, "
                         f"got {tuple(sal.shape)}")


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"viterbi: CUDA error {err} at the launch of {what}")
    launches["viterbi"] += 1


def observations(sal: torch.Tensor) -> torch.Tensor:
    """The host's ``log(obs + 1e-12)`` of a masked salience [T, 360] f32 on
    the card -> [T, 360] float64, one launch."""
    _check(sal)
    lo = torch.empty(sal.shape, dtype=torch.float64, device=sal.device)
    if sal.shape[0] == 0:
        return lo
    with torch.cuda.device(sal.device):  # the launch acts on the current device
        err = _lib().rvc_viterbi_obs(sal.data_ptr(), lo.data_ptr(), sal.shape[0],
                                     torch.cuda.current_stream(sal.device).cuda_stream)
    _launched(err, "the observations")
    return lo


def viterbi_path(sal: torch.Tensor) -> torch.Tensor:
    """V: ``_viterbi_path``'s bin path [T] int64 on the card for a masked
    salience [T, 360] f32 contiguous on the card, in two launches; raises
    for any other tensor."""
    lo = observations(sal)
    t = sal.shape[0]
    path = torch.empty(t, dtype=torch.int64, device=sal.device)
    if t == 0:
        return path
    back = torch.empty((t, N_BINS), dtype=torch.uint8, device=sal.device)
    with torch.cuda.device(sal.device):
        err = _lib().rvc_viterbi_dp(lo.data_ptr(), _band_on(sal.device).data_ptr(),
                                    back.data_ptr(), path.data_ptr(), t,
                                    torch.cuda.current_stream(sal.device).cuda_stream)
    _launched(err, "the recurrence")
    profiling.count("viterbi_device_frames", t)
    return path
