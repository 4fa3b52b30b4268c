"""CREPE pitch salience and its decode, plain PyTorch over a state_dict.

The network as torchcrepe publishes it (``torchcrepe/model.py``; Kim et
al., arXiv:1802.06182): 1024-sample frames at 16 kHz centred every hop (the
input zero-padded by 512 a side), each frame less its mean over its unbiased
standard deviation (at least 1e-10); six blocks of a (K, 1) convolution with
"same" padding, ReLU, batch norm (epsilon 1e-3) and a (2, 1) max pool; the
time-major flattening and a Linear to a 360-bin sigmoid. Keys are
torchcrepe's (``conv{i}``, ``conv{i}_BN``, ``classifier``); the widths are
read from the weights, the kernels and strides from the configuration's
``f0`` section. Every product goes through ``ops`` (``conv1d``, ``linear``)
and every kept activation through ``q``, so that ``operand_precision`` rounds
them.

The decode follows torchcrepe's Viterbi (``torchcrepe/decode.py``: a
triangular transition prior 12 bins wide, normalised over each source bin,
a uniform start, the most likely path) with the port's departures, which
``configs/crepe48.json`` lists under ``departures``: the bins whose centre
lies outside [fmin, fmax] are zeroed, the observations are each frame's
salience over its sum (logged with 1e-12), and the pitch is the 9-bin
weighted mean of cents around the path, 0 where no bin exceeds 1e-3."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .ops import conv1d, linear, q

WINDOW, N_CLASS = 1024, 360
CENTS = 20.0 * np.arange(N_CLASS) + 1997.3794084376191
BN_EPS = 1e-3               # torchcrepe's (0.0010000000474974513 in float32)
VITERBI_WIDTH = 12
_CALIBRATE = {"on": False}


def frames_of(audio: torch.Tensor, hop: int = 160) -> torch.Tensor:
    """[T] audio -> [T // hop + 1, 1024] centred frames, zero-padded."""
    padded = F.pad(audio.float()[None], (WINDOW // 2, WINDOW // 2))[0]
    return padded.unfold(0, WINDOW, hop)


def _same(length: int, k: int, stride: int):
    """(left, right) "same" padding: ceil(length / stride) outputs."""
    total = (math.ceil(length / stride) - 1) * stride + k - length
    return total // 2, total - total // 2


def _bn(sd, p, x):
    if _CALIBRATE["on"]:
        sd[f"{p}.running_mean"] = x.mean((0, 2))
        sd[f"{p}.running_var"] = x.var((0, 2), unbiased=False)
    scale = sd[f"{p}.weight"].float() * torch.rsqrt(sd[f"{p}.running_var"].float() + BN_EPS)
    shift = sd[f"{p}.bias"].float() - sd[f"{p}.running_mean"].float() * scale
    return q(x * scale[None, :, None] + shift[None, :, None])


def _forward(sd, frames: torch.Tensor, arch: dict) -> torch.Tensor:
    mu = frames.mean(dim=1, keepdim=True)
    std = torch.clamp(frames.std(dim=1, keepdim=True), min=1e-10)
    x = q((frames.float() - mu) / std)[:, None]                  # [N, 1, 1024]
    for i, (k, s) in enumerate(zip(arch["kernels"], arch["strides"])):
        p = f"conv{i + 1}"
        w = sd[f"{p}.weight"][..., 0]                            # [C_out, C_in, K]
        x = conv1d(F.pad(x, _same(x.shape[-1], k, s)), w, sd[f"{p}.bias"], stride=s)
        x = _bn(sd, f"{p}_BN", torch.relu(x))
        x = F.max_pool1d(x, 2, 2)
    x = x.transpose(1, 2).reshape(x.shape[0], -1)                # time-major, channels inner
    return torch.sigmoid(linear(x, sd["classifier.weight"], sd["classifier.bias"]))


def salience(sd, frames: torch.Tensor, arch: dict, block: int = 512) -> torch.Tensor:
    """[N, 1024] raw frames -> [N, 360] salience, ``block`` frames at a
    time (each frame's salience is its own)."""
    return torch.cat([_forward(sd, frames[i:i + block], arch)
                      for i in range(0, frames.shape[0], block)])


def calibrate(sd, audio: torch.Tensor, arch: dict) -> None:
    """Set each batch norm's running statistics, in place, to the batch
    statistics of its input over the frames of ``audio`` [T] (where training
    leaves them), in float32 with TF32 off whatever the caller's switches."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    _CALIBRATE["on"] = True
    try:
        with torch.no_grad():
            _forward(sd, frames_of(audio, arch["hop"]), arch)
    finally:
        _CALIBRATE["on"] = False
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def masked(sal: torch.Tensor, fmin: float, fmax: float) -> torch.Tensor:
    """The salience (float64) with every bin whose centre lies outside
    [fmin, fmax] set to 0."""
    cents = torch.from_numpy(CENTS).to(sal.device)
    out = sal.double().clone()
    out[:, (cents < 1200 * math.log2(fmin / 10.0)) | (cents > 1200 * math.log2(fmax / 10.0))] = 0.0
    return out


def viterbi(sal: torch.Tensor) -> torch.Tensor:
    """The most likely bin path [N] through a masked salience [N, 360]
    (float64): a dense log-transition matrix, one step a frame."""
    n = sal.shape[1]
    idx = torch.arange(n, device=sal.device)
    tri = torch.clamp(VITERBI_WIDTH - (idx[:, None] - idx[None, :]).abs(), min=0).double()
    log_trans = torch.log(tri / tri.sum(dim=1, keepdim=True))       # [source, destination]
    obs = sal / torch.clamp(sal.sum(dim=1, keepdim=True), min=1e-12)
    log_obs = torch.log(obs + 1e-12)
    value = math.log(1.0 / n) + log_obs[0]
    back = torch.zeros(sal.shape, dtype=torch.long, device=sal.device)
    for t in range(1, sal.shape[0]):
        value, back[t] = (value[:, None] + log_trans).max(dim=0)
        value = value + log_obs[t]
    back = back.cpu().numpy()
    path = np.zeros(sal.shape[0], np.int64)
    path[-1] = int(value.argmax())
    for t in range(sal.shape[0] - 2, -1, -1):
        path[t] = back[t + 1, path[t + 1]]
    return torch.from_numpy(path).to(sal.device)


def pitch(sal: torch.Tensor, path: torch.Tensor) -> torch.Tensor:
    """f0 [N] in Hz from a masked salience and a bin path: the 9-bin
    weighted mean of cents around the path, 0 where no bin exceeds 1e-3."""
    cents = torch.from_numpy(np.pad(CENTS, (4, 4))).to(sal.device)
    idx = path[:, None] + torch.arange(9, device=sal.device)[None]
    w = torch.gather(F.pad(sal, (4, 4)), 1, idx)
    avg = (w * cents[idx]).sum(1) / torch.clamp(w.sum(1), min=1e-12)
    f0 = 10.0 * 2.0 ** (avg / 1200.0)
    return torch.where(sal.max(dim=1).values < 1e-3, torch.zeros_like(f0), f0)


def decode(sal: torch.Tensor, fmin: float, fmax: float) -> torch.Tensor:
    """[N, 360] salience -> f0 [N] Hz (float64)."""
    m = masked(sal, fmin, fmax)
    return pitch(m, viterbi(m))
