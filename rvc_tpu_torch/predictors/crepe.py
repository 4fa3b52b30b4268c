"""CREPE pitch estimator, full and tiny capacities (port of
``rvc_tpu/predictors/crepe.py``).

1024-sample frames at 16 kHz, each normalized by its mean and (unbiased)
standard deviation, through 6 conv blocks (conv, ReLU, batch norm, 2x max
pool) and a Linear to a 360-bin sigmoid salience; f0 from the cents of a
weighted local average around the argmax or around a Viterbi path. The
module carries torchcrepe's names (``conv{i}``, ``conv{i}_BN``,
``classifier``), so a torchcrepe checkpoint loads as it is. The salience
runs batched on the model's device. On the card each block is one launch
of kernel C (``ops/crepe_conv.py``), its packed weights and folded batch
norms built once per weight version (counter ``crepe_packs``); on the CPU
the blocks run as plain PyTorch. The Viterbi decode runs where the
salience lies: on the card kernel V (``ops/viterbi.py``), only the f0
coming back to the host; on the CPU the host's numpy ``_viterbi_path``,
V's plain version.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view
import torch
from torch import nn

from ..device import resolve_device
from ..ops import crepe_conv, viterbi
from ..utils import profiling
from ..utils.profiling import annotated, span
from ..utils.weight_cache import WeightCache
from .cents import CENTS_MAPPING, N_CLASS, weighted_cents_decode

SR = 16000
WINDOW = 1024

# capacity: full = 32x multiplier, tiny = 4x (the CREPE paper, torchcrepe)
CAPACITIES = {"full": 32, "tiny": 4}
BASE_FILTERS = (32, 4, 4, 4, 8, 16)
KERNELS = (512, 64, 64, 64, 64, 64)
STRIDES = (4, 1, 1, 1, 1, 1)
# 'same'-style padding of the time axis: (254, 254) first, (31, 32) after
PADS = ((254, 254),) + ((31, 32),) * 5
# torchcrepe's batch-norm epsilon, which its checkpoints were trained with
# (the JAX package computes flax's 1e-5; its parity tests pass that)
BN_EPS = 1e-3


def _geometry():
    """Each block's (output steps before the pool, stride, left padding)."""
    out, length = [], WINDOW
    for k, s, (lo, hi) in zip(KERNELS, STRIDES, PADS):
        length = (length + lo + hi - k) // s + 1
        out.append((length, s, lo))
        length //= 2
    return tuple(out)


GEOMETRY = _geometry()


class CrepeModel(nn.Module):
    def __init__(self, capacity: str = "full", eps: float = BN_EPS):
        super().__init__()
        mult = CAPACITIES[capacity]
        chans = (1,) + tuple(f * mult for f in BASE_FILTERS)
        for i in range(6):
            setattr(self, f"conv{i + 1}", nn.Conv2d(
                chans[i], chans[i + 1], (KERNELS[i], 1), (STRIDES[i], 1)))
            setattr(self, f"conv{i + 1}_BN", nn.BatchNorm2d(chans[i + 1], eps=eps))
        self.classifier = nn.Linear(4 * chans[-1], N_CLASS)
        self._packs = WeightCache("crepe_packs")

    def blocks(self):
        return [(getattr(self, f"conv{i + 1}"), getattr(self, f"conv{i + 1}_BN"))
                for i in range(6)]

    def packed(self):
        """Kernel C's packed weights and folded batch norms at the precision
        ``torch.backends.cudnn.allow_tf32`` asks for (single-pass tf32 where
        set, else 3xTF32; conv1 3xTF32 at either), built when a weight or
        running statistic changes."""
        three = not torch.backends.cudnn.allow_tf32
        blocks = self.blocks()
        tensors = [t for conv, bn in blocks for t in (
            conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var)]
        return self._packs.get(tensors, (three, tuple(bn.eps for _, bn in blocks)),
                               lambda: crepe_conv.pack_blocks(blocks, GEOMETRY, three))

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [N, 1024] (already normalized) -> salience [N, 360]: the
        blocks through kernel C for a CUDA tensor (float32 only; inference:
        the batch norms' running statistics), as plain PyTorch on the CPU."""
        if frames.device.type == "cpu":
            x = crepe_conv.blocks_plain(frames, self.blocks(), PADS)
        else:
            if self.training or (torch.is_grad_enabled() and (
                    frames.requires_grad or any(p.requires_grad for p in self.parameters()))):
                raise RuntimeError("CrepeModel on the card runs inference only (kernel C "
                                   "has no backward): call .eval() and run it under "
                                   "torch.no_grad()")
            x = crepe_conv.crepe_blocks(frames, self.packed())
        # time-major, channels inner
        return torch.sigmoid(self.classifier(x.reshape(x.shape[0], -1)))


def _decode_weighted(salience: np.ndarray) -> np.ndarray:
    """Weighted local average around the argmax."""
    sal = torch.from_numpy(salience)
    return weighted_cents_decode(sal, torch.argmax(sal, dim=1)).numpy()


def _viterbi_path(salience: np.ndarray) -> np.ndarray:
    """The Viterbi path over pitch bins (torchcrepe's default decoder): a
    triangular transition prior over the bin distance, zero outside the
    +-11-bin band (``viterbi.band``). A step is one frame on the host: the
    23 band-shifted sources read as one strided view of the padded previous
    row, one add and one max. Only the values are kept; the backtrack finds
    each argmax again among the 23 sources of the path's bin, first in
    order as the step's argmax would."""
    t, n = salience.shape
    r = viterbi.WIDTH - 1
    offs, logw, log_rowsum = viterbi.band(n)

    obs = salience.astype(np.float64)
    obs = obs / np.maximum(obs.sum(axis=1, keepdims=True), 1e-12)
    log_obs = np.log(obs + 1e-12)

    # a[i] = dp[i] - log_rowsum, padded by r of -inf a side; src[i][k, j] is
    # the source a[i][j - offs[k]] of destination j
    a_pad = np.full((t, n + 2 * r), -np.inf)
    a = a_pad[:, r:r + n]
    src = sliding_window_view(a_pad, n, axis=1)[:, ::-1]
    lw, cand = logw[:, None], np.empty((len(offs), n))
    dp = np.full(n, np.log(1.0 / n)) + log_obs[0]
    for i in range(1, t):
        np.subtract(dp, log_rowsum, out=a[i - 1])
        np.add(src[i - 1], lw, out=cand)
        dp = cand.max(axis=0)
        dp += log_obs[i]
    path = np.zeros(t, np.int64)
    j = path[-1] = dp.argmax()
    for i in range(t - 2, -1, -1):
        j = path[i] = j - offs[(a_pad[i, j:j + 2 * r + 1][::-1] + logw).argmax()]
    return path


def _decode_viterbi(salience: np.ndarray) -> np.ndarray:
    """The weighted average of cents around the Viterbi path."""
    return weighted_cents_decode(torch.from_numpy(salience),
                                 torch.from_numpy(_viterbi_path(salience))).numpy()


def _decode_viterbi_card(salience: torch.Tensor, outside: np.ndarray) -> np.ndarray:
    """The host decode's f0 of a salience [T, 360] f32 on the card: the
    bins ``outside`` the range zeroed, the path by kernel V, the weighted
    average of cents around it and the pitch on the card, 0 where no bin
    reaches 1e-3; only the f0 [T] f32 comes back to the host."""
    sal = salience.masked_fill(torch.from_numpy(outside).to(salience.device), 0.0)
    cents = weighted_cents_decode(sal, viterbi.viterbi_path(sal))
    f0 = 10.0 * torch.pow(2.0, cents / 1200.0)
    return torch.where(sal.amax(dim=1) < 1e-3, 0.0, f0).cpu().numpy()


class CREPE:
    """Host-facing predictor: a ``CrepeModel`` on a device, audio in, f0
    out."""

    def __init__(self, capacity: str = "full", model: Optional[CrepeModel] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.model = (model or CrepeModel(capacity)).to(self.device).eval()

    @classmethod
    def from_torch_checkpoint(cls, path: str, capacity: str = "full",
                              device: Union[str, torch.device] = "cuda",
                              eps: float = BN_EPS) -> "CREPE":
        """Load a torchcrepe state_dict. The capacity is the checkpoint's
        (the classifier takes 64 x multiplier inputs), whatever was asked;
        ``eps`` is the batch norms' epsilon."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        in_features = int(sd["classifier.weight"].shape[1])
        detected = {64 * m: c for c, m in CAPACITIES.items()}.get(in_features)
        if detected is None:
            raise ValueError(
                f"unrecognized crepe checkpoint ({in_features} classifier "
                f"inputs; expected {sorted(64 * m for m in CAPACITIES.values())})")
        if detected != capacity:
            print(f"crepe checkpoint at {path} is capacity {detected!r}; "
                  f"using it instead of the requested {capacity!r}")
        model = CrepeModel(detected, eps)
        # every tensor but the batch norms' step counters
        keys = [k for k in model.state_dict() if not k.endswith("num_batches_tracked")]
        missing = [k for k in keys if k not in sd]
        if missing:
            raise KeyError(f"crepe checkpoint lacks {missing[:8]}")
        model.load_state_dict({k: sd[k].float() for k in keys}, strict=False)
        return cls(detected, model, device)

    @annotated("rvc.crepe")
    @torch.no_grad()
    def salience(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, 1024] raw frames on the device -> [N, 360] salience."""
        mu = frames.mean(dim=1, keepdim=True)
        std = torch.clamp(frames.std(dim=1, keepdim=True, unbiased=True), min=1e-10)
        return self.model((frames - mu) / std)

    def predict(self, audio: np.ndarray, hop_length: int = 160,
                fmin: float = 50.0, fmax: float = 1100.0,
                decoder: str = "viterbi", batch_size: int = 512) -> np.ndarray:
        """audio [T] at 16 kHz -> f0 [T // hop_length + 1] (centered
        frames, torchcrepe.predict's pad=True). A salience on the card with
        the Viterbi decoder is decoded there by kernel V, and only the f0 is
        copied to the host; any other is copied to the host and decoded
        there. Spans ``rvc.f0_net`` (the framing, the salience batches; the
        host's copy of the salience where the host decodes) and
        ``rvc.f0_decode`` (the range mask, the decoder, the pitch; on the
        card also the f0's copy, the first wait for the salience); counters
        ``f0_frames``, ``viterbi_device_frames`` (V's)."""
        audio = np.asarray(audio, np.float32)
        with span("rvc.f0_net"):
            pad = WINDOW // 2
            padded = torch.from_numpy(np.pad(audio, (pad, pad))).to(self.device)
            frames = padded.unfold(0, WINDOW, hop_length)
            profiling.count("f0_frames", frames.shape[0])
            salience = torch.cat([self.salience(frames[i:i + batch_size])
                                  for i in range(0, frames.shape[0], batch_size)]).float()
            on_card = decoder == "viterbi" and salience.is_cuda
            if not on_card:
                salience = salience.cpu().numpy()

        with span("rvc.f0_decode"):
            cents_lo = 1200 * np.log2(fmin / 10.0)
            cents_hi = 1200 * np.log2(fmax / 10.0)
            outside = (CENTS_MAPPING < cents_lo) | (CENTS_MAPPING > cents_hi)
            if on_card:
                return _decode_viterbi_card(salience, outside)
            salience[:, outside] = 0.0
            cents = (_decode_viterbi(salience) if decoder == "viterbi"
                     else _decode_weighted(salience))
            f0 = 10.0 * (2.0 ** (cents / 1200.0))
            # no periodicity gate, as the reference; frames with no salience
            # at all are unvoiced
            f0[salience.max(axis=1) < 1e-3] = 0.0
            return f0.astype(np.float32)

