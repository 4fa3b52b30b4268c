"""Multi-period discriminator (port of ``rvc_tpu/models/discriminators.py``):
one ``DiscriminatorS`` on the raw wave and one ``DiscriminatorP`` per period
(2, 3, 5, 7, 11, 17, 23, 37), each returning its logits and per-layer
feature maps for the feature-matching loss.

Parameter names are the reference torch layout (``discriminators.{i}.convs.{j}``
with ``weight_g`` / ``weight_v``, or ``weight`` under spectral norm), so a
state_dict is the reference's D checkpoint. Inputs are [B, T, 1] as in the
JAX package; feature maps are in torch layout ([B, C, T] and [B, C, T/p, p]).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .commons import Conv1d, leaky_relu, weight_norm

PERIODS = (2, 3, 5, 7, 11, 17, 23, 37)
SPECTRAL_ITERS = 8


def spectral_normalize(weight: torch.Tensor,
                       n_iters: int = SPECTRAL_ITERS) -> torch.Tensor:
    """weight / sigma, sigma its largest singular value as a [out, -1]
    matrix, by ``n_iters`` power iterations from a fixed start with u and v
    detached (the JAX package's stateless ``spectral_normalize``). The
    start vector is seeded numpy noise: JAX's draws its own, so the two
    agree to the iteration's convergence, not bit for bit."""
    w = weight.reshape(weight.shape[0], -1).T                 # [in * k, out]
    start = np.random.default_rng(w.shape[0]).normal(size=w.shape[0])
    with torch.no_grad():
        wd = w.detach().float()
        v = torch.from_numpy(start.astype(np.float32)).to(w.device)
        v = v / (torch.linalg.norm(v) + 1e-12)
        for _ in range(n_iters):
            u = wd.T @ v
            u = u / (torch.linalg.norm(u) + 1e-12)
            v = wd @ u
            v = v / (torch.linalg.norm(v) + 1e-12)
    sigma = v.to(w.dtype) @ (w @ u.to(w.dtype))
    return weight / (sigma + 1e-12)


class NormConv1d(Conv1d):
    """``Conv1d`` with weight norm, or with spectral norm on a plain
    ``weight`` (reference ``norm_f``)."""

    def __init__(self, *args, spectral: bool = False, **kw):
        super().__init__(*args, weight_norm=not spectral, **kw)
        self.spectral = spectral

    def effective_weight(self) -> torch.Tensor:
        if self.spectral:
            return spectral_normalize(self.weight)
        return super().effective_weight()


class NormConv2d(nn.Module):
    """2D conv on [B, C, H, W] (H time), weight-normalized per output
    channel (``WNConv2d``), spectrally normalized, or ``plain`` (flax's
    ``nn.Conv``: no norm, computed in the promoted dtype of its input and
    weights, as flax promotes)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (0, 0), spectral: bool = False,
                 dilation: Tuple[int, int] = (1, 1), plain: bool = False):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.spectral, self.plain = spectral, plain
        shape = (out_channels, in_channels, *kernel_size)
        if spectral or plain:
            self.weight = nn.Parameter(torch.zeros(shape))
        else:
            self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1, 1))
            self.weight_v = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.plain:
            dt = torch.promote_types(x.dtype, self.weight.dtype)
            return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                            self.stride, self.padding, self.dilation)
        w = (spectral_normalize(self.weight) if self.spectral
             else weight_norm(self.weight_v, self.weight_g, dim=0))
        return F.conv2d(x.to(w.dtype), w, self.bias, self.stride, self.padding,
                        self.dilation)


class DiscriminatorS(nn.Module):
    """Raw-waveform discriminator with grouped strided convs."""

    SPECS = ((1, 16, 15, 1, 1, 7), (16, 64, 41, 4, 4, 20),
             (64, 256, 41, 4, 16, 20), (256, 1024, 41, 4, 64, 20),
             (1024, 1024, 41, 4, 256, 20), (1024, 1024, 5, 1, 1, 2))

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        sn = use_spectral_norm
        self.convs = nn.ModuleList(
            NormConv1d(cin, cout, k, stride=s, groups=gr, padding=p, spectral=sn)
            for cin, cout, k, s, gr, p in self.SPECS)
        self.conv_post = NormConv1d(1024, 1, 3, padding=1, spectral=sn)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, 1, T] -> (logits [B, N], feature maps)."""
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class DiscriminatorP(nn.Module):
    """Period discriminator: time folded by ``period`` into [T/p, p], then
    (5, 1) convs of stride 3 over the folded time (all five, as the
    reference), and a (3, 1) post conv."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 use_spectral_norm: bool = False):
        super().__init__()
        self.period = period
        sn, pad = use_spectral_norm, (kernel_size - 1) // 2
        chans = (1, 32, 128, 512, 1024, 1024)
        self.convs = nn.ModuleList(
            NormConv2d(chans[i], chans[i + 1], (kernel_size, 1), (stride, 1),
                       (pad, 0), spectral=sn) for i in range(5))
        self.conv_post = NormConv2d(1024, 1, (3, 1), (1, 1), (1, 0), spectral=sn)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, 1, T] -> (logits [B, N], feature maps)."""
        b, c, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x, (0, p - t % p), mode="reflect")
            t = x.shape[-1]
        x = x.view(b, c, t // p, p)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


def run_discriminators(discs: Sequence[nn.Module], y: torch.Tensor,
                       y_hat: torch.Tensor):
    """Each sub-discriminator on real and fake as one doubled batch, split
    into (real logits, fake logits, real fmaps, fake fmaps) per
    discriminator. y, y_hat [B, T, 1]; each sub-discriminator takes
    [2B, 1, T]."""
    xy = torch.cat([y, y_hat], dim=0).transpose(1, 2)
    return run_discriminators_doubled(discs, [xy] * len(discs), y.shape[0])


def run_discriminators_doubled(discs: Sequence[nn.Module],
                               inputs: Sequence[torch.Tensor], b: int):
    """Each sub-discriminator on its own doubled [2B, ...] input (real rows
    first, then fake), split into (real logits, fake logits, real fmaps,
    fake fmaps): the one place of the real-first convention, used directly
    where the inputs differ (the DWT scales of ``MultiScaleDiscriminator``)."""
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
    for d, inp in zip(discs, inputs):
        out, fmap = d(inp)
        y_d_rs.append(out[:b])
        y_d_gs.append(out[b:])
        fmap_rs.append([f[:b] for f in fmap])
        fmap_gs.append([f[b:] for f in fmap])
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = PERIODS,
                 use_spectral_norm: bool = False):
        super().__init__()
        self.periods = tuple(periods)
        self.discriminators = nn.ModuleList(
            [DiscriminatorS(use_spectral_norm)]
            + [DiscriminatorP(p, use_spectral_norm=use_spectral_norm)
               for p in self.periods])

    def group_of(self, name: str) -> str:
        """The JAX tree's name of a parameter's sub-discriminator (its
        gradient-norm group): ``disc_s`` or ``disc_p<period>``."""
        i = int(name.split(".")[1])
        return "disc_s" if i == 0 else f"disc_p{self.periods[i - 1]}"

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat [B, T, 1] -> (real logits, fake logits, real fmaps,
        fake fmaps), one entry per sub-discriminator."""
        return run_discriminators(self.discriminators, y, y_hat)
