"""RefineGAN decoder (port of ``rvc_tpu/models/generators/refinegan.py``).

A one-harmonic sine source at the audio rate is projected (``pre_conv``)
and resized linearly back to the frame rate, joined to the projected
latent (``mel_conv``), and refined through stages that resize linearly by
the stage's rate, join a strided-conv downsample of the raw source, and
run a ``ParallelResBlock``: an input conv, then three branches of AdaIN
noise, one residual chain at slope 0.2 and AdaIN again, averaged. Each
branch's chain runs through K2 ``resblock_chain(..., slope=0.2)`` (the
branches start from their own noisy inputs, so K1, which runs every chain
of a stage on one input, does not fit).

As in the JAX package, the decoder keeps ``upsample_initial_channel`` 512
whatever the configuration says; ``gin_channels`` is the speaker
embedding's width (the ``cond`` conv's input). Parameter names are the
reference's (``dec.pre_conv``, ``dec.mel_conv``, ``dec.downsample_blocks.{i}``,
``dec.upsample_conv_blocks.{i}.input_conv`` and ``.blocks.{b}.{0,1,2}``,
``dec.m_source.merge.0``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..commons import (Conv1d, ResBlock, draw, leaky_relu,
                       source_downsample_geometry)
from .sine import CumsumSineGenerator

REFINEGAN_CHANNELS = 512
REFINEGAN_SLOPE = 0.2


def linear_resize(x: torch.Tensor, new_t: int) -> torch.Tensor:
    """Linear resampling of [B, C, T] along time, half-pixel centres
    (``align_corners=False``) and no antialiasing, as the JAX package's
    ``jax.image.resize(..., antialias=False)``: the source branch is
    decimated 320-480 times, where the two must agree."""
    return F.interpolate(x, size=new_t, mode="linear", align_corners=False)


class AdaIN(nn.Module):
    """x + noise * weight (per channel), then leaky ReLU 0.2; the noise is
    drawn from the caller's generator, none with ``zero_noise``."""

    def __init__(self, channels: int, slope: float = REFINEGAN_SLOPE,
                 zero_noise: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.slope, self.zero_noise = slope, zero_noise

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.zero_noise:
            noise = draw("randn", x.shape, generator, x.device)
            x = x + noise.to(x.dtype) * self.weight.to(x.dtype)[None, :, None]
        return leaky_relu(x, self.slope)


class ParallelResBlock(nn.Module):
    """``input_conv`` (7 taps, no weight norm), then per kernel size a
    branch ``blocks.{b}`` = (AdaIN, ResBlock at slope 0.2, AdaIN); the mean
    of the branches."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (3, 7, 11),
                 dilations: Sequence[int] = (1, 3, 5),
                 slope: float = REFINEGAN_SLOPE, zero_noise: bool = False):
        super().__init__()
        self.input_conv = Conv1d(in_channels, out_channels, 7, padding=3)
        self.blocks = nn.ModuleList(
            nn.ModuleList([AdaIN(out_channels, slope, zero_noise),
                           ResBlock(out_channels, k, dilations, slope),
                           AdaIN(out_channels, slope, zero_noise)])
            for k in kernel_sizes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.input_conv(x)
        acc = None
        for adain1, chain, adain2 in self.blocks:
            y = adain2(chain(adain1(x, generator).contiguous()), generator)
            acc = y if acc is None else acc + y
        return acc / len(self.blocks)


class RefineGANSource(nn.Module):
    """One-harmonic sine source with a bias-free linear merge and ``tanh``,
    in float32."""

    def __init__(self, sample_rate: int, zero_noise: bool = False):
        super().__init__()
        self.l_sin_gen = CumsumSineGenerator(sample_rate, 0, zero_noise=zero_noise)
        self.merge = nn.Sequential(nn.Linear(1, 1, bias=False))

    def forward(self, f0: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """f0 [B, T_audio, 1] -> [B, T_audio, 1] float32."""
        sines, _, _ = self.l_sin_gen(f0, generator)
        return torch.tanh(F.linear(sines, self.merge[0].weight.float()))


class RefineGANGenerator(nn.Module):
    def __init__(self, sample_rate: int = 44100,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 slope: float = REFINEGAN_SLOPE, num_mels: int = 128,
                 gin_channels: int = 256,
                 upsample_initial_channel: int = REFINEGAN_CHANNELS,
                 zero_noise: bool = False):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.slope = slope
        ch = upsample_initial_channel
        self.m_source = RefineGANSource(sample_rate, zero_noise)
        self.pre_conv = Conv1d(1, ch // 2, 7, padding=3, weight_norm=True)
        self.mel_conv = Conv1d(num_mels, ch // 2, 7, padding=3, weight_norm=True)
        self.cond = Conv1d(gin_channels, ch // 2, 1)
        downs, blocks = [], []
        for i in range(len(self.upsample_rates)):
            stride, nk, npad = source_downsample_geometry(self.upsample_rates, i)
            down_ch = upsample_initial_channel // (2 ** (i + 2))
            downs.append(Conv1d(1, down_ch, nk, stride=stride, padding=npad,
                                weight_norm=True))
            blocks.append(ParallelResBlock(ch + down_ch, ch // 2, slope=slope,
                                           zero_noise=zero_noise))
            ch //= 2
        self.downsample_blocks = nn.ModuleList(downs)
        self.upsample_conv_blocks = nn.ModuleList(blocks)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False, weight_norm=True)

    def forward(self, x: torch.Tensor, f0: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T_frames] (the latent, the reference's "mel"), f0
        [B, T_frames], g [B, gin, 1] -> audio [B, 1, T_audio]."""
        upp = math.prod(self.upsample_rates)
        t_frames = x.shape[-1]
        f0_up = linear_resize(f0.float()[:, None, :], t_frames * upp)
        har_source = self.m_source(f0_up.transpose(1, 2), generator).transpose(1, 2)
        src = linear_resize(self.pre_conv(har_source), t_frames)
        mel = self.mel_conv(x)
        if g is not None:
            mel = mel + self.cond(g)
        x = torch.cat([mel, src.to(mel.dtype)], dim=1)
        for rate, down, block in zip(self.upsample_rates, self.downsample_blocks,
                                     self.upsample_conv_blocks):
            x = linear_resize(leaky_relu(x, self.slope), x.shape[-1] * rate)
            d = down(har_source)
            x = block(torch.cat([x, d.to(x.dtype)], dim=1), generator)
        x = self.conv_post(leaky_relu(x, self.slope))
        return torch.tanh(x)
