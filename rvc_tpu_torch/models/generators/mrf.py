"""MRF HiFi-GAN decoder (port of ``rvc_tpu/models/generators/mrf.py``).

The NSF skeleton with a harmonic-rich source: f0 is repeated to the audio
rate (nearest) before a bank of 9 sines (``CumsumSineGenerator``), merged
to one channel by a biased linear layer and ``tanh``; the noise convs take
that channel. Each stage tail is the mean over MRF blocks, each a chain of
layers ``x + conv2(lrelu(conv1(lrelu(x))))`` over the dilations: to the
operation a HiFi-GAN ResBlock chain, so the stage goes through the same
dispatch as the NSF decoder's (``nsf._resblock_stage``, looked up at each
call): K1 ``mrf_stage`` in one launch for bf16 at C <= 128, K2
``resblock_chain`` per chain at C = 256 and in f32. The JAX package runs
the same function through plain convolutions.

Parameter names are the reference's (``dec.upsamples.{i}``,
``dec.mrfs.{i}.{j}.layers.{k}.conv1`` / ``.conv2``, ``dec.m_source.l_linear``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.resblock import WeightCache
from ..commons import (LRELU_SLOPE, ChainBlock, Conv1d, ConvTranspose1d,
                       leaky_relu, source_downsample_geometry)
from . import nsf
from .sine import CumsumSineGenerator


class MRFLayer(nn.Module):
    """conv1 of dilation d ("same" padding), conv2 of dilation 1, both
    weight-normalized; the layer adds their output to its input."""

    def __init__(self, channels: int, kernel_size: int, dilation: int):
        super().__init__()
        self.conv1 = Conv1d(channels, channels, kernel_size, dilation=dilation,
                            weight_norm=True)
        self.conv2 = Conv1d(channels, channels, kernel_size,
                            padding=kernel_size // 2, weight_norm=True)


class MRFBlock(ChainBlock):
    """Sequential MRF layers over a dilation schedule: one residual chain
    at slope 0.1."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__(kernel_size, dilations, LRELU_SLOPE)
        self.layers = nn.ModuleList(MRFLayer(channels, kernel_size, d)
                                    for d in self.dilations)

    def conv_pairs(self):
        return [(layer.conv1, layer.conv2) for layer in self.layers]


class MRFSourceModule(nn.Module):
    """Sine bank of ``harmonic_num`` + 1 waves -> one excitation channel
    through a biased linear merge and ``tanh``, in float32."""

    def __init__(self, sample_rate: int, harmonic_num: int = 8,
                 zero_noise: bool = False):
        super().__init__()
        self.l_sin_gen = CumsumSineGenerator(sample_rate, harmonic_num,
                                             zero_noise=zero_noise)
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """f0 [B, T_audio, 1] -> [B, T_audio, 1] float32."""
        sines, _, _ = self.l_sin_gen(f0, generator)
        merged = torch.nn.functional.linear(
            sines, self.l_linear.weight.float(), self.l_linear.bias.float())
        return torch.tanh(merged)


class HiFiGANMRFGenerator(nn.Module):
    def __init__(self, in_channel: int, upsample_initial_channel: int,
                 upsample_rates: Sequence[int], upsample_kernel_sizes: Sequence[int],
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilations: Sequence[Sequence[int]], gin_channels: int,
                 sample_rate: int, harmonic_num: int = 8, zero_noise: bool = False):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.num_kernels = len(resblock_kernel_sizes)
        self.m_source = MRFSourceModule(sample_rate, harmonic_num, zero_noise)
        self.conv_pre = Conv1d(in_channel, upsample_initial_channel, 7, padding=3,
                               weight_norm=True)
        self.cond = (Conv1d(gin_channels, upsample_initial_channel, 1)
                     if gin_channels else None)
        ups, noise_convs, mrfs = [], [], []
        c_in = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            padding = (k - u) // 2 if u % 2 == 0 else u // 2 + u % 2
            ups.append(ConvTranspose1d(c_in, ch, k, stride=u, padding=padding,
                                       output_padding=u % 2))
            stride, nk, npad = source_downsample_geometry(upsample_rates, i)
            noise_convs.append(Conv1d(1, ch, nk, stride=stride, padding=npad))
            mrfs.append(nn.ModuleList(
                MRFBlock(ch, rk, tuple(rd))
                for rk, rd in zip(resblock_kernel_sizes, resblock_dilations)))
            c_in = ch
        self.upsamples = nn.ModuleList(ups)
        self.noise_convs = nn.ModuleList(noise_convs)
        self.mrfs = nn.ModuleList(mrfs)
        self.conv_post = Conv1d(c_in, 1, 7, padding=3, weight_norm=True)
        self._stage_caches = [WeightCache() for _ in ups]

    def forward(self, x: torch.Tensor, f0: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T_frames], f0 [B, T_frames], g [B, gin, 1] ->
        audio [B, 1, T_audio]."""
        upp = math.prod(self.upsample_rates)
        f0_up = torch.repeat_interleave(f0.float()[..., None], upp, dim=1)
        har_source = self.m_source(f0_up, generator).transpose(1, 2)
        x = self.conv_pre(x)
        if g is not None and self.cond is not None:
            x = x + self.cond(g)
        for i, (up, noise_conv) in enumerate(zip(self.upsamples, self.noise_convs)):
            x = up(leaky_relu(x))
            x = x + noise_conv(har_source)
            x = nsf._resblock_stage(x, self.mrfs[i], self._stage_caches[i])
        x = self.conv_post(leaky_relu(x, 0.01))
        return torch.tanh(x)
