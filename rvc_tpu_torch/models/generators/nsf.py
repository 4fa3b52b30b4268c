"""NSF-HiFi-GAN decoder (port of ``rvc_tpu/models/generators/nsf.py``).

A sine excitation at the output rate is injected, through strided noise
convs, after every transposed-conv upsample. Each stage tail runs through
the hand-written kernels of ``ops/resblock.py``, as ``stage_route`` says:
one launch of K1 (bf16) or of the narrow chain kernel (f32) for the whole
stage where that kernel's planner takes it, else each chain on its own
(``resblock_chain``: the narrow kernel or K2, as ``chain_route`` says),
which at the 48 kHz serving shapes is the split the JAX gates make (K1 for
C = 128, 64, 32; K2 for C = 256). Every config the JAX package takes runs
on the kernels. The kernels' packed weights are cached (per stage for K1
and the narrow kernel, per chain otherwise), so a second conversion folds
and packs nothing.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.resblock import mrf_stage
from ...utils.weight_cache import WeightCache
from ..commons import (ChainBlock, Conv1d, ConvTranspose1d, ResBlock,
                       leaky_relu, source_downsample_geometry)
from .sine import SineGenerator


def _resblock_stage(x: torch.Tensor, blocks: Sequence[ChainBlock],
                    cache: Optional[WeightCache] = None) -> torch.Tensor:
    """One decoder stage tail: the mean over the parallel residual chains
    (``ResBlock``s, or the MRF decoder's ``MRFBlock``s: the same function).
    Blocks that share their dilations and slope go to ``mrf_stage``, which
    routes the stage (``stage_route``); ``cache`` keeps its packed weights.
    Blocks that differ run one by one."""
    dil0, slope = blocks[0].dilations, blocks[0].slope
    if all(blk.dilations == dil0 and blk.slope == slope for blk in blocks):
        return mrf_stage(x.contiguous(), [blk.chain_weights() for blk in blocks],
                         [blk.kernel_size for blk in blocks], dil0,
                         slope=slope, cache=cache)
    xs = None
    for blk in blocks:
        out = blk(x.contiguous())
        xs = out if xs is None else xs + out
    return xs / len(blocks)


class SourceModuleHnNSF(nn.Module):
    """Sine bank -> one excitation channel via a linear merge and tanh."""

    def __init__(self, sample_rate: int, harmonic_num: int = 0,
                 zero_noise: bool = False):
        super().__init__()
        self.l_sin_gen = SineGenerator(sample_rate, harmonic_num,
                                       zero_noise=zero_noise)
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0: torch.Tensor, upsample_factor: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        sines, _, _ = self.l_sin_gen(f0, upsample_factor, generator)
        merged = torch.nn.functional.linear(
            sines, self.l_linear.weight.float(), self.l_linear.bias.float())
        return torch.tanh(merged)  # [B, T_audio, 1] float32


class HiFiGANNSFGenerator(nn.Module):
    def __init__(self, initial_channel: int,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int,
                 sr: int, harmonic_num: int = 0, zero_noise: bool = False):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.num_kernels = len(resblock_kernel_sizes)
        self.m_source = SourceModuleHnNSF(sr, harmonic_num, zero_noise)
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7,
                               padding=3)
        self.cond = (Conv1d(gin_channels, upsample_initial_channel, 1)
                     if gin_channels else None)
        n_up = len(upsample_rates)
        channels = [upsample_initial_channel // (2 ** (i + 1)) for i in range(n_up)]
        ups, noise_convs, resblocks = [], [], []
        c_in = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            padding = (k - u) // 2 if u % 2 == 0 else u // 2 + u % 2
            ups.append(ConvTranspose1d(c_in, channels[i], k, stride=u,
                                       padding=padding, output_padding=u % 2))
            stride, nk, npad = source_downsample_geometry(upsample_rates, i)
            noise_convs.append(Conv1d(1, channels[i], nk, stride=stride,
                                      padding=npad))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                resblocks.append(ResBlock(channels[i], rk, tuple(rd)))
            c_in = channels[i]
        self.ups = nn.ModuleList(ups)
        self.noise_convs = nn.ModuleList(noise_convs)
        self.resblocks = nn.ModuleList(resblocks)
        self.conv_post = Conv1d(c_in, 1, 7, padding=3, bias=False)
        self._stage_caches = [WeightCache() for _ in range(n_up)]

    def forward(self, x: torch.Tensor, f0: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T_frames], f0 [B, T_frames], g [B, gin, 1] ->
        audio [B, 1, T_audio]."""
        upp = math.prod(self.upsample_rates)
        har_source = self.m_source(f0, upp, generator).transpose(1, 2)
        x = self.conv_pre(x)
        if g is not None and self.cond is not None:
            x = x + self.cond(g)
        for i, (up, noise_conv) in enumerate(zip(self.ups, self.noise_convs)):
            x = up(leaky_relu(x))
            x = x + noise_conv(har_source)
            nk = self.num_kernels
            x = _resblock_stage(x, self.resblocks[i * nk:(i + 1) * nk],
                                self._stage_caches[i])
        x = self.conv_post(leaky_relu(x, 0.01))
        return torch.tanh(x)
