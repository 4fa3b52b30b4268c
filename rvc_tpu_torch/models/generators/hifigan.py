"""Plain HiFi-GAN decoder, the no-F0 model's (port of
``rvc_tpu/models/generators/hifigan.py``).

The NSF decoder without the sine source and its noise convs: transposed-conv
upsampling with padding (k - u) // 2 and no output padding, each stage tail
through ``nsf._resblock_stage`` (routed as the NSF decoder's; looked
up on the module at each call, so a hook on it sees both decoders), with the
stage tails' packed weights cached per stage as the NSF decoder does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...utils.weight_cache import WeightCache
from ..commons import Conv1d, ConvTranspose1d, ResBlock, leaky_relu
from . import nsf


class HiFiGANGenerator(nn.Module):
    def __init__(self, initial_channel: int,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int = 0):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7,
                               padding=3)
        self.cond = (Conv1d(gin_channels, upsample_initial_channel, 1)
                     if gin_channels else None)
        ups, resblocks = [], []
        c_in = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            ups.append(ConvTranspose1d(c_in, ch, k, stride=u, padding=(k - u) // 2))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                resblocks.append(ResBlock(ch, rk, tuple(rd)))
            c_in = ch
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        self.conv_post = Conv1d(c_in, 1, 7, padding=3, bias=False)
        self._stage_caches = [WeightCache() for _ in ups]

    def forward(self, x: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C, T_frames], g [B, gin, 1] -> audio [B, 1, T_audio]."""
        x = self.conv_pre(x)
        if g is not None and self.cond is not None:
            x = x + self.cond(g)
        nk = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            x = nsf._resblock_stage(x, self.resblocks[i * nk:(i + 1) * nk],
                                    self._stage_caches[i])
        x = self.conv_post(leaky_relu(x, 0.01))
        return torch.tanh(x)
