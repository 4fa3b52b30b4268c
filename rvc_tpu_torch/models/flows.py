"""Normalizing flow, reverse pass only (port of ``rvc_tpu/models/flows.py``):
mean-only residual coupling layers with a channel flip between them."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .commons import Conv1d, WaveNet


class ResidualCouplingLayer(nn.Module):
    def __init__(self, channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1,
                 n_layers: int = 3, gin_channels: int = 256):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WaveNet(hidden_channels, kernel_size, dilation_rate,
                           n_layers, gin_channels=gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1)

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingBlock(nn.Module):
    """n_flows x (coupling -> channel flip). The flip modules of the
    reference sit at the odd indices of ``flows``, so the couplings keep the
    reference names ``flows.{0,2,4,6}``."""

    def __init__(self, channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1,
                 n_layers: int = 3, n_flows: int = 4, gin_channels: int = 256):
        super().__init__()
        layers = []
        for _ in range(n_flows):
            layers += [ResidualCouplingLayer(channels, hidden_channels,
                                             kernel_size, dilation_rate,
                                             n_layers, gin_channels),
                       nn.Identity()]
        self.flows = nn.ModuleList(layers)

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in reversed(self.flows[0::2]):
            x = torch.flip(x, dims=[1])
            x = layer.reverse(x, x_mask, g=g)
        return x
