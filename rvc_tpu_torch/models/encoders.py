"""Content and posterior encoders (port of ``rvc_tpu/models/encoders.py``):
``TextEncoder`` maps features + coarse pitch to the prior stats (m_p,
logs_p); ``PosteriorEncoder`` maps the linear spectrogram to the posterior
latent z, for training."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .attentions import Encoder
from .commons import Conv1d, WaveNet, draw, sequence_mask


class TextEncoder(nn.Module):
    def __init__(self, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, embedding_dim: int, use_f0: bool = True):
        super().__init__()
        self.out_channels, self.hidden_channels = out_channels, hidden_channels
        self.emb_phone = nn.Linear(embedding_dim, hidden_channels)
        self.emb_pitch = nn.Embedding(256, hidden_channels) if use_f0 else None
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, phone: torch.Tensor, pitch: Optional[torch.Tensor],
                lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """phone [B, T, D], pitch [B, T] int, lengths [B] ->
        m, logs [B, C, T] and x_mask [B, 1, T]."""
        x = self.emb_phone(phone.to(self.emb_phone.weight.dtype))
        if self.emb_pitch is not None and pitch is not None:
            x = x + self.emb_pitch(pitch)
        x = x * math.sqrt(self.hidden_channels)
        x = torch.where(x >= 0, x, 0.1 * x).transpose(1, 2)  # [B, H, T]
        x_mask = sequence_mask(lengths, x.shape[2])[:, None, :].to(x.dtype)
        x = self.encoder(x, x_mask)
        stats = self.proj(x) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        return m, logs, x_mask


class PosteriorEncoder(nn.Module):
    """Linear spectrogram -> posterior latent z = m + noise * exp(logs): a
    WaveNet with speaker conditioning between two 1x1 convs (reference
    encoders.py:150-209). ``zero_noise`` returns z = m, as the JAX module."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 256, zero_noise: bool = False):
        super().__init__()
        self.out_channels, self.zero_noise = out_channels, zero_noise
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WaveNet(hidden_channels, kernel_size, dilation_rate,
                           n_layers, gin_channels=gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, y: torch.Tensor, y_lengths: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """y [B, spec, T], lengths [B], g [B, gin, 1] -> z, m, logs
        [B, C, T] and y_mask [B, 1, T] (float32, as the JAX module's mask)."""
        y_mask = sequence_mask(y_lengths, y.shape[2])[:, None, :]
        x = self.pre(y) * y_mask
        x = self.enc(x, y_mask, g=g)
        stats = self.proj(x) * y_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        if self.zero_noise:
            z = m * y_mask
        else:
            noise = draw("randn", m.shape, generator, m.device).to(m.dtype)
            z = (m + noise * torch.exp(logs)) * y_mask
        return z, m, logs, y_mask
