"""Text (content-feature) encoder, port of ``rvc_tpu/models/encoders.py``'s
``TextEncoder``: features + coarse pitch -> prior stats (m_p, logs_p)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .attentions import Encoder
from .commons import Conv1d, sequence_mask


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
