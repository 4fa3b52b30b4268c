"""Relative-position transformer encoder (port of
``rvc_tpu/models/attentions.py``): windowed relative-position multi-head
attention (window 10) in its dense form, the conv FFN and the post-LN
encoder stack. Activations are [B, C, T]."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .commons import Conv1d


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L-1] relative logits -> [B, H, L, L] absolute logits."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] attention weights -> [B, H, L, 2L-1] relative weights."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def _window_rel_embeddings(emb: torch.Tensor, length: int,
                           window: int) -> torch.Tensor:
    """[n, 2w+1, d] table -> [n, 2L-1, d] for sequence length L."""
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    """Self-attention with learned windowed relative-position embeddings
    (shared across heads)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 10):
        super().__init__()
        self.channels, self.n_heads, self.window_size = channels, n_heads, window_size
        d = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window_size + 1, d))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window_size + 1, d))

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        h, d = self.n_heads, c // self.n_heads

        def heads(a):  # [B, C, T] -> [B, H, T, d]
            return a.reshape(b, h, d, t).transpose(2, 3)

        q, k, v = heads(self.conv_q(x)), heads(self.conv_k(x)), heads(self.conv_v(x))
        qs = q * d ** -0.5
        scores = (qs @ k.transpose(-1, -2)).float()
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        rel_k = _window_rel_embeddings(self.emb_rel_k, t, self.window_size)
        rel_logits = (qs @ rel_k.to(qs.dtype).transpose(-1, -2)).float()
        scores = scores + _rel_to_abs(rel_logits)
        p_attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = p_attn @ v
        rel_v = _window_rel_embeddings(self.emb_rel_v, t, self.window_size)
        out = out + _abs_to_rel(p_attn) @ rel_v.to(v.dtype)
        out = out.transpose(2, 3).reshape(b, c, t)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv feed-forward block (ReLU)."""

    def __init__(self, channels: int, filter_channels: int, kernel_size: int):
        super().__init__()
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, channels, kernel_size)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.conv_1(x * x_mask))
        return self.conv_2(y * x_mask) * x_mask


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, C, T] (reference
    ``gamma``/``beta`` parameter names)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.transpose(1, 2), (x.shape[1],), self.gamma,
                         self.beta, self.eps)
        return y.transpose(1, 2)


class Encoder(nn.Module):
    """Stack of (rel-pos attention + conv FFN) with post-layernorm."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 window_size: int = 10):
        super().__init__()
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden_channels, hidden_channels, n_heads,
                               window_size) for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(
            LayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, filter_channels, kernel_size)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(
            LayerNorm(hidden_channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        # x_mask [B, 1, T]; keys masked in attention
        attn_mask = x_mask[:, :, None, :]  # [B, 1, 1, T]
        x = x * x_mask
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1,
                                     self.ffn_layers, self.norm_layers_2):
            x = n1(x + attn(x, attn_mask))
            x = n2(x + ffn(x, x_mask))
        return x * x_mask
