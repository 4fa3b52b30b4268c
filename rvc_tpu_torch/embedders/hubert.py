"""HuBERT / ContentVec content encoder (port of
``rvc_tpu/embedders/hubert.py``'s ``FlaxHubert``): a 7-layer conv feature
extractor with group norm on the first layer, a grouped conv positional
embedding (kernel 128, 16 groups, trailing sample dropped), and 12 post-LN
transformer layers with plain matmul + softmax attention.

Module names follow ``transformers.HubertModel`` (the layout
``convert_torch_hubert`` in the JAX package reads), except that the
positional conv's weight norm is stored per output channel
(``weight_g`` [C, 1, 1]), the form the JAX parameters carry."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..models.commons import weight_norm


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    final_proj_dim: Optional[int] = None


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, s: int, group_norm: bool,
                 eps: float):
        super().__init__()
        self.stride, self.eps = s, eps
        self.conv = nn.Conv1d(c_in, c_out, k, stride=s, bias=False)
        self.layer_norm = nn.GroupNorm(c_out, c_out, eps=eps) if group_norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, i == 0, cfg.layer_norm_eps)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, audio):  # [B, T] -> [B, C, frames]
        x = audio[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PosConv(nn.Module):
    """Weight-normalized grouped conv positional embedding + GELU."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        c, k = cfg.hidden_size, cfg.num_conv_pos_embeddings
        self.groups, self.k = cfg.num_conv_pos_embedding_groups, k
        self.weight_g = nn.Parameter(torch.ones(c, 1, 1))
        self.weight_v = nn.Parameter(torch.zeros(c, c // self.groups, k))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):  # [B, T, C]
        w = weight_norm(self.weight_v, self.weight_g, dim=0)
        y = F.conv1d(x.transpose(1, 2), w, self.bias, padding=self.k // 2,
                     groups=self.groups)
        if self.k % 2 == 0:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class PosConvEmbed(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.conv = PosConv(cfg)

    def forward(self, x):
        return self.conv(x)


class Attention(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        c = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj, self.k_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.v_proj, self.out_proj = nn.Linear(c, c), nn.Linear(c, c)

    def forward(self, x):  # [B, T, C]
        b, t, c = x.shape
        h, hd = self.num_heads, c // self.num_heads

        def split(a):
            return a.reshape(b, t, h, hd).transpose(1, 2)

        q = split(self.q_proj(x)) * hd ** -0.5
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        p = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        out = (p @ v).transpose(1, 2).reshape(b, t, c)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-LN transformer encoder layer."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.pos_conv_embed = PosConvEmbed(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_layers))

    def forward(self, x):
        x = self.layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x)
        return x


class Hubert(nn.Module):
    def __init__(self, cfg: HubertConfig = HubertConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)
        self.final_proj = (nn.Linear(cfg.hidden_size, cfg.final_proj_dim)
                           if cfg.final_proj_dim else None)

    @torch.no_grad()
    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [B, T] 16 kHz -> last hidden state [B, T // 320, H]."""
        dtype = self.feature_projection.projection.weight.dtype
        h = self.feature_extractor(audio.to(dtype)).transpose(1, 2)
        h = self.encoder(self.feature_projection(h))
        if self.final_proj is not None:
            h = self.final_proj(h)
        return h

    @staticmethod
    def build(cfg: HubertConfig = HubertConfig(),
              device: Union[str, torch.device] = "cuda") -> "Hubert":
        return Hubert(cfg).to(resolve_device(device)).eval()
