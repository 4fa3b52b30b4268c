"""The VITS-style voice-conversion synthesizer, inference subset (port of
``rvc_tpu/models/synthesizer.py``'s ``Synthesizer.infer`` with the
NSF-HiFi-GAN decoder): prior sample -> inverse flow -> decode. The posterior
encoder and the training forward come with the training port."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from .encoders import TextEncoder
from .flows import ResidualCouplingBlock
from .generators.nsf import HiFiGANNSFGenerator


class Synthesizer(nn.Module):
    def __init__(self, inter_channels: int = 192, hidden_channels: int = 192,
                 filter_channels: int = 768, n_heads: int = 2,
                 n_layers: int = 6, kernel_size: int = 3,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = (
                     (1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 upsample_rates: Sequence[int] = (12, 10, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (24, 20, 4, 4),
                 spk_embed_dim: int = 109, gin_channels: int = 256,
                 sr: int = 48000, text_enc_hidden_dim: int = 768,
                 flow_layers: int = 3, zero_noise: bool = False):
        super().__init__()
        self.zero_noise = zero_noise
        self.enc_p = TextEncoder(inter_channels, hidden_channels,
                                 filter_channels, n_heads, n_layers,
                                 kernel_size, text_enc_hidden_dim, use_f0=True)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5,
                                          1, flow_layers,
                                          gin_channels=gin_channels)
        self.emb_g = nn.Embedding(spk_embed_dim, gin_channels)
        self.dec = HiFiGANNSFGenerator(
            inter_channels, resblock_kernel_sizes, resblock_dilation_sizes,
            upsample_rates, upsample_initial_channel, upsample_kernel_sizes,
            gin_channels=gin_channels, sr=sr, zero_noise=zero_noise)

    @torch.no_grad()
    def infer(self, phone: torch.Tensor, phone_lengths: torch.Tensor,
              pitch: torch.Tensor, nsff0: torch.Tensor, sid: torch.Tensor,
              temperature: float = 0.66666,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """phone [B, T, D], lengths [B], pitch [B, T] int, nsff0 [B, T] f0 Hz,
        sid [B] -> (audio [B, T_audio, 1], x_mask [B, T, 1])."""
        g = self.emb_g(sid)[:, :, None]                      # [B, gin, 1]
        m_p, logs_p, x_mask = self.enc_p(phone, pitch, phone_lengths)
        if self.zero_noise or temperature == 0.0:
            z_p = m_p * x_mask
        else:
            eps = torch.randn(m_p.shape, generator=generator,
                              device=m_p.device).to(m_p.dtype)
            z_p = (m_p + torch.exp(logs_p) * eps * temperature) * x_mask
        z = self.flow.reverse(z_p, x_mask, g=g)
        o = self.dec(z * x_mask, nsff0, g=g, generator=generator)
        return o.transpose(1, 2), x_mask.transpose(1, 2)

    @staticmethod
    def from_config(cfg, device: Union[str, torch.device] = "cuda",
                    **overrides) -> "Synthesizer":
        """Build from an ExperimentConfig on ``device`` (the card by
        default; raises without one unless ``device="cpu"``)."""
        dev = resolve_device(device)
        m = cfg.model
        kw = dict(
            inter_channels=m.inter_channels, hidden_channels=m.hidden_channels,
            filter_channels=m.filter_channels, n_heads=m.n_heads,
            n_layers=m.n_layers, kernel_size=m.kernel_size,
            resblock_kernel_sizes=m.resblock_kernel_sizes,
            resblock_dilation_sizes=m.resblock_dilation_sizes,
            upsample_rates=m.upsample_rates,
            upsample_initial_channel=m.upsample_initial_channel,
            upsample_kernel_sizes=m.upsample_kernel_sizes,
            spk_embed_dim=m.spk_embed_dim, gin_channels=m.gin_channels,
            sr=cfg.data.sample_rate, text_enc_hidden_dim=m.text_enc_hidden_dim)
        kw.update(overrides)
        if m.vocoder != "HiFi-GAN" or not m.use_f0:
            raise NotImplementedError(
                "the port covers the pitch-guided NSF-HiFi-GAN decoder only")
        return Synthesizer(**kw).to(dev).eval()
