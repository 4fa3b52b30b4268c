"""The VITS-style voice-conversion synthesizer (port of
``rvc_tpu/models/synthesizer.py``) with every decoder of the JAX package:
for pitch-guided models NSF HiFi-GAN (``vocoder="HiFi-GAN"``), MRF
HiFi-GAN or RefineGAN; for models without pitch the plain HiFi-GAN (the
other two need pitch and raise ``ValueError``, as JAX's do).

  - ``infer``: prior sample -> inverse flow -> decode;
  - ``forward`` (training, built with ``posterior=True``): posterior z from
    the real spectrogram, flow z -> z_p, a latent slice decoded.

A model built for inference has no posterior encoder (``enc_q``), which a
deployable ``.pth`` does not carry.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from ..utils.profiling import span
from .commons import draw, rand_slice_segments, slice_segments
from .encoders import PosteriorEncoder, TextEncoder
from .flows import ResidualCouplingBlock
from .generators.hifigan import HiFiGANGenerator
from .generators.mrf import HiFiGANMRFGenerator
from .generators.nsf import HiFiGANNSFGenerator
from .generators.refinegan import RefineGANGenerator

VOCODERS = ("HiFi-GAN", "MRF HiFi-GAN", "RefineGAN")


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
                 flow_layers: int = 3, zero_noise: bool = False,
                 use_f0: bool = True, posterior: bool = False,
                 spec_channels: int = 1025, segment_size: int = 36,
                 posterior_layers: int = 16, vocoder: str = "HiFi-GAN"):
        super().__init__()
        self.zero_noise, self.use_f0 = zero_noise, use_f0
        self.segment_size = segment_size  # latent frames of a training slice
        self.enc_p = TextEncoder(inter_channels, hidden_channels,
                                 filter_channels, n_heads, n_layers,
                                 kernel_size, text_enc_hidden_dim, use_f0=use_f0)
        if posterior:
            self.enc_q = PosteriorEncoder(spec_channels, inter_channels,
                                          hidden_channels, 5, 1,
                                          posterior_layers,
                                          gin_channels=gin_channels,
                                          zero_noise=zero_noise)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5,
                                          1, flow_layers,
                                          gin_channels=gin_channels)
        self.emb_g = nn.Embedding(spk_embed_dim, gin_channels)
        if vocoder not in VOCODERS:
            raise ValueError(f"unknown vocoder {vocoder!r}; one of {VOCODERS}")
        self.vocoder = vocoder
        if use_f0 and vocoder == "MRF HiFi-GAN":
            self.dec = HiFiGANMRFGenerator(
                inter_channels, upsample_initial_channel, upsample_rates,
                upsample_kernel_sizes, resblock_kernel_sizes,
                resblock_dilation_sizes, gin_channels, sr, harmonic_num=8,
                zero_noise=zero_noise)
        elif use_f0 and vocoder == "RefineGAN":
            # JAX builds it from the rate, the upsample rates and the
            # latent's width only (its own 512 channels)
            self.dec = RefineGANGenerator(
                sample_rate=sr, upsample_rates=upsample_rates,
                num_mels=inter_channels, gin_channels=gin_channels,
                zero_noise=zero_noise)
        elif use_f0:
            self.dec = HiFiGANNSFGenerator(
                inter_channels, resblock_kernel_sizes, resblock_dilation_sizes,
                upsample_rates, upsample_initial_channel, upsample_kernel_sizes,
                gin_channels=gin_channels, sr=sr, zero_noise=zero_noise)
        elif vocoder != "HiFi-GAN":
            raise ValueError(f"{vocoder} requires pitch guidance (use_f0)")
        else:
            self.dec = HiFiGANGenerator(
                inter_channels, resblock_kernel_sizes, resblock_dilation_sizes,
                upsample_rates, upsample_initial_channel, upsample_kernel_sizes,
                gin_channels=gin_channels)

    def forward(self, phone: torch.Tensor, phone_lengths: torch.Tensor,
                pitch: Optional[torch.Tensor], pitchf: Optional[torch.Tensor],
                y: torch.Tensor, y_lengths: torch.Tensor, ds: torch.Tensor,
                ids_slice: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Training forward. phone [B, T, D], pitch [B, T] int, pitchf [B, T]
        f0 Hz, y [B, T, spec] linear spectrogram, lengths [B], ds [B] speaker
        ids; ``ids_slice`` [B] latent slice starts (drawn from ``generator``
        when None, as the JAX step draws them outside the model). Returns
        (o [B, segment * upp, 1], ids_slice, x_mask [B, T, 1], y_mask
        [B, T, 1], (z, z_p, m_p, logs_p, m_q, logs_q) each [B, T, C]): the
        JAX module's outputs in its layout."""
        g = self.emb_g(ds)[:, :, None]
        m_p, logs_p, x_mask = self.enc_p(phone, pitch if self.use_f0 else None,
                                         phone_lengths)
        z, m_q, logs_q, y_mask = self.enc_q(y.transpose(1, 2), y_lengths, g=g,
                                            generator=generator)
        z_p = self.flow(z, y_mask, g=g)
        zt = z.transpose(1, 2)
        if ids_slice is None:
            z_slice, ids_slice = rand_slice_segments(zt, y_lengths,
                                                     self.segment_size, generator)
        else:
            z_slice = slice_segments(zt, ids_slice, self.segment_size)
        z_slice = z_slice.transpose(1, 2)
        if self.use_f0:
            f0_slice = slice_segments(pitchf, ids_slice, self.segment_size)
            o = self.dec(z_slice, f0_slice, g=g, generator=generator)
        else:
            o = self.dec(z_slice, g=g)
        vae = tuple(t.transpose(1, 2) for t in (z, z_p, m_p, logs_p, m_q, logs_q))
        return (o.transpose(1, 2), ids_slice, x_mask.transpose(1, 2),
                y_mask.transpose(1, 2), vae)

    @torch.no_grad()
    def infer(self, phone: torch.Tensor, phone_lengths: torch.Tensor,
              pitch: Optional[torch.Tensor], nsff0: Optional[torch.Tensor],
              sid: torch.Tensor, temperature: float = 0.66666,
              generator: Optional[torch.Generator] = None,
              rate: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """phone [B, T, D], lengths [B], pitch [B, T] int, nsff0 [B, T] f0 Hz
        (both ignored, and may be None, without pitch guidance), sid [B] ->
        (audio [B, T_audio, 1], x_mask [B, T, 1]).

        ``rate``: the streaming head-trim (reference synthesizers.py:250-253):
        only the trailing ``rate`` share of the latent frames is decoded
        (the first int(T * (1 - rate)) are dropped after the prior
        sample)."""
        g = self.emb_g(sid)[:, :, None]                      # [B, gin, 1]
        m_p, logs_p, x_mask = self.enc_p(phone, pitch if self.use_f0 else None,
                                         phone_lengths)
        if self.zero_noise or temperature == 0.0:
            z_p = m_p * x_mask
        else:
            eps = draw("randn", m_p.shape, generator, m_p.device).to(m_p.dtype)
            z_p = (m_p + torch.exp(logs_p) * eps * temperature) * x_mask
        if rate is not None:
            head = int(z_p.shape[2] * (1.0 - float(rate)))
            z_p, x_mask = z_p[:, :, head:], x_mask[:, :, head:]
            if self.use_f0 and nsff0 is not None:
                nsff0 = nsff0[:, head:]
        z = self.flow.reverse(z_p, x_mask, g=g)
        with span("rvc.decoder"):
            if self.use_f0:
                o = self.dec(z * x_mask, nsff0, g=g, generator=generator)
            else:
                o = self.dec(z * x_mask, g=g)
        return o.transpose(1, 2), x_mask.transpose(1, 2)

    @staticmethod
    def from_config(cfg, device: Union[str, torch.device] = "cuda",
                    train: bool = False, **overrides) -> "Synthesizer":
        """Build from an ExperimentConfig on ``device`` (the card by
        default; raises without one unless ``device="cpu"``). ``train``
        adds the posterior encoder, in train mode."""
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
            sr=cfg.data.sample_rate, text_enc_hidden_dim=m.text_enc_hidden_dim,
            use_f0=m.use_f0, vocoder=m.vocoder)
        if train:
            kw.update(posterior=True, spec_channels=cfg.data.spec_channels,
                      segment_size=cfg.train.segment_size // cfg.data.hop_length)
        kw.update(overrides)
        model = Synthesizer(**kw).to(dev)
        return model.train() if train else model.eval()
