"""The discriminator zoo (port of ``rvc_tpu/models/custom_discriminators.py``):
MPD v1, the multi-resolution discriminator (MRD), the multi-scale STFT
discriminator, the sub-band CQT discriminator, FreGAN's multi-scale and
ResWise multi-period discriminators, the multi-mel-scale discriminator
(MMSD), ``CombinedDiscriminator`` and the registry of names.

Every member returns (real logits, fake logits, real fmaps, fake fmaps),
one entry per sub-discriminator, as ``MultiPeriodDiscriminator`` does, so
the step's losses take any of them. Inputs are [B, T, 1]; each
sub-discriminator runs real and fake as one doubled batch ([2B, 1, T]).
Spectral inputs are [B, C, frames, bins] (the JAX package's NHWC with H
the frames, W the bins, moved to NCHW); feature maps are in torch layout.

Parameter names follow the JAX tree (``disc_r1024.conv_0.weight_v``, ...;
a combination's members under ``discriminators.{i}``), so ``convert``
carries a flax tree across one to one; the MPDs keep the reference layout
of ``MultiPeriodDiscriminator``. The fixed filter banks (the CQT kernels,
the resampling FIRs, the STFT windows) are float32 tensors made at call
time, never parameters: under the step's bf16 cast they stay float32, and
the spectral fronts compute in float32 where the JAX package promotes.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import frame_signal, hann_window, stft_magnitude
from .commons import Conv1d, leaky_relu
from .discriminators import (MultiPeriodDiscriminator, NormConv1d, NormConv2d,
                             run_discriminators, run_discriminators_doubled)

MPD_V1_PERIODS = (2, 3, 5, 7, 11)
MPD_V2_PERIODS = (2, 3, 5, 7, 11, 17, 23, 37)
CQT_FMIN = 32.70319566257483


class _JaxNamed(nn.Module):
    """A member whose parameter names are the JAX tree's: a parameter's
    gradient-norm group is its first name."""

    def group_of(self, name: str) -> str:
        return name.split(".")[0]


def _same_pad(k: Tuple[int, int]) -> Tuple[int, int]:
    return ((k[0] - 1) // 2, (k[1] - 1) // 2)


def _flat(h: torch.Tensor) -> torch.Tensor:
    return h.reshape(h.shape[0], -1)


# -- MPD v1 -------------------------------------------------------------------

class MultiPeriodDiscriminatorV1(MultiPeriodDiscriminator):
    """The RVC v1 period set (2, 3, 5, 7, 11) in the reference layout."""

    def __init__(self):
        super().__init__(MPD_V1_PERIODS)


# -- MRD ----------------------------------------------------------------------

class DiscriminatorR(nn.Module):
    """Single-resolution magnitude-STFT discriminator: reflect padding of
    (n_fft - hop) / 2, a non-centred STFT (periodic Hann of ``win``
    samples, centred in n_fft), magnitude with a 1e-12 floor; five (3, 9)
    convs (strides 1, 2, 2, 2 on frequency, then a (3, 3)) and a post
    conv."""

    SPECS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
             ((3, 9), (1, 2)), ((3, 3), (1, 1)))

    def __init__(self, n_fft: int, hop: int, win: int, channels: int = 32):
        super().__init__()
        self.n_fft, self.hop, self.win = n_fft, hop, win
        for i, (k, s) in enumerate(self.SPECS):
            setattr(self, f"conv_{i}", NormConv2d(1 if i == 0 else channels,
                                                  channels, k, s, _same_pad(k)))
        self.conv_post = NormConv2d(channels, 1, (3, 3), (1, 1), (1, 1))

    def forward(self, x: torch.Tensor):
        wav = x[:, 0]
        pad = (self.n_fft - self.hop) // 2
        wav = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
        h = stft_magnitude(wav, self.n_fft, self.hop, self.win, eps=1e-12)[:, None]
        fmap = []
        for i in range(len(self.SPECS)):
            h = leaky_relu(getattr(self, f"conv_{i}")(h))
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return _flat(h), fmap


class MultiResolutionDiscriminator(_JaxNamed):
    RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))

    def __init__(self, resolutions: Sequence[Tuple[int, int, int]] = RESOLUTIONS):
        super().__init__()
        self.names = [f"disc_r{n}" for n, _, _ in resolutions]
        for name, (n, h, w) in zip(self.names, resolutions):
            setattr(self, name, DiscriminatorR(n, h, w))

    def forward(self, y, y_hat):
        return run_discriminators([getattr(self, n) for n in self.names], y, y_hat)


# -- MS-STFT --------------------------------------------------------------------

def _complex_stft(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[B, T] -> [B, 2, frames, n_fft // 2 + 1] (re, im) in float32: frames
    of n_fft at ``hop`` with no padding, a periodic Hann window."""
    frames = frame_signal(wav.float(), n_fft, hop) * hann_window(n_fft, wav.device)
    spec = torch.fft.rfft(frames, dim=-1)
    return torch.stack([spec.real, spec.imag], dim=1)


class _EncodecTrunk(nn.Module):
    """The EnCodec-style trunk of the STFT and CQT discriminators: three
    weight-normed (3, 9) convs with time dilations (1, 2, 4) and stride 2
    on frequency, a (3, 3) conv and a post conv, all at ``channels``."""

    def _add_trunk(self, channels: int, dilations: Sequence[int]) -> None:
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            setattr(self, f"conv_dil{i}", NormConv2d(
                channels, channels, (3, 9), (1, 2), (d, 4), dilation=(d, 1)))
        self.conv_mid = NormConv2d(channels, channels, (3, 3), (1, 1), (1, 1))
        self.conv_post = NormConv2d(channels, 1, (3, 3), (1, 1), (1, 1))

    def _trunk(self, h: torch.Tensor, fmap: List[torch.Tensor], slope: float):
        for i in range(len(self.dilations)):
            h = leaky_relu(getattr(self, f"conv_dil{i}")(h), slope)
            fmap.append(h)
        h = leaky_relu(self.conv_mid(h), slope)
        fmap.append(h)
        return _flat(self.conv_post(h)), fmap


class DiscriminatorSTFT(_EncodecTrunk):
    """EnCodec's complex-STFT discriminator: the STFT with no padding,
    periodic Hann, divided by the window's L2 norm; a plain biased (3, 9)
    conv, the trunk at slope 0.2. Its feature maps are the five activated
    trunk outputs (the post conv's is not one)."""

    def __init__(self, n_fft: int, hop: int, filters: int = 128,
                 max_filters: int = 1024, dilations: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        self.conv_pre = NormConv2d(2, filters, (3, 9), (1, 1), (1, 4), plain=True)
        self._add_trunk(min(filters, max_filters), dilations)

    def forward(self, x: torch.Tensor):
        win_norm = float(np.sqrt(np.sum(
            hann_window(self.n_fft).double().numpy() ** 2)))
        h = _complex_stft(x[:, 0], self.n_fft, self.hop) / win_norm
        h = leaky_relu(self.conv_pre(h), 0.2)
        return self._trunk(h, [h], 0.2)


class MultiScaleSTFTDiscriminator(_JaxNamed):
    def __init__(self, n_ffts: Sequence[int] = (1024, 2048, 512),
                 hops: Sequence[int] = (256, 512, 256), filters: int = 128):
        super().__init__()
        self.names = [f"disc_stft{n}" for n in n_ffts]
        for name, n, h in zip(self.names, n_ffts, hops):
            setattr(self, name, DiscriminatorSTFT(n, h, filters=filters))

    def forward(self, y, y_hat):
        return run_discriminators([getattr(self, n) for n in self.names], y, y_hat)


# -- MSSB-CQT -------------------------------------------------------------------

def cqt_kernels(sr: int, fmin: float, n_bins: int,
                bins_per_octave: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """The complex CQT basis (nnAudio's CQT2010 kernels): per bin a
    periodic-Hann-windowed complex exponential of ceil(Q sr / f) samples,
    centred in a power-of-two length; (cos [n_bins, klen], sin, klen)."""
    freqs = fmin * (2.0 ** (np.arange(n_bins) / bins_per_octave))
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lengths = np.ceil(q * sr / freqs).astype(int)
    klen = int(2 ** np.ceil(np.log2(lengths.max())))
    cos_k = np.zeros((n_bins, klen), np.float32)
    sin_k = np.zeros((n_bins, klen), np.float32)
    for i, (f, n) in enumerate(zip(freqs, lengths)):
        n = min(n, klen)
        start = (klen - n) // 2
        t = np.arange(n)
        window = 0.5 - 0.5 * np.cos(2.0 * np.pi * t / n)
        phase = 2 * np.pi * f * (t - n / 2) / sr
        cos_k[i, start:start + n] = (window * np.cos(phase) / n).astype(np.float32)
        sin_k[i, start:start + n] = (window * np.sin(phase) / n).astype(np.float32)
    return cos_k, sin_k, klen


@functools.lru_cache(maxsize=None)
def _sinc_lowpass(cutoff: float, half_width: int) -> np.ndarray:
    """Hann-windowed sinc lowpass FIR of 2 * half_width + 1 taps, unit DC
    gain; ``cutoff`` a fraction of Nyquist."""
    n = np.arange(-half_width, half_width + 1)
    h = cutoff * np.sinc(cutoff * n)
    w = 0.5 + 0.5 * np.cos(np.pi * n / half_width)
    k = (h * w).astype(np.float64)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cqt_bank(sr: int, f_top: float, bins_per_octave: int) -> Tuple[np.ndarray, int]:
    """The top octave's bank as conv weights [2 bpo, 1, klen], rows
    interleaved (cos, sin) per bin."""
    cos_k, sin_k, klen = cqt_kernels(sr, f_top, bins_per_octave, bins_per_octave)
    bank = np.stack([cos_k, sin_k], axis=1).reshape(2 * bins_per_octave, klen)
    return bank[:, None, :].copy(), klen


def _fir(x: torch.Tensor, kernel: np.ndarray, stride: int = 1) -> torch.Tensor:
    """[B, T] through a fixed FIR, centred ("same" padding), float32."""
    k = torch.from_numpy(kernel).to(x.device)[None, None, :]
    pad = len(kernel) // 2
    return F.conv1d(x[:, None], k, stride=stride, padding=pad)[:, 0]


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """x2 sinc interpolation: zero-stuffing, then the lowpass at the
    original Nyquist with gain 2."""
    z = torch.stack([x, torch.zeros_like(x)], dim=-1).reshape(x.shape[0], -1)
    return _fir(z, 2.0 * _sinc_lowpass(0.5, 32))


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """Anti-aliased decimation by 2 (CQT2010's early downsampling)."""
    return _fir(x, _sinc_lowpass(0.5, 32), stride=2)


def multirate_cqt(wav: torch.Tensor, sr: int, hop: int, n_octaves: int,
                  bins_per_octave: int, fmin: float = CQT_FMIN) -> torch.Tensor:
    """Complex CQT by CQT2010's multirate scheme: the top octave's short
    bank, one strided conv per octave on a chain of /2-decimated signals.
    ``hop`` must be a multiple of 2^(n_octaves - 1). wav [B, T] at ``sr``
    -> [B, 2 (re, im), T // hop + 1, n_octaves * bpo], bins ascending."""
    if hop % (1 << (n_octaves - 1)):
        raise ValueError(f"CQT hop {hop} is not a multiple of 2^{n_octaves - 1}")
    bank_np, klen = _cqt_bank(sr, fmin * (2.0 ** (n_octaves - 1)), bins_per_octave)
    bank = torch.from_numpy(bank_np).to(wav.device)
    n_frames = wav.shape[1] // hop + 1
    octaves, x = [], wav
    for k in range(n_octaves):
        z = F.conv1d(F.pad(x, (klen // 2, klen // 2))[:, None], bank,
                     stride=hop >> k)                       # [B, 2 bpo, frames_k]
        if z.shape[-1] < n_frames:
            z = F.pad(z, (0, n_frames - z.shape[-1]))
        z = z[..., :n_frames].reshape(z.shape[0], bins_per_octave, 2, n_frames)
        octaves.append(z.permute(0, 2, 3, 1))               # [B, 2, frames, bpo]
        if k + 1 < n_octaves:
            x = _downsample2(x)
    return torch.cat(octaves[::-1], dim=3)


class DiscriminatorCQT(_EncodecTrunk):
    """Complex multirate-CQT discriminator: the input resampled x2 and
    taken to the CQT in float32 (then to the input's dtype, as JAX casts
    it), a plain (3, 9) conv of 2 channels per octave, the bands joined
    along frequency, a plain conv to ``filters`` and the trunk at slope
    0.1; feature maps as ``DiscriminatorSTFT``'s."""

    def __init__(self, sample_rate: int, hop: int = 512, n_octaves: int = 9,
                 bins_per_octave: int = 24, filters: int = 64,
                 max_filters: int = 1024, dilations: Sequence[int] = (1, 2, 4),
                 normalize_volume: bool = False):
        super().__init__()
        self.sample_rate, self.hop = sample_rate, hop
        self.n_octaves, self.bins_per_octave = n_octaves, bins_per_octave
        self.normalize_volume = normalize_volume
        for i in range(n_octaves):
            setattr(self, f"conv_pre_oct{i}",
                    NormConv2d(2, 2, (3, 9), (1, 1), (1, 4), plain=True))
        self.conv_in = NormConv2d(2, filters, (3, 9), (1, 1), (1, 4), plain=True)
        self._add_trunk(min(filters, max_filters), dilations)

    def forward(self, x: torch.Tensor):
        wav = x[:, 0].float()
        if self.normalize_volume:
            wav = wav - wav.mean(dim=-1, keepdim=True)
            wav = 0.8 * wav / (wav.abs().amax(dim=-1, keepdim=True) + 1e-9)
        z = multirate_cqt(_upsample2(wav), self.sample_rate * 2, self.hop,
                          self.n_octaves, self.bins_per_octave).to(x.dtype)
        bpo = self.bins_per_octave
        h = torch.cat([getattr(self, f"conv_pre_oct{i}")(z[..., i * bpo:(i + 1) * bpo])
                       for i in range(self.n_octaves)], dim=3)
        h = leaky_relu(self.conv_in(h), 0.1)
        return self._trunk(h, [h], 0.1)


class MultiScaleSubbandCQTDiscriminator(_JaxNamed):
    """Three CQT discriminators (hops 512, 256, 256; 9 octaves of 24, 36
    and 48 bins; 64 filters) at the training rate."""

    def __init__(self, sample_rate: int = 48000, hops: Sequence[int] = (512, 256, 256),
                 n_octaves: Sequence[int] = (9, 9, 9),
                 bins_per_octaves: Sequence[int] = (24, 36, 48), filters: int = 64):
        super().__init__()
        self.names = [f"disc_cqt{i}" for i in range(len(hops))]
        for name, h, n, b in zip(self.names, hops, n_octaves, bins_per_octaves):
            setattr(self, name, DiscriminatorCQT(sample_rate, hop=h, n_octaves=n,
                                                 bins_per_octave=b, filters=filters))

    def forward(self, y, y_hat):
        return run_discriminators([getattr(self, n) for n in self.names], y, y_hat)


# -- FreGAN: MSD and the ResWise MPD -------------------------------------------

def _haar_dwt(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level of the Haar DWT over time: [B, C, T] -> (high, low), each
    [B, C, T // 2]."""
    t = x.shape[-1] - x.shape[-1] % 2
    even, odd = x[..., 0:t:2], x[..., 1:t:2]
    inv_sqrt2 = 0.7071067811865476
    return (even - odd) * inv_sqrt2, (even + odd) * inv_sqrt2


def _dwt_levels(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """The Haar pyramid's bands after 1..levels levels, each level's bands
    joined along channels in the JAX package's order (level 2:
    hh, hl, lh, ll)."""
    bands, out = [x], []
    for _ in range(levels):
        bands = [b for band in bands for b in _haar_dwt(band)]
        out.append(torch.cat(bands, dim=1))
    return out


class FreGANDiscriminatorS(_JaxNamed):
    """FreGAN's scale discriminator: the Haar levels 1 and 2 of the input,
    each through a 1D conv, joined to the trunk along time after stages 0
    and 1. Every conv spectrally normalized with ``use_spectral_norm``,
    else weight-normalized."""

    SPECS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
             (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
             (1024, 5, 1, 1, 2))

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        sn = use_spectral_norm
        self.dwt_conv1 = NormConv1d(2, 128, 15, stride=1, padding=7, spectral=sn)
        self.dwt_conv2 = NormConv1d(4, 128, 41, stride=2, padding=20, spectral=sn)
        c_in = 1
        for i, (f, k, s, gr, p) in enumerate(self.SPECS):
            setattr(self, f"conv_{i}", NormConv1d(c_in, f, k, stride=s, groups=gr,
                                                  padding=p, spectral=sn))
            c_in = f
        self.conv_post = NormConv1d(c_in, 1, 3, padding=1, spectral=sn)

    def forward(self, x: torch.Tensor):
        d1, d2 = _dwt_levels(x, 2)
        side = {0: self.dwt_conv1(d1), 1: self.dwt_conv2(d2)}
        fmap, h = [], x
        for i in range(len(self.SPECS)):
            h = leaky_relu(getattr(self, f"conv_{i}")(h))
            fmap.append(h)
            if i in side:
                h = torch.cat([h, side[i].to(h.dtype)], dim=2)
        h = self.conv_post(h)
        fmap.append(h)
        return _flat(h), fmap


class MultiScaleDiscriminator(_JaxNamed):
    """FreGAN's ResWise multi-scale discriminator: three scale
    discriminators fed the doubled input, its Haar level 1 (2 channels
    through a 1x1 conv) and level 2 (4 channels through a 1x1 conv); the
    first spectrally normalized."""

    def __init__(self):
        super().__init__()
        self.dwt_conv1 = Conv1d(2, 1, 1, weight_norm=True)
        self.dwt_conv2 = Conv1d(4, 1, 1, weight_norm=True)
        self.disc_s0 = FreGANDiscriminatorS(use_spectral_norm=True)
        self.disc_s1 = FreGANDiscriminatorS()
        self.disc_s2 = FreGANDiscriminatorS()

    def forward(self, y, y_hat):
        xy = torch.cat([y, y_hat], dim=0).transpose(1, 2)
        d1, d2 = _dwt_levels(xy, 2)
        inputs = (xy, self.dwt_conv1(d1), self.dwt_conv2(d2))
        return run_discriminators_doubled(
            [self.disc_s0, self.disc_s1, self.disc_s2], inputs, y.shape[0])


def _to_period_2d(x: torch.Tensor, period: int) -> torch.Tensor:
    """[B, C, T] -> [B, C, T // p, p], reflect-padded to a multiple of p."""
    b, c, t = x.shape
    if t % period:
        x = F.pad(x, (0, period - t % period), mode="reflect")
        t = x.shape[-1]
    return x.view(b, c, t // period, period)


class ResWiseDiscriminatorP(_JaxNamed):
    """FreGAN's period discriminator: the Haar levels 1-3 of the input,
    each squeezed to one channel by a 1x1 conv, folded by the period and
    projected by a strided (5, 1) conv, joined to the trunk along time
    after stages 0, 1 and 2. The trunk's last conv has stride 1."""

    CHANNELS = (32, 128, 512, 1024, 1024)

    def __init__(self, period: int, kernel: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel - 1) // 2
        for lvl, (c_in, c_out) in enumerate(((2, 32), (4, 128), (8, 512)), start=1):
            setattr(self, f"dwt_conv{lvl}", Conv1d(c_in, 1, 1, weight_norm=True))
            setattr(self, f"dwt_proj{lvl}", NormConv2d(1, c_out, (kernel, 1),
                                                       (stride, 1), (pad, 0)))
        c_in = 1
        for i, ch in enumerate(self.CHANNELS):
            setattr(self, f"conv_{i}", NormConv2d(
                c_in, ch, (kernel, 1), (stride, 1) if i < 4 else (1, 1),
                (pad if i < 4 else 2, 0)))
            c_in = ch
        self.conv_post = NormConv2d(c_in, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor):
        side = {}
        for lvl, band in enumerate(_dwt_levels(x, 3), start=1):
            s = getattr(self, f"dwt_conv{lvl}")(band)
            side[lvl - 1] = getattr(self, f"dwt_proj{lvl}")(_to_period_2d(s, self.period))
        h, fmap = _to_period_2d(x, self.period), []
        for i in range(len(self.CHANNELS)):
            h = leaky_relu(getattr(self, f"conv_{i}")(h))
            fmap.append(h)
            if i in side:
                h = torch.cat([h, side[i].to(h.dtype)], dim=2)
        h = self.conv_post(h)
        fmap.append(h)
        return _flat(h), fmap


class ResWiseMultiPeriodDiscriminator(_JaxNamed):
    def __init__(self, periods: Sequence[int] = MPD_V2_PERIODS):
        super().__init__()
        self.names = [f"disc_p{p}" for p in periods]
        for name, p in zip(self.names, periods):
            setattr(self, name, ResWiseDiscriminatorP(p))

    def forward(self, y, y_hat):
        return run_discriminators([getattr(self, n) for n in self.names], y, y_hat)


# -- MMSD ---------------------------------------------------------------------

class _MMSDPeriod(nn.Module):
    """descript's period discriminator: (5, 1) convs of stride 3 but the
    last, padding 2, a (3, 1) post conv."""

    CHANNELS = (32, 128, 512, 1024, 1024)

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        c_in = 1
        for i, ch in enumerate(self.CHANNELS):
            setattr(self, f"conv_{i}", NormConv2d(
                c_in, ch, (5, 1), (3, 1) if i < 4 else (1, 1), (2, 0)))
            c_in = ch
        self.conv_post = NormConv2d(c_in, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor):
        h, fmap = _to_period_2d(x, self.period), []
        for i in range(len(self.CHANNELS)):
            h = leaky_relu(getattr(self, f"conv_{i}")(h))
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return _flat(h), fmap


class _MMSDBandMRD(nn.Module):
    """descript's complex multi-band spectrogram discriminator: a centred
    STFT (reflect padding of half a window, hop a quarter window, periodic
    Hann), (re, im) split into five frequency bands, a conv stack per band,
    the bands joined along frequency for the post conv."""

    BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))
    SPECS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
             ((3, 9), (1, 2)), ((3, 3), (1, 1)))

    def __init__(self, window_length: int, hop_factor: float = 0.25,
                 channels: int = 32):
        super().__init__()
        self.window_length = window_length
        self.hop = int(window_length * hop_factor)
        n_bins = window_length // 2 + 1
        self.edges = [(int(a * n_bins), int(b * n_bins)) for a, b in self.BANDS]
        for bi in range(len(self.BANDS)):
            for i, (k, s) in enumerate(self.SPECS):
                setattr(self, f"band{bi}_conv{i}", NormConv2d(
                    2 if i == 0 else channels, channels, k, s, _same_pad(k)))
        self.conv_post = NormConv2d(channels, 1, (3, 3), (1, 1), (1, 1))

    def forward(self, x: torch.Tensor):
        pad = self.window_length // 2
        wav = F.pad(x, (pad, pad), mode="reflect")[:, 0]
        h = _complex_stft(wav, self.window_length, self.hop)
        fmap, outs = [], []
        for bi, (lo, hi) in enumerate(self.edges):
            band = h[..., lo:hi]
            for i in range(len(self.SPECS)):
                band = leaky_relu(getattr(self, f"band{bi}_conv{i}")(band))
                fmap.append(band)
            outs.append(band)
        h = self.conv_post(torch.cat(outs, dim=3))
        fmap.append(h)
        return _flat(h), fmap


class MultiMelScaleDiscriminator(_JaxNamed):
    """MMSD: DC removal and peak normalization of each waveform, then
    period discriminators over (2, 3, 5, 7, 11) and band-split complex
    spectrogram discriminators over (2048, 1024, 512)."""

    def __init__(self, periods: Sequence[int] = MPD_V1_PERIODS,
                 fft_sizes: Sequence[int] = (2048, 1024, 512)):
        super().__init__()
        self.names = ([f"disc_p{p}" for p in periods]
                      + [f"disc_mrd{f}" for f in fft_sizes])
        for p in periods:
            setattr(self, f"disc_p{p}", _MMSDPeriod(p))
        for f in fft_sizes:
            setattr(self, f"disc_mrd{f}", _MMSDBandMRD(f))

    @staticmethod
    def _normalize(a: torch.Tensor) -> torch.Tensor:
        a = a - a.mean(dim=1, keepdim=True)
        return 0.8 * a / (a.abs().amax(dim=1, keepdim=True) + 1e-9)

    def forward(self, y, y_hat):
        return run_discriminators([getattr(self, n) for n in self.names],
                                  self._normalize(y), self._normalize(y_hat))


# -- combinations and the registry ------------------------------------------------

class CombinedDiscriminator(nn.Module):
    """Several discriminators as one adversary: their sub-discriminators'
    outputs one after the other. Members are ``discriminators.{i}``; a
    parameter's gradient-norm group is the JAX tree's
    ``discriminators_{i}``."""

    def __init__(self, discriminators: Sequence[nn.Module]):
        super().__init__()
        self.discriminators = nn.ModuleList(discriminators)

    def group_of(self, name: str) -> str:
        return f"discriminators_{name.split('.')[1]}"

    def forward(self, y, y_hat):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            r, g, fr, fg = d(y, y_hat)
            y_d_rs += r
            y_d_gs += g
            fmap_rs += fr
            fmap_gs += fg
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


DISCRIMINATOR_REGISTRY = {
    "mpd_v1": MultiPeriodDiscriminatorV1,
    "mrd": MultiResolutionDiscriminator,
    "msstft": MultiScaleSTFTDiscriminator,
    "mssbcqt": MultiScaleSubbandCQTDiscriminator,
    "msd": MultiScaleDiscriminator,
    "fregan_mpd": ResWiseMultiPeriodDiscriminator,
    "mmsd": MultiMelScaleDiscriminator,
}


def build_discriminator(names: Sequence[str], sample_rate: int = 48000) -> nn.Module:
    """A discriminator from registry names (``mpd`` / ``mpd_v2`` the
    default ``MultiPeriodDiscriminator``); several names give a
    ``CombinedDiscriminator`` in their order."""
    mods = []
    for n in names:
        if n in ("mpd", "mpd_v2"):
            mods.append(MultiPeriodDiscriminator())
        elif n == "mssbcqt":
            mods.append(MultiScaleSubbandCQTDiscriminator(sample_rate=sample_rate))
        elif n in DISCRIMINATOR_REGISTRY:
            mods.append(DISCRIMINATOR_REGISTRY[n]())
        else:
            raise ValueError(f"unknown discriminator {n!r}; one of mpd, mpd_v2, "
                             f"{', '.join(DISCRIMINATOR_REGISTRY)}")
    return mods[0] if len(mods) == 1 else CombinedDiscriminator(mods)
