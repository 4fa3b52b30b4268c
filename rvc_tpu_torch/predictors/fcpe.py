"""FCPE (Fast Context-based Pitch Estimation) (port of
``rvc_tpu/predictors/fcpe.py``).

``CFNaiveMelPE``: a conv input stack (GroupNorm(4), LeakyReLU), conformer
layers (FAVOR+ attention and a GLU depthwise-conv module), LayerNorm and a
Linear to a sigmoid latent [B, T, 360]; f0 from a 9-tap local argmax over a
linspace cent table, unvoiced below a confidence threshold. The mel front
end is 128 log-mels at 16 kHz, window 1024, hop 160.

The attention is the Performer random-feature scheme with torchfcpe's
numerics (the query max-shift and the key ``exp(.. + eps)`` asymmetry, the
1e-8 normalizer), and its projection matrix is a buffer carried from the
checkpoint, never redrawn: the weights were fitted under that one draw.
Module names are torchfcpe's, so a torchfcpe checkpoint loads with its
weight-normed output projection folded.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.mel import mel_filterbank
from ..ops.stft import stft_magnitude
from .bucketing import bucket_samples, reflect_to

SR = 16000
WIN = 1024
HOP = 160
N_MELS = 128
OUT_DIMS = 360
F0_MIN, F0_MAX = 32.70, 1975.5
DIM_HEAD = 64  # torchfcpe's SelfAttention: fixed, whatever the width


def f0_to_cent(f0: float) -> float:
    return 1200.0 * np.log2(f0 / 10.0)


CENT_TABLE = np.linspace(f0_to_cent(F0_MIN), f0_to_cent(F0_MAX),
                         OUT_DIMS).astype(np.float32)


def gaussian_orthogonal_matrix(nb_rows: int, nb_columns: int,
                               seed: int = 0) -> np.ndarray:
    """FAVOR+ projection draw: stacked QR-orthogonalized gaussian blocks,
    rows scaled to chi(d) norms (numpy-seeded; only a model without a
    checkpoint, or a checkpoint without the buffer, draws one)."""
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(-(-nb_rows // nb_columns)):
        q, _ = np.linalg.qr(rng.normal(size=(nb_columns, nb_columns)))
        blocks.append(q.T)
    mat = np.concatenate(blocks, axis=0)[:nb_rows]
    mult = np.linalg.norm(rng.normal(size=(nb_rows, nb_columns)), axis=1)
    return (mult[:, None] * mat).astype(np.float32)


def _softmax_kernel(data: torch.Tensor, proj: torch.Tensor, is_query: bool,
                    eps: float = 1e-4) -> torch.Tensor:
    """phi(x) random features, with the reference's asymmetry: queries get
    a max-shift inside exp and ``+ eps`` outside, keys ``+ eps`` inside."""
    normalizer = data.shape[-1] ** -0.25
    ratio = proj.shape[0] ** -0.5
    data_dash = torch.einsum("...id,jd->...ij", normalizer * data, proj)
    diag = (torch.sum(data * data, dim=-1, keepdim=True) / 2.0) * normalizer ** 2
    if is_query:
        shift = torch.amax(data_dash, dim=-1, keepdim=True)
        return ratio * (torch.exp(data_dash - diag - shift) + eps)
    return ratio * torch.exp(data_dash - diag + eps)


class _FastAttention(nn.Module):
    def __init__(self, dim_head: int):
        super().__init__()
        nb_features = int(dim_head * math.log(dim_head))
        self.register_buffer("projection_matrix", torch.from_numpy(
            gaussian_orthogonal_matrix(nb_features, dim_head)))


class FCPEAttention(nn.Module):
    """FAVOR+ attention over to_q/k/v/out; inner width heads x 64."""

    def __init__(self, dim: int, heads: int = 8, use_norm: bool = False):
        super().__init__()
        inner = heads * DIM_HEAD
        self.heads, self.use_norm = heads, use_norm
        self.fast_attention = _FastAttention(DIM_HEAD)
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape

        def split(a):
            return a.reshape(b, t, self.heads, DIM_HEAD).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        if self.use_norm:
            q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-8)
            k = k / (torch.linalg.norm(k, dim=-1, keepdim=True) + 1e-8)
        proj = self.fast_attention.projection_matrix
        qp = _softmax_kernel(q, proj, is_query=True)
        kp = _softmax_kernel(k, proj, is_query=False)
        # linear attention: two products instead of the T x T scores
        d_inv = 1.0 / (torch.einsum("bhnm,bhm->bhn", qp, kp.sum(dim=-2)) + 1e-8)
        context = torch.einsum("bhnm,bhne->bhme", kp, v)
        out = torch.einsum("bhme,bhnm,bhn->bhne", context, qp, d_inv)
        return self.to_out(out.transpose(1, 2).reshape(b, t, -1))


class _DepthWise(nn.Module):
    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, kernel_size,
                              padding=kernel_size // 2, groups=channels)


class ConformerConvModule(nn.Module):
    """LayerNorm -> 1x1 conv to 2 x 2H -> GLU -> depthwise k=31 -> SiLU ->
    1x1; ``net`` keeps torchfcpe's indices (the others are parameter-free)."""

    def __init__(self, dim: int, expansion: int = 2, kernel_size: int = 31):
        super().__init__()
        inner = dim * expansion
        self.net = nn.ModuleList([
            nn.LayerNorm(dim, eps=1e-5), nn.Identity(),
            nn.Conv1d(dim, inner * 2, 1), nn.Identity(),
            _DepthWise(inner, kernel_size), nn.Identity(),
            nn.Conv1d(inner, dim, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        y = self.net[2](self.net[0](x).transpose(1, 2))
        a, b = y.chunk(2, dim=1)
        y = F.silu(self.net[4].conv(a * torch.sigmoid(b)))
        return self.net[6](y).transpose(1, 2)


class CFNEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int = 8, conv_only: bool = False,
                 use_fa_norm: bool = False):
        super().__init__()
        self.conv_only = conv_only
        if not conv_only:
            self.norm = nn.LayerNorm(dim, eps=1e-5)
            self.attn = FCPEAttention(dim, heads, use_fa_norm)
        self.conformer = ConformerConvModule(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.conv_only:
            x = x + self.attn(self.norm(x))
        return x + self.conformer(x)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.encoder_layers = nn.ModuleList(layers)


class CFNaiveMelPE(nn.Module):
    def __init__(self, input_channels: int = N_MELS, out_dims: int = OUT_DIMS,
                 hidden_dims: int = 512, n_layers: int = 6, n_heads: int = 8,
                 conv_only: bool = False, use_fa_norm: bool = False):
        super().__init__()
        self.input_stack = nn.ModuleList([
            nn.Conv1d(input_channels, hidden_dims, 3, padding=1),
            nn.GroupNorm(4, hidden_dims, eps=1e-5), nn.Identity(),
            nn.Conv1d(hidden_dims, hidden_dims, 3, padding=1)])
        self.net = _Encoder([CFNEncoderLayer(hidden_dims, n_heads, conv_only,
                                             use_fa_norm) for _ in range(n_layers)])
        self.norm = nn.LayerNorm(hidden_dims, eps=1e-5)
        self.output_proj = nn.Linear(hidden_dims, out_dims)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, 128] -> sigmoid latent [B, T, 360]."""
        h = self.input_stack[1](self.input_stack[0](mel.transpose(1, 2)))
        h = self.input_stack[3](F.leaky_relu(h, 0.01)).transpose(1, 2)
        for layer in self.net.encoder_layers:
            h = layer(h)
        return torch.sigmoid(self.output_proj(self.norm(h)))


def fcpe_mel(audio: torch.Tensor) -> torch.Tensor:
    """[B, T] at 16 kHz -> [B, T // 160, 128] log-mel (torchfcpe's: reflect
    pad (win - hop) // 2 left and (win - hop + 1) // 2 right, non-centered
    STFT, sqrt(power + 1e-9), slaney mel, log clamped at 1e-5)."""
    y = F.pad(audio[:, None], ((WIN - HOP) // 2, (WIN - HOP + 1) // 2),
              mode="reflect")[:, 0]
    mag = stft_magnitude(y, WIN, HOP, WIN, center=False, eps=1e-9)
    fb = torch.from_numpy(mel_filterbank(SR, WIN, N_MELS, 0.0, 8000.0).T.copy())
    return torch.log(torch.clamp(mag @ fb.to(mag.device), min=1e-5))


def decode_latent(latent: torch.Tensor, threshold: float = 0.05) -> torch.Tensor:
    """[T, 360] -> [T] f0 in Hz: the 9-tap weighted mean of the cent table
    around the argmax, 0 where the peak is at or under ``threshold``."""
    table = torch.from_numpy(CENT_TABLE).to(latent.device)
    conf, center = torch.max(latent, dim=-1)
    idx = torch.clamp(center[:, None] + torch.arange(-4, 5, device=latent.device),
                      0, OUT_DIMS - 1)
    y_l = torch.gather(latent, 1, idx)
    cents = torch.sum(table[idx] * y_l, dim=-1) / torch.clamp(
        torch.sum(y_l, dim=-1), min=1e-12)
    f0 = 10.0 * (2.0 ** (cents / 1200.0))
    return torch.where(conf > threshold, f0, torch.zeros_like(f0))


class FCPE:
    """Host-facing predictor: a ``CFNaiveMelPE`` on a device, audio in, f0
    out."""

    def __init__(self, model: Optional[CFNaiveMelPE] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = (model or CFNaiveMelPE()).to(self.device).eval()

    @classmethod
    def from_torch_checkpoint(cls, path: str,
                              device: Union[str, torch.device] = "cuda") -> "FCPE":
        """Load a torchfcpe checkpoint (``{"model": state_dict,
        "config_dict": ...}`` or a bare state_dict); the width, depth,
        heads and ``conv_only`` come from the checkpoint."""
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = dict(obj.get("model", obj))
        cfg = (obj.get("config_dict") or {}).get("model", {})
        hidden = int(sd["input_stack.0.weight"].shape[0])
        n_layers = 0
        while f"net.encoder_layers.{n_layers}.conformer.net.0.weight" in sd:
            n_layers += 1
        conv_only = "net.encoder_layers.0.attn.to_q.weight" not in sd
        inner = (0 if conv_only
                 else int(sd["net.encoder_layers.0.attn.to_q.weight"].shape[0]))
        n_heads = int(cfg.get("n_heads", 8 if conv_only else inner // DIM_HEAD))
        model = CFNaiveMelPE(hidden_dims=hidden, n_layers=n_layers,
                             n_heads=n_heads, conv_only=conv_only,
                             use_fa_norm=bool(cfg.get("use_fa_norm", False)))
        # the weight-normed output projection, folded
        for g_key, v_key in (("output_proj.parametrizations.weight.original0",
                              "output_proj.parametrizations.weight.original1"),
                             ("output_proj.weight_g", "output_proj.weight_v")):
            if g_key in sd:
                g, v = sd.pop(g_key).float(), sd.pop(v_key).float()
                norm = torch.sqrt(torch.sum(v ** 2, dim=1, keepdim=True) + 1e-12)
                sd["output_proj.weight"] = v / norm * g.reshape(-1, 1)
        ref = model.state_dict()
        for i in range(n_layers):  # a checkpoint without the buffer keeps the draw
            key = f"net.encoder_layers.{i}.attn.fast_attention.projection_matrix"
            if not conv_only and key not in sd:
                sd[key] = ref[key]
        missing = [k for k in ref if k not in sd]
        if missing:
            raise KeyError(f"fcpe checkpoint lacks {missing[:8]}")
        model.load_state_dict({k: sd[k].float() for k in ref})
        return cls(model, device)

    @torch.no_grad()
    def latent(self, audio: torch.Tensor, n_frames: int) -> torch.Tensor:
        """[B, T] audio on the device -> [B, n_frames, 360] latent."""
        return self.model(fcpe_mel(audio)[:, :n_frames])

    def compute_f0(self, audio: np.ndarray, p_len: Optional[int] = None,
                   threshold: float = 0.05,
                   filter_radius: Optional[float] = None) -> np.ndarray:
        """audio at 16 kHz -> f0, resized to ``p_len`` frames when given,
        with unvoiced gaps filled by linear interpolation (the edges hold
        the nearest voiced value). A fractional ``filter_radius`` is the
        confidence threshold; integer radii are the caller's median
        filter."""
        if filter_radius is not None and 0.0 < float(filter_radius) < 1.0:
            threshold = float(filter_radius)
        audio = np.asarray(audio, np.float32)
        n_frames = len(audio) // HOP
        # padded to the 1 s bucket, as the JAX package compiles per bucket
        padded = reflect_to(audio, bucket_samples(len(audio)))[None, :]
        latent = self.latent(torch.from_numpy(padded).to(self.device),
                             padded.shape[1] // HOP)
        f0 = decode_latent(latent[0].float(), threshold).cpu().numpy()[:n_frames]
        if p_len is not None and p_len != len(f0):
            # NaN-masked linear resize
            src = f0.astype(np.float64)
            src[src < 0.001] = np.nan
            f0 = np.nan_to_num(np.interp(
                np.arange(0, len(src) * p_len, len(src)) / p_len,
                np.arange(0, len(src)), src))
        voiced = np.nonzero(f0 > 0.0)[0]
        if len(voiced):
            f0 = np.interp(np.arange(len(f0)), voiced, f0[voiced])
        return f0.astype(np.float32)
