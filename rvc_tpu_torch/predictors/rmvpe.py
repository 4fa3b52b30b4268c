"""RMVPE pitch estimator (port of ``rvc_tpu/predictors/rmvpe.py``): a
DeepUnet over the [T, 128] log-mel image, a 3-channel conv head, a BiGRU
(384 -> 2 x 256) and a 360-bin sigmoid salience, decoded to f0 by the
9-tap local average of cents. ``RMVPE`` is the host-facing predictor: the
reference ``rmvpe.pt`` in, audio in, f0 out (``infer_from_audio``), in the
model's own float32.

Activations are NCHW ([B, C, T, mel]); module names follow the reference
``E2E`` state-dict layout that ``convert_torch_rmvpe`` reads, except the
BiGRU (``fc.0.gru``), which keeps the JAX module's pre-folded biases:
the input bias carries b_ih + b_hh for the r and z gates, the n gate keeps
b_hn inside the recurrent term. Batch norm uses its running statistics.

RMVPE is inference-only (``E2EModel.forward`` runs without gradients, and
``bigru`` has no backward). The weights each forward derives (a batch
norm's scale and shift, the BiGRU's stacked recurrent weights) are kept in
``WeightCache``s on their modules, rebuilt when a tensor they come from
changes or moves, each rebuild counted as ``rmvpe_norm_builds``: a warm
forward launches only the activations' kernels."""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.bigru import bigru
from ..ops.mel import mel_filterbank
from ..ops.stft import stft_magnitude
from ..utils import profiling
from ..utils.profiling import span
from ..utils.weight_cache import WeightCache
from .bucketing import bucket_samples, reflect_to
from .cents import weighted_cents_decode

# the recorder's counter of RMVPE's rebuilt derived weights
BUILDS = "rmvpe_norm_builds"
N_MELS = 128
N_CLASS = 360
SR = 16000
WIN = 1024
HOP = 160


class BatchNorm(nn.Module):
    """Inference batch norm over dim 1 with running statistics; the affine
    is folded in float32 and applied in the input's dtype. The folded scale
    and shift are kept per input dtype, device and rank until a parameter or
    statistic changes."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self._folded = WeightCache(BUILDS)

    def forward(self, x):
        def fold():  # (scale, shift) in x's dtype, shaped to broadcast over x
            scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
            shift = self.bias.float() - self.running_mean.float() * scale
            shape = (1, -1) + (1,) * (x.dim() - 2)
            return scale.to(x.dtype).reshape(shape), shift.to(x.dtype).reshape(shape)

        scale, shift = self._folded.get(
            (self.weight, self.bias, self.running_mean, self.running_var),
            (x.dtype, x.device, x.dim()), fold)
        return x * scale + shift


class ConvBlockRes(nn.Module):
    """Two BN-conv-relu stages with a residual (1x1 shortcut on a width
    change)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(c_in, c_out, 3, padding=1, bias=False), BatchNorm(c_out),
            nn.ReLU(), nn.Conv2d(c_out, c_out, 3, padding=1, bias=False),
            BatchNorm(c_out), nn.ReLU())
        self.shortcut = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x):
        res = self.shortcut(x) if self.shortcut is not None else x
        return self.conv(x) + res


class ResEncoderBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, n_blocks: int, pool: bool):
        super().__init__()
        self.pool = pool
        self.conv = nn.ModuleList(
            ConvBlockRes(c_in if i == 0 else c_out, c_out) for i in range(n_blocks))

    def forward(self, x):
        for blk in self.conv:
            x = blk(x)
        if self.pool:
            return x, F.avg_pool2d(x, 2)
        return x


class ResDecoderBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, n_blocks: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(c_in, c_out, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            BatchNorm(c_out))
        self.conv2 = nn.ModuleList(
            ConvBlockRes(2 * c_out if i == 0 else c_out, c_out)
            for i in range(n_blocks))

    def forward(self, x, skip):
        x = torch.cat([torch.relu(self.conv1(x)), skip], dim=1)
        for blk in self.conv2:
            x = blk(x)
        return x


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Encoder(_Stack):
    def __init__(self, layers):
        super().__init__(layers)
        self.bn = BatchNorm(1)


class DeepUnet(nn.Module):
    def __init__(self, n_blocks: int, en_de_layers: int, inter_layers: int,
                 en_out_channels: int):
        super().__init__()
        enc, ch, c_in = [], en_out_channels, 1
        for _ in range(en_de_layers):
            enc.append(ResEncoderBlock(c_in, ch, n_blocks, pool=True))
            c_in, ch = ch, ch * 2
        self.encoder = _Encoder(enc)
        inter = [ResEncoderBlock(c_in if i == 0 else ch, ch, n_blocks, pool=False)
                 for i in range(inter_layers)]
        self.intermediate = _Stack(inter)
        dec = []
        for _ in range(en_de_layers):
            dec.append(ResDecoderBlock(ch, ch // 2, n_blocks))
            ch //= 2
        self.decoder = _Stack(dec)

    def forward(self, x):
        x = self.encoder.bn(x)
        skips = []
        for layer in self.encoder.layers:
            skip, x = layer(x)
            skips.append(skip)
        for layer in self.intermediate.layers:
            x = layer(x)
        for i, layer in enumerate(self.decoder.layers):
            x = layer(x, skips[-1 - i])
        return x


class FusedBiGRU(nn.Module):
    """Bidirectional GRU with the input projections of all gates hoisted
    out of the time loop; the recurrence of both directions is one call of
    ``ops.bigru.bigru`` (kernel G on the card, the plain step loop on the
    CPU). Gate math matches torch ``nn.GRU``."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for tag in ("fwd", "bwd"):
            self.register_parameter(f"wi_{tag}", nn.Parameter(torch.zeros(input_size, 3 * hidden)))
            self.register_parameter(f"bi_{tag}", nn.Parameter(torch.zeros(3 * hidden)))
            self.register_parameter(f"wh_{tag}", nn.Parameter(torch.zeros(hidden, 3 * hidden)))
            self.register_parameter(f"bhn_{tag}", nn.Parameter(torch.zeros(hidden)))
        self._stacked = WeightCache(BUILDS)

    def forward(self, x):  # [B, T, F] -> [B, T, 2H]
        xi_f = x @ self.wi_fwd + self.bi_fwd                        # [B, T, 3H]
        xi_b = x @ self.wi_bwd + self.bi_bwd
        wh, bn = self._stacked.get(                                 # [2, H, 3H], [2, H]
            (self.wh_fwd, self.wh_bwd, self.bhn_fwd, self.bhn_bwd), None,
            lambda: (torch.stack([self.wh_fwd, self.wh_bwd]),
                     torch.stack([self.bhn_fwd, self.bhn_bwd])))
        return bigru(xi_f, xi_b, wh, bn)


class _GRUHead(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.gru = FusedBiGRU(3 * N_MELS, hidden)


class E2EModel(nn.Module):
    """DeepUnet + conv head + BiGRU + salience projection."""

    def __init__(self, n_blocks: int = 4, en_de_layers: int = 5,
                 inter_layers: int = 4, en_out_channels: int = 16,
                 gru_hidden: int = 256):
        super().__init__()
        self.unet = DeepUnet(n_blocks, en_de_layers, inter_layers, en_out_channels)
        self.cnn = nn.Conv2d(en_out_channels, 3, 3, padding=1)
        self.fc = nn.Sequential(_GRUHead(gru_hidden),
                                nn.Linear(2 * gru_hidden, N_CLASS))

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, 128] (T a multiple of 32) -> salience [B, T, 360]."""
        x = self.unet(mel[:, None])                  # [B, C, T, 128]
        x = self.cnn(x)                              # [B, 3, T, 128]
        b, _, t, _ = x.shape
        x = x.permute(0, 2, 1, 3).reshape(b, t, 3 * N_MELS)
        x = self.fc[0].gru(x)
        return torch.sigmoid(self.fc[1](x))


def rmvpe_mel(audio: torch.Tensor) -> torch.Tensor:
    """[B, T] 16 kHz audio -> [B, frames, 128] log-mel (htk mel, fmin 30,
    fmax 8000, centered STFT, log clamp 1e-5)."""
    mag = stft_magnitude(audio, WIN, HOP, WIN, center=True, eps=0.0)
    fb = torch.from_numpy(
        mel_filterbank(SR, WIN, N_MELS, 30.0, 8000.0, htk=True).T.copy()
    ).to(mag.device)
    return torch.log(torch.clamp(mag @ fb, min=1e-5))


def decode_salience(salience: torch.Tensor, thred: float = 0.03) -> torch.Tensor:
    """[T, 360] float32 salience -> [T] f0 in Hz (0 where unvoiced)."""
    avg_cents = weighted_cents_decode(salience, torch.argmax(salience, dim=1))
    maxx = torch.max(salience, dim=1).values
    avg_cents = torch.where(maxx > thred, avg_cents, torch.zeros_like(avg_cents))
    f0 = 10.0 * (2.0 ** (avg_cents / 1200.0))
    return torch.where(f0 == 10.0, torch.zeros_like(f0), f0)


def state_dict_from_torch_rmvpe(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference ``rmvpe.pt`` state_dict -> the port's ``E2EModel``
    state_dict. Every module but the BiGRU carries the reference's names;
    the ``nn.GRU`` weights (gates r, z, n stacked) become ``FusedBiGRU``'s
    transposed ``wi``/``wh``, with ``b_hh``'s r and z parts folded into the
    input bias and its n part kept as ``bhn``; the hidden width is read from
    ``weight_hh_l0``."""
    out = {k: v.float() for k, v in sd.items()
           if not k.endswith("num_batches_tracked") and not k.startswith("fc.0.gru.")}
    g = "fc.0.gru"
    h = sd[f"{g}.weight_hh_l0"].shape[1]
    for sfx, tag in (("", "fwd"), ("_reverse", "bwd")):
        w_ih = sd[f"{g}.weight_ih_l0{sfx}"].float()
        w_hh = sd[f"{g}.weight_hh_l0{sfx}"].float()
        b_ih = sd[f"{g}.bias_ih_l0{sfx}"].float()
        b_hh = sd[f"{g}.bias_hh_l0{sfx}"].float()
        bi = b_ih.clone()
        bi[:2 * h] = bi[:2 * h] + b_hh[:2 * h]
        out[f"{g}.wi_{tag}"] = w_ih.T.contiguous()
        out[f"{g}.bi_{tag}"] = bi
        out[f"{g}.wh_{tag}"] = w_hh.T.contiguous()
        out[f"{g}.bhn_{tag}"] = b_hh[2 * h:].clone()
    return out


def torch_gru_state_dict(gru: FusedBiGRU) -> Dict[str, torch.Tensor]:
    """``FusedBiGRU``'s weights in torch ``nn.GRU``'s layout (one layer,
    bidirectional, gates r, z, n stacked), the inverse of the BiGRU part of
    ``state_dict_from_torch_rmvpe``: ``weight_ih = wi^T``, ``weight_hh =
    wh^T``, ``bias_ih`` the folded input bias, ``bias_hh = (0, 0, b_hn)``."""
    sd = {}
    for sfx, tag in (("", "fwd"), ("_reverse", "bwd")):
        p = {n: getattr(gru, f"{n}_{tag}").detach() for n in ("wi", "bi", "wh", "bhn")}
        sd[f"weight_ih_l0{sfx}"] = p["wi"].T.contiguous()
        sd[f"weight_hh_l0{sfx}"] = p["wh"].T.contiguous()
        sd[f"bias_ih_l0{sfx}"] = p["bi"].clone()
        sd[f"bias_hh_l0{sfx}"] = torch.cat([torch.zeros_like(p["bhn"]).repeat(2), p["bhn"]])
    return sd


class RMVPE:
    """Host-facing predictor: an ``E2EModel`` on a device, audio in, f0 out.

    The model stays in float32; a pipeline serving in bf16 runs a bf16 copy
    of it in its fused graph (``Pipeline.set_rmvpe``)."""

    def __init__(self, model: E2EModel = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = (model or E2EModel()).to(self.device).eval()

    @classmethod
    def from_torch_checkpoint(cls, path: str,
                              device: Union[str, torch.device] = "cuda") -> "RMVPE":
        """Load the reference ``rmvpe.pt`` (an ``E2E`` state_dict)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        model = E2EModel()
        model.load_state_dict(state_dict_from_torch_rmvpe(sd), strict=True)
        return cls(model, device)

    def infer_from_audio(self, audio: np.ndarray, thred: float = 0.03) -> np.ndarray:
        """[T] 16 kHz audio -> f0 [T // 160 + 1] (centered STFT frames)."""
        return self.infer_batch([np.asarray(audio, np.float32)], thred)[0]

    @torch.no_grad()
    def salience_batch(self, audios: List[np.ndarray]) -> torch.Tensor:
        """Several waveforms in one batch, reflect-padded to the group's
        1 s bucket -> salience [B, bucket frames, 360] float32."""
        t_pad = bucket_samples(max(len(a) for a in audios))
        batch = np.stack([reflect_to(np.asarray(a, np.float32), t_pad)
                          for a in audios])
        n_frames = t_pad // HOP + 1
        dtype = next(self.model.parameters()).dtype
        mel = rmvpe_mel(torch.from_numpy(batch).to(self.device))[:, :n_frames]
        pad = (-n_frames) % 32
        if pad:
            mel = F.pad(mel.transpose(1, 2), (0, pad), mode="reflect").transpose(1, 2)
        profiling.count("f0_frames", mel.shape[0] * mel.shape[1])
        return self.model(mel.to(dtype)).float()[:, :n_frames]

    def infer_batch(self, audios: List[np.ndarray],
                    thred: float = 0.03) -> List[np.ndarray]:
        """Several waveforms in one batch (``salience_batch``), the true
        frame counts sliced after. Spans ``rvc.f0_net`` (the mel, the
        forward and the wait for it) and ``rvc.f0_decode`` (the decode and
        the f0's copy to the host); counter ``f0_frames``, the mel frames
        the network ran."""
        with span("rvc.f0_net"):
            hidden = self.salience_batch(audios)
            if hidden.device.type == "cuda":
                torch.cuda.current_stream(hidden.device).synchronize()
        with span("rvc.f0_decode"):
            f0 = torch.stack([decode_salience(h, thred) for h in hidden]).cpu().numpy()
        return [f0[i, : len(a) // HOP + 1] for i, a in enumerate(audios)]
