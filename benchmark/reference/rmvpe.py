"""RMVPE pitch salience and its decode, plain PyTorch over a state_dict.

The log-mel front end (1024-point centred STFT, hop 160, 128 htk-spaced
mel bands from 30 Hz to 8 kHz with slaney area norm, log clamped at 1e-5),
the DeepUnet (five pooled encoder levels of four residual conv blocks from
16 channels, four intermediate levels, five transposed-conv decoder levels
joined to the skips; inference batch norm), a 3-channel conv head, a
bidirectional GRU of 256 and a 360-bin sigmoid. Keys are the reference
``E2E`` model's, except the GRU, which carries its input bias with the r
and z recurrent biases folded in (``bi``), ``wi`` and ``wh`` transposed and
the n gate's recurrent bias apart (``bhn``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .ops import _MODE, conv2d, conv_transpose2d, linear, q

SR, WIN, HOP, N_MELS, N_CLASS = 16000, 1024, 160, 128, 360
CENTS = 20.0 * np.arange(N_CLASS) + 1997.3794084376191
_CALIBRATE = {"on": False}


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_fft=WIN, n_mels=N_MELS, fmin=30.0, fmax=8000.0) -> np.ndarray:
    """Triangular htk-scale filters with slaney area norm, [n_mels, bins]."""
    fft_freqs = np.linspace(0.0, SR / 2, 1 + n_fft // 2)
    hz = _mel_to_hz_htk(np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax),
                                    n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel(audio: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, T // 160 + 1, 128]."""
    y = F.pad(audio.float()[:, None], (WIN // 2, WIN // 2), mode="reflect")[:, 0]
    n = torch.arange(WIN, dtype=torch.float64, device=y.device)
    window = (0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / WIN)).float()
    spec = torch.fft.rfft(y.unfold(-1, WIN, HOP) * window, n=WIN, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2)
    fb = torch.from_numpy(mel_filterbank().T.copy()).to(mag.device)
    return torch.log(torch.clamp(mag @ fb, min=1e-5))


def _bn(sd, p, x, eps=1e-5):
    if _CALIBRATE["on"]:
        dims = [0] + list(range(2, x.dim()))
        sd[f"{p}.running_mean"] = x.mean(dims)
        sd[f"{p}.running_var"] = x.var(dims, unbiased=False)
    scale = sd[f"{p}.weight"].float() * torch.rsqrt(sd[f"{p}.running_var"].float() + eps)
    shift = sd[f"{p}.bias"].float() - sd[f"{p}.running_mean"].float() * scale
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return q(x * scale.reshape(shape) + shift.reshape(shape))


def _res_block(sd, p, x):
    y = torch.relu(_bn(sd, f"{p}.conv.1", conv2d(x, sd[f"{p}.conv.0.weight"], padding=1)))
    y = torch.relu(_bn(sd, f"{p}.conv.4", conv2d(y, sd[f"{p}.conv.3.weight"], padding=1)))
    res = x
    if f"{p}.shortcut.weight" in sd:
        res = conv2d(x, sd[f"{p}.shortcut.weight"], sd[f"{p}.shortcut.bias"])
    return q(y + res)


def _blocks(sd, p, x, n_blocks):
    for j in range(n_blocks):
        x = _res_block(sd, f"{p}.conv.{j}", x)
    return x


def unet(sd, x, arch):
    nb = arch["n_blocks"]
    x = _bn(sd, "unet.encoder.bn", x)
    skips = []
    for i in range(arch["en_de_layers"]):
        x = _blocks(sd, f"unet.encoder.layers.{i}", x, nb)
        skips.append(x)
        x = q(F.avg_pool2d(x, 2))
    for i in range(arch["inter_layers"]):
        x = _blocks(sd, f"unet.intermediate.layers.{i}", x, nb)
    for i in range(arch["en_de_layers"]):
        p = f"unet.decoder.layers.{i}"
        up = conv_transpose2d(x, sd[f"{p}.conv1.0.weight"], 2, 1, 1)
        x = torch.cat([torch.relu(_bn(sd, f"{p}.conv1.1", up)), skips[-1 - i]], dim=1)
        for j in range(nb):
            x = _res_block(sd, f"{p}.conv2.{j}", x)
    return x


def calibrate(sd, audio: torch.Tensor, arch: dict) -> None:
    """Set each batch norm's running statistics, in place, to the batch
    statistics of its input over ``audio`` [B, T] (where training leaves
    them), in float32 with TF32 off whatever the caller's switches."""
    frames = audio.shape[1] // HOP + 1
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    _CALIBRATE["on"] = True
    try:
        with torch.no_grad():
            mel = log_mel(audio)[:, :frames - frames % 32]
            unet(sd, mel[:, None], arch)
    finally:
        _CALIBRATE["on"] = False
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def bigru(sd, x):
    """[B, T, F] -> [B, T, 2H], forward then backward direction."""
    p = "fc.0.gru"
    h = sd[f"{p}.wh_fwd"].shape[0]
    if _MODE["kind"] != "fp8":
        # float32, or bfloat16 weights, input and gates
        dtype = torch.bfloat16 if _MODE["kind"] == "bf16" else torch.float32
        gru = torch.nn.GRU(x.shape[-1], h, batch_first=True, bidirectional=True)
        with torch.no_grad():
            for sfx, tag in (("", "fwd"), ("_reverse", "bwd")):
                getattr(gru, f"weight_ih_l0{sfx}").copy_(sd[f"{p}.wi_{tag}"].float().T)
                getattr(gru, f"weight_hh_l0{sfx}").copy_(sd[f"{p}.wh_{tag}"].float().T)
                getattr(gru, f"bias_ih_l0{sfx}").copy_(sd[f"{p}.bi_{tag}"].float())
                bhh = torch.zeros(3 * h)
                bhh[2 * h:] = sd[f"{p}.bhn_{tag}"].float().cpu()
                getattr(gru, f"bias_hh_l0{sfx}").copy_(bhh)
            gru = gru.to(x.device, dtype)
            return gru(x.to(dtype))[0].float()
    outs = []
    for tag, xs in (("fwd", x), ("bwd", x.flip(1))):
        xi = linear(xs, sd[f"{p}.wi_{tag}"].T) + sd[f"{p}.bi_{tag}"].float()
        wh, bhn = q(sd[f"{p}.wh_{tag}"]), sd[f"{p}.bhn_{tag}"].float()
        state = torch.zeros(x.shape[0], h, device=x.device)
        seq = []
        for t in range(x.shape[1]):
            g = q(state) @ wh
            rz = q(torch.sigmoid(xi[:, t, :2 * h] + g[:, :2 * h]))
            n = q(torch.tanh(xi[:, t, 2 * h:] + rz[:, :h] * (g[:, 2 * h:] + bhn)))
            state = q((1.0 - rz[:, h:]) * n + rz[:, h:] * state)
            seq.append(state)
        o = torch.stack(seq, dim=1)
        outs.append(o if tag == "fwd" else o.flip(1))
    return torch.cat(outs, dim=-1)


def salience(sd, mel: torch.Tensor, arch: dict) -> torch.Tensor:
    """mel [B, T, 128] (T a multiple of 32) -> [B, T, 360]."""
    x = unet(sd, mel.float()[:, None], arch)
    x = conv2d(x, sd["cnn.weight"], sd["cnn.bias"], padding=1)
    b, _, t, _ = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b, t, -1)
    x = bigru(sd, x)
    return torch.sigmoid(linear(x, sd["fc.1.weight"], sd["fc.1.bias"]))


def salience_of_audio(sd, audio: torch.Tensor, frames: int, arch: dict) -> torch.Tensor:
    """The first ``frames`` frames of the salience of [B, T] audio; the mel
    image is reflect-padded to a multiple of 32 frames."""
    mel = log_mel(audio)[:, :frames]
    pad = (-frames) % 32
    if pad:
        mel = F.pad(mel.transpose(1, 2), (0, pad), mode="reflect").transpose(1, 2)
    return salience(sd, mel, arch)[:, :frames]


def decode(sal: torch.Tensor, thred: float = 0.03) -> torch.Tensor:
    """[T, 360] salience -> f0 [T] Hz: the 9-bin weighted mean of cents
    around the peak, 0 where the peak is at or under ``thred``."""
    sal = sal.double()
    center = torch.argmax(sal, dim=1)
    cents = torch.from_numpy(np.pad(CENTS, (4, 4))).to(sal.device)
    idx = center[:, None] + torch.arange(9, device=sal.device)[None, :]
    w = torch.gather(F.pad(sal, (4, 4)), 1, idx)
    avg = (w * cents[idx]).sum(1) / torch.clamp(w.sum(1), min=1e-12)
    avg = torch.where(sal.max(1).values > thred, avg, torch.zeros_like(avg))
    f0 = 10.0 * 2.0 ** (avg / 1200.0)
    return torch.where(f0 == 10.0, torch.zeros_like(f0), f0)

