"""The RVC v2 synthesizer's inference, plain PyTorch over a state_dict.

``infer``: the prior (a relative-position transformer text encoder over
content features and coarse pitch), a sample at temperature 0.66666, the
inverse of a four-layer mean-only coupling flow, and a decoder: NSF HiFi-GAN
(a sine source injected after each transposed-conv upsample, every stage
tail the mean of three residual chains) or RefineGAN (linear resizes, a
strided source downsample and three AdaIN-noised chains at slope 0.2 a
stage). Every random draw is made from the caller's generator in the order
and shapes the model defines, so that a generator in the same state draws
the same numbers. Keys are the RVC ``.pth`` layout's, the flow's couplings
at ``flow.flows.{0,2,4,6}``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ops import conv1d, conv_transpose1d, leaky, linear, mm, q, weight_norm


def _w(sd, p):
    """A conv's effective weight: weight-normalised where it carries g, v."""
    if f"{p}.weight_v" in sd:
        return weight_norm(sd[f"{p}.weight_v"], sd[f"{p}.weight_g"])
    return sd[f"{p}.weight"]


def _conv(sd, p, x, **kw):
    return conv1d(x, _w(sd, p), sd.get(f"{p}.bias"), **kw)


def _same(k, d=1):
    return (k * d - d) // 2


def _ln_channels(x, sd, p):
    y = F.layer_norm(x.transpose(1, 2), (x.shape[1],), sd[f"{p}.gamma"].float(),
                     sd[f"{p}.beta"].float(), 1e-5)
    return q(y.transpose(1, 2))


def _rel_embeddings(emb, length, window):
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * length - 1]


def _rel_to_abs(x):
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _abs_to_rel(x):
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def _attention(sd, p, x, mask, heads, window=10):
    b, c, t = x.shape
    d = c // heads

    def split(name):
        return _conv(sd, f"{p}.{name}", x).reshape(b, heads, d, t).transpose(2, 3)

    qs = split("conv_q") * d ** -0.5
    k, v = split("conv_k"), split("conv_v")
    scores = mm(qs, k.transpose(-1, -2)).masked_fill(mask == 0, -1e4)
    rel_k = _rel_embeddings(sd[f"{p}.emb_rel_k"].float(), t, window)
    scores = scores + _rel_to_abs(mm(qs, rel_k.transpose(-1, -2)))
    attn = q(torch.softmax(scores, dim=-1))
    out = mm(attn, v)
    rel_v = _rel_embeddings(sd[f"{p}.emb_rel_v"].float(), t, window)
    out = out + mm(_abs_to_rel(attn), rel_v)
    return _conv(sd, f"{p}.conv_o", out.transpose(2, 3).reshape(b, c, t))


def text_encoder(sd, phone, pitch, lengths, arch):
    """-> m, logs [B, inter, T], mask [B, 1, T]."""
    p = "enc_p"
    x = linear(phone, sd[f"{p}.emb_phone.weight"], sd[f"{p}.emb_phone.bias"])
    x = x + sd[f"{p}.emb_pitch.weight"].float()[pitch]
    x = leaky(x * math.sqrt(arch["hidden_channels"]), 0.1).transpose(1, 2)
    t = x.shape[2]
    mask = (torch.arange(t, device=x.device)[None] < lengths[:, None]).float()[:, None]
    x = x * mask
    k = arch["kernel_size"]
    for i in range(arch["n_layers"]):
        e = f"{p}.encoder"
        x = _ln_channels(x + _attention(sd, f"{e}.attn_layers.{i}", x, mask[:, :, None],
                                        arch["n_heads"]), sd, f"{e}.norm_layers_1.{i}")
        y = torch.relu(_conv(sd, f"{e}.ffn_layers.{i}.conv_1", x * mask, padding=_same(k)))
        y = _conv(sd, f"{e}.ffn_layers.{i}.conv_2", y * mask, padding=_same(k)) * mask
        x = _ln_channels(x + y, sd, f"{e}.norm_layers_2.{i}")
    stats = _conv(sd, f"{p}.proj", x * mask) * mask
    m, logs = torch.split(stats, arch["inter_channels"], dim=1)
    return m, logs, mask


def _wavenet(sd, p, x, mask, g, n_layers, kernel_size):
    h = x.shape[1]
    out = torch.zeros_like(x)
    g_all = _conv(sd, f"{p}.cond_layer", g)
    for i in range(n_layers):
        x_in = _conv(sd, f"{p}.in_layers.{i}", x, padding=_same(kernel_size))
        x_in = x_in + g_all[:, i * 2 * h:(i + 1) * 2 * h]
        acts = q(torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:]))
        rs = _conv(sd, f"{p}.res_skip_layers.{i}", acts)
        if i < n_layers - 1:
            x = q((x + rs[:, :h]) * mask)
            out = q(out + rs[:, h:])
        else:
            out = out + rs
    return out * mask


def flow_reverse(sd, z, mask, g, arch):
    half = z.shape[1] // 2
    for i in reversed(range(arch["n_flows"])):
        p = f"flow.flows.{2 * i}"
        z = torch.flip(z, dims=[1])
        x0, x1 = z[:, :half], z[:, half:]
        h = _conv(sd, f"{p}.pre", x0) * mask
        h = _wavenet(sd, f"{p}.enc", h, mask, g, arch["flow_wn_layers"], 5)
        x1 = q((x1 - _conv(sd, f"{p}.post", h) * mask) * mask)
        z = torch.cat([x0, x1], dim=1)
    return z


def _downsample_geometry(rates, i):
    stride = math.prod(rates[i + 1:]) if i + 1 < len(rates) else 1
    nk = 1 if stride == 1 else stride * 2 - stride % 2
    return stride, nk, 0 if stride == 1 else (nk - stride) // 2


def _chain(sd, p, x, k, dilations, slope):
    for m, d in enumerate(dilations):
        y = _conv(sd, f"{p}.convs1.{m}", leaky(x, slope), padding=_same(k, d), dilation=d)
        x = q(x + _conv(sd, f"{p}.convs2.{m}", leaky(y, slope), padding=_same(k)))
    return x


def _noise(shape, generator, device):
    return torch.randn(tuple(shape), generator=generator, device=device)


def nsf_decoder(sd, x, f0, g, generator, arch, sr):
    rates, kernels = arch["upsample_rates"], arch["upsample_kernel_sizes"]
    upp = math.prod(rates)
    b, frames = f0.shape
    # the sine source on the upsample grid, its phase carried frame to frame
    phase = (f0.float()[..., None] / sr) * torch.arange(
        1, upp + 1, dtype=torch.float32, device=f0.device)[None, None]
    adv = torch.remainder(phase[:, :-1, -1:] + 0.5, 1.0) - 0.5
    phase = phase + F.pad(torch.remainder(torch.cumsum(adv, 1), 1.0), (0, 0, 1, 0))
    sine = torch.sin(2.0 * torch.pi * phase.reshape(b, frames * upp, 1)) * 0.1
    uv = torch.repeat_interleave((f0.float() > 0).float()[..., None], upp, dim=1)
    noise = (uv * 0.003 + (1.0 - uv) * (0.1 / 3.0)) * _noise(sine.shape, generator, f0.device)
    src = sine * uv + noise
    har = torch.tanh(src * sd["dec.m_source.l_linear.weight"].float()[0, 0]
                     + sd["dec.m_source.l_linear.bias"].float()[0]).transpose(1, 2)

    x = _conv(sd, "dec.conv_pre", x, padding=3) + _conv(sd, "dec.cond", g)
    nk = len(arch["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(rates, kernels)):
        pad = (k - u) // 2 if u % 2 == 0 else u // 2 + u % 2
        x = conv_transpose1d(leaky(x, 0.1), _w(sd, f"dec.ups.{i}"), sd[f"dec.ups.{i}.bias"],
                             u, pad, u % 2)
        stride, _, npad = _downsample_geometry(rates, i)
        x = q(x + _conv(sd, f"dec.noise_convs.{i}", har, stride=stride, padding=npad))
        acc = 0.0
        for j, (rk, rd) in enumerate(zip(arch["resblock_kernel_sizes"],
                                         arch["resblock_dilation_sizes"])):
            acc = acc + _chain(sd, f"dec.resblocks.{i * nk + j}", x, rk, rd, 0.1)
        x = q(acc / nk)
    return torch.tanh(_conv(sd, "dec.conv_post", leaky(x, 0.01), padding=3))


def _resize(x, t):
    return F.interpolate(x, size=t, mode="linear", align_corners=False)


def refinegan_decoder(sd, x, f0, g, generator, arch, sr, slope=0.2):
    rates = arch["upsample_rates"]
    upp = math.prod(rates)
    b, frames = f0.shape
    f0_up = _resize(f0.float()[:, None, :], frames * upp).transpose(1, 2)   # [B, T, 1]
    rad = torch.remainder(f0_up / sr, 1.0)
    ini = torch.rand((b, 1, 1), generator=generator, device=f0.device)
    ini[..., 0] = 0.0
    rad = torch.cat([rad[:, :1] + ini, rad[:, 1:]], dim=1)
    phase = torch.remainder(torch.cumsum(rad.double(), dim=1), 1.0).float()
    sine = torch.sin(2.0 * torch.pi * phase) * 0.1
    uv = (f0_up > 0).float()
    noise = (uv * 0.003 + (1.0 - uv) * (0.1 / 3.0)) * _noise(sine.shape, generator, f0.device)
    har = torch.tanh((sine * uv + noise) * sd["dec.m_source.merge.0.weight"].float()[0, 0])
    har = har.transpose(1, 2)                                               # [B, 1, T]

    src = _resize(_conv(sd, "dec.pre_conv", har, padding=3), frames)
    mel = _conv(sd, "dec.mel_conv", x, padding=3) + _conv(sd, "dec.cond", g)
    x = torch.cat([mel, src], dim=1)
    for i, rate in enumerate(rates):
        x = _resize(leaky(x, slope), x.shape[-1] * rate)
        stride, _, npad = _downsample_geometry(rates, i)
        d = _conv(sd, f"dec.downsample_blocks.{i}", har, stride=stride, padding=npad)
        p = f"dec.upsample_conv_blocks.{i}"
        x = _conv(sd, f"{p}.input_conv", torch.cat([x, d], dim=1), padding=3)
        acc = 0.0
        for bi, k in enumerate((3, 7, 11)):
            w1 = sd[f"{p}.blocks.{bi}.0.weight"].float()[None, :, None]
            y = leaky(x + _noise(x.shape, generator, x.device) * w1, slope)
            y = _chain(sd, f"{p}.blocks.{bi}.1", y, k, (1, 3, 5), slope)
            w2 = sd[f"{p}.blocks.{bi}.2.weight"].float()[None, :, None]
            acc = acc + leaky(y + _noise(y.shape, generator, y.device) * w2, slope)
        x = q(acc / 3)
    return torch.tanh(_conv(sd, "dec.conv_post", leaky(x, slope), padding=3))


def infer(sd, phone, lengths, pitch, nsff0, sid, generator, arch, sr,
          temperature=0.66666):
    """phone [B, T, D], lengths [B], pitch [B, T] int, nsff0 [B, T] Hz,
    sid [B] -> audio [B, T * upp] float32."""
    g = sd["emb_g.weight"].float()[sid][:, :, None]
    m, logs, mask = text_encoder(sd, phone.float(), pitch, lengths, arch)
    eps = _noise(m.shape, generator, m.device)
    z = flow_reverse(sd, (m + torch.exp(logs) * eps * temperature) * mask, mask, g, arch)
    decoder = refinegan_decoder if arch["vocoder"] == "RefineGAN" else nsf_decoder
    return decoder(sd, z * mask, nsff0, g, generator, arch, sr)[:, 0]
