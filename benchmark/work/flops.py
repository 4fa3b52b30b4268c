"""The work of a conversion and of its kernels, counted from shapes.

The algorithm's own operations, two to a multiply-add, and its bytes, each
input read once and each output written once, whatever an implementation
reads again or rounds in between (a 3xTF32 product counts once). Peaks are
one NVIDIA H100 SXM's published dense rates at its full 700 W."""

from __future__ import annotations

import math
from typing import Sequence

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of operations over the
    peak rate of ``precision`` and bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)


def conv1d(t_out: int, c_in: int, c_out: int, k: int, groups: int = 1) -> int:
    return 2 * t_out * (c_in // groups) * c_out * k


def stage_tail(batch: int, channels: int, length: int, kernel_sizes: Sequence[int],
               dilations: Sequence[int], act_bytes: int, weight_bytes: int):
    """(flops, bytes) of a stage tail: for each chain (one per kernel size)
    and each dilation, a conv of that dilation and a conv of dilation 1,
    both C x C; the mean over the chains. Reads x and the weights and biases
    once, writes the output once."""
    flops = sum(2 * conv1d(length, channels, channels, k) * len(dilations) * batch
                for k in kernel_sizes)
    weights = sum(2 * len(dilations) * (channels * channels * k + channels)
                  for k in kernel_sizes)
    return flops, 2 * batch * channels * length * act_bytes + weights * weight_bytes


def knn(n_q: int, n_v: int, dim: int, k: int):
    """(flops, bytes) of exact k-NN by squared L2: the [n_q, n_v] product;
    queries and index read once (f32), k distances (f32) and indices (i64)
    written."""
    return 2 * n_q * n_v * dim, 4 * (n_q + n_v) * dim + 12 * n_q * k


def hubert(samples: int, arch: dict) -> int:
    """HuBERT-base on ``samples`` of 16 kHz audio."""
    flops, n, c_in = 0, samples, 1
    for c_out, k, s in zip(arch["conv_dim"], arch["conv_kernel"], arch["conv_stride"]):
        n = (n - k) // s + 1
        flops += conv1d(n, c_in, c_out, k)
        c_in = c_out
    h, f = arch["hidden_size"], arch["intermediate_size"]
    flops += 2 * n * c_in * h
    flops += conv1d(n, h, h, arch["num_conv_pos_embeddings"],
                    arch["num_conv_pos_embedding_groups"])
    per_layer = 4 * 2 * n * h * h + 2 * 2 * n * n * h + 2 * 2 * n * h * f
    return flops + arch["num_layers"] * per_layer


def rmvpe(samples: int, arch: dict) -> int:
    """RMVPE on ``samples`` of 16 kHz audio: the mel projection, the
    DeepUnet over the mel image padded to 32 frames, the head, the BiGRU
    and the salience projection (the STFT is not counted)."""
    frames = samples // 160 + 1
    t = -(-frames // 32) * 32
    flops = 2 * frames * 513 * 128
    hw, c_in, c = t * 128, 1, arch["en_out_channels"]

    def blocks(hw, c_in, c):
        out = 2 * hw * c_in * c * 9 + 2 * hw * c * c * 9 + (2 * hw * c_in * c if c_in != c else 0)
        return out + (arch["n_blocks"] - 1) * 2 * (2 * hw * c * c * 9)

    for _ in range(arch["en_de_layers"]):
        flops += blocks(hw, c_in, c)
        hw, c_in, c = hw // 4, c, c * 2
    for i in range(arch["inter_layers"]):
        flops += blocks(hw, c_in if i == 0 else c, c)
    c_in = c
    for _ in range(arch["en_de_layers"]):
        c = c_in // 2
        flops += 2 * hw * c_in * c * 9        # stride-2 transposed conv, per input pixel
        hw *= 4
        flops += blocks(hw, 2 * c, c)
        c_in = c
    flops += 2 * t * 128 * c * 3 * 9
    h = arch["gru_hidden"]
    flops += 2 * (2 * t * 3 * 128 * 3 * h + 2 * t * h * 3 * h)
    return flops + 2 * t * 2 * h * 360


def text_encoder(frames: int, m: dict, window: int = 10) -> int:
    h, f, p = m["hidden_channels"], m["filter_channels"], frames
    flops = 2 * p * m["text_enc_hidden_dim"] * h
    attn = 4 * 2 * p * h * h + 2 * 2 * p * p * h + 2 * 2 * p * (2 * window + 1) * h
    ffn = conv1d(p, h, f, m["kernel_size"]) + conv1d(p, f, h, m["kernel_size"])
    return flops + m["n_layers"] * (attn + ffn) + 2 * p * h * 2 * m["inter_channels"]


def flow(frames: int, m: dict, n_flows: int = 4, wn_layers: int = 3) -> int:
    half, h = m["inter_channels"] // 2, m["hidden_channels"]
    wn = sum(conv1d(frames, h, 2 * h, 5) + 2 * frames * h * (2 * h if i < wn_layers - 1 else h)
             for i in range(wn_layers))
    return n_flows * (2 * frames * half * h + wn + 2 * frames * h * half)


def _down(rates, i):
    stride = math.prod(rates[i + 1:]) if i + 1 < len(rates) else 1
    return 1 if stride == 1 else stride * 2 - stride % 2


def nsf_decoder(frames: int, m: dict) -> int:
    c = m["upsample_initial_channel"]
    flops, t = conv1d(frames, m["inter_channels"], c, 7), frames
    rates = m["upsample_rates"]
    for i, (u, k) in enumerate(zip(rates, m["upsample_kernel_sizes"])):
        c_out = c // 2
        flops += 2 * t * c * c_out * k
        t *= u
        flops += conv1d(t, 1, c_out, _down(rates, i))
        flops += stage_tail(1, c_out, t, m["resblock_kernel_sizes"],
                            m["resblock_dilation_sizes"][0], 2, 2)[0]
        c = c_out
    return flops + conv1d(t, c, 1, 7)


def refinegan_decoder(frames: int, m: dict, channels: int = 512) -> int:
    rates = m["upsample_rates"]
    t_audio = frames * math.prod(rates)
    flops = conv1d(t_audio, 1, channels // 2, 7) + conv1d(frames, m["inter_channels"], channels // 2, 7)
    t, c = frames, channels
    for i, u in enumerate(rates):
        t *= u
        down = channels // 2 ** (i + 2)
        flops += conv1d(t, 1, down, _down(rates, i))
        flops += conv1d(t, c + down, c // 2, 7)
        flops += stage_tail(1, c // 2, t, (3, 7, 11), (1, 3, 5), 2, 2)[0]
        c //= 2
    return flops + conv1d(t, c, 1, 7)


def conversion(samples: int, config: dict) -> int:
    """Model operations of one conversion of ``samples`` at 16 kHz, the 3 s
    reflect pad a side included, the bucket's padding not."""
    s = samples + 2 * 3 * 16000
    m = config["synthesizer"]
    frames = s // 160
    dec = refinegan_decoder if m["vocoder"] == "RefineGAN" else nsf_decoder
    return (hubert(s, config["hubert"]) + rmvpe(s, config["rmvpe"])
            + text_encoder(frames, m) + flow(frames, m) + dec(frames, m))
