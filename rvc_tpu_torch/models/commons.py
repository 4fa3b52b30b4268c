"""Shared model building blocks (port of ``rvc_tpu/models/commons.py``).

Activations inside the port's modules are [batch, channels, time] (NCT), the
layout ``torch.nn.functional.conv1d`` takes. Public model entry points keep
the JAX package's [batch, time, channels] layout so tests compare like with
like.

Weight normalization is an explicit reparameterization with the JAX
package's ``sqrt(sum v^2 + 1e-12)`` norm. Parameter names follow the
reference torch layout (``weight_g`` / ``weight_v`` / ``bias``), so
``convert.py`` maps the flax trees one to one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resblock import WeightCache, resblock_chain

LRELU_SLOPE = 0.1


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> [B, T] float mask (1 inside the sequence)."""
    pos = torch.arange(max_length, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """Fixed-size time slices per batch element: x [B, T, ...], ids_str [B]
    start frames (clamped to [0, T - segment_size]) -> [B, segment_size,
    ...]. The gather's gradient scatters back into x."""
    starts = torch.clamp(ids_str.long(), 0, x.shape[1] - segment_size)
    idx = starts[:, None] + torch.arange(segment_size, device=x.device)[None]
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class RowDraws:
    """A random source for some rows of a batch. Each draw is made for the
    whole batch of ``total`` rows from ``generator``, and the rows ``rows``
    (a list of row indices) are kept. Ranks or replicas that each hold a
    share of one batch thus draw, together, what one process draws for the
    whole batch. Every draw of the models goes through ``draw``, and every
    one of them has the batch as its leading axis."""

    def __init__(self, generator: torch.Generator, rows: Sequence[int],
                 total: int):
        self.generator, self.rows, self.total = generator, list(rows), int(total)

    @property
    def device(self) -> torch.device:
        return self.generator.device


def draw(kind: str, shape: Sequence[int], generator, device) -> torch.Tensor:
    """``torch.rand`` (``kind="rand"``) or ``torch.randn`` of ``shape`` on
    ``device`` from ``generator``: a ``torch.Generator``, a ``RowDraws``
    (drawn on its generator's device and moved) or None."""
    fn = torch.rand if kind == "rand" else torch.randn
    if isinstance(generator, RowDraws):
        full = fn((generator.total, *shape[1:]), generator=generator.generator,
                  device=generator.device)
        rows = torch.as_tensor(generator.rows, device=full.device)
        return full.index_select(0, rows).to(device)
    return fn(tuple(shape), generator=generator, device=device)


def rand_slice_starts(lengths: torch.Tensor, segment_size: int,
                      generator=None) -> torch.Tensor:
    """Per-sample slice starts [B] int32, uniform over [0, length - segment]
    (reference commons.py:88-103); the uniform draws are made on the
    generator's device (the host's by default) and moved to the lengths'."""
    ids_max = torch.clamp(lengths - segment_size + 1, min=1).float()
    u = draw("rand", (lengths.shape[0],), generator,
             generator.device if generator is not None else None)
    return (u.to(lengths.device) * ids_max).to(torch.int32)


def rand_slice_segments(x: torch.Tensor, x_lengths: torch.Tensor,
                        segment_size: int,
                        generator: Optional[torch.Generator] = None):
    """Random per-sample slices of x [B, T, ...]: (slices, starts [B])."""
    ids_str = rand_slice_starts(x_lengths, segment_size, generator)
    return slice_segments(x, ids_str, segment_size), ids_str


def kl_divergence(m_p: torch.Tensor, logs_p: torch.Tensor, m_q: torch.Tensor,
                  logs_q: torch.Tensor) -> torch.Tensor:
    """KL(p || q) per element for diagonal gaussians (commons.py:43-57)."""
    kl = (logs_q - logs_p) - 0.5
    return kl + 0.5 * (torch.exp(2.0 * logs_p) + (m_p - m_q) ** 2) * torch.exp(
        -2.0 * logs_q)


def fused_gate(x: torch.Tensor, hidden: int) -> torch.Tensor:
    """tanh(x[:, :H]) * sigmoid(x[:, H:]) over the channel axis (NCT)."""
    return torch.tanh(x[:, :hidden]) * torch.sigmoid(x[:, hidden:])


def source_downsample_geometry(
    upsample_rates: Sequence[int], i: int
) -> Tuple[int, int, int]:
    """(stride, kernel, padding) of the NSF source-downsampling conv at
    decoder stage i: the stride is the product of the remaining upsample
    rates, kernel 2s - s%2, padding (kernel - s)//2."""
    stride = math.prod(upsample_rates[i + 1:]) if i + 1 < len(upsample_rates) else 1
    nk = 1 if stride == 1 else stride * 2 - stride % 2
    npad = 0 if stride == 1 else (nk - stride) // 2
    return stride, nk, npad


def weight_norm(v: torch.Tensor, g: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """v / ||v|| * g with the norm taken over every axis but ``dim``.

    Computed in float32 and returned in ``v``'s dtype."""
    vf = v.float()
    axes = tuple(a for a in range(v.ndim) if a != dim)
    norm = torch.sqrt(torch.sum(vf * vf, dim=axes, keepdim=True) + 1e-12)
    return (vf / norm * g.float().reshape(norm.shape)).to(v.dtype)


class Conv1d(nn.Module):
    """1D convolution on [B, C, T], optionally weight-normalized.

    ``padding=None`` gives the "same" padding (k*d - d) // 2."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 padding: Optional[int] = None, bias: bool = True,
                 weight_norm: bool = False):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = ((kernel_size * dilation - dilation) // 2
                        if padding is None else padding)
        self.use_weight_norm = weight_norm
        shape = (out_channels, in_channels // groups, kernel_size)
        if weight_norm:
            self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1))
            self.weight_v = nn.Parameter(torch.zeros(shape))
        else:
            self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def effective_weight(self) -> torch.Tensor:
        if self.use_weight_norm:
            return weight_norm(self.weight_v, self.weight_g, dim=0)
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.effective_weight()
        return F.conv1d(x.to(w.dtype), w, self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose1d(nn.Module):
    """Transposed 1D convolution with torch semantics, weight-normalized
    per input channel (weight_norm dim 0 on the [in, out, K] weight)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, output_padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.weight_g = nn.Parameter(torch.ones(in_channels, 1, 1))
        self.weight_v = nn.Parameter(
            torch.zeros(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = weight_norm(self.weight_v, self.weight_g, dim=0)
        x = x.to(w.dtype)
        if x.device.type == "cpu" and w.dtype == torch.bfloat16:
            # PyTorch's CPU bf16 transposed convolution returns a wrong input
            # gradient at some strides (8 and 12 among them); on bf16 operands
            # the f32 form is the same product with f32 sums, rounded once
            return F.conv_transpose1d(x.float(), w.float(), self.bias.float(),
                                      self.stride, self.padding,
                                      self.output_padding).to(w.dtype)
        return F.conv_transpose1d(x, w, self.bias, self.stride, self.padding,
                                  self.output_padding)


class WaveNet(nn.Module):
    """Non-causal WaveNet stack with gated activations and global
    conditioning (reference modules.py). The last layer's res_skip conv has
    H outputs (skip only)."""

    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        h = hidden_channels
        self.hidden_channels, self.n_layers = h, n_layers
        self.cond_layer = (Conv1d(gin_channels, 2 * h * n_layers, 1,
                                  weight_norm=True) if gin_channels else None)
        self.in_layers = nn.ModuleList(
            Conv1d(h, 2 * h, kernel_size, dilation=dilation_rate ** i,
                   weight_norm=True) for i in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            Conv1d(h, 2 * h if i < n_layers - 1 else h, 1, weight_norm=True)
            for i in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g) if (g is not None and self.cond_layer) else None
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            if g_all is not None:
                x_in = x_in + g_all[:, i * 2 * h:(i + 1) * 2 * h]
            acts = fused_gate(x_in, h)
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask


class ChainBlock(nn.Module):
    """One residual chain over a dilation schedule: per dilation d,
    leaky ReLU, a weight-normalized conv of dilation d, leaky ReLU, a conv
    of dilation 1, and the residual. A subclass holds the convs under its
    reference's names and lists them in ``conv_pairs``.

    Decoders do not call a chain of a stage one by one: their stage tails
    (``generators.nsf._resblock_stage``) gather every chain's folded weights
    and run through ``ops.resblock``. The folded weights and the kernel's
    packed weights are cached on the module and rebuilt when a parameter
    changes, so inference folds and packs once."""

    def __init__(self, kernel_size: int, dilations: Sequence[int], slope: float):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.slope = slope
        self._folded = WeightCache()   # weight norm applied
        self.packed = WeightCache()    # the chain kernel's packed weights

    def conv_pairs(self) -> Sequence[Tuple[Conv1d, Conv1d]]:
        raise NotImplementedError

    def chain_weights(self):
        """(w1s, b1s, w2s, b2s): folded [C, C, K] weights and biases per
        dilation, as ``ops.resblock`` takes them. With gradients off the
        folded weights are kept until a parameter changes."""
        def fold():
            pairs = self.conv_pairs()
            return ([c1.effective_weight() for c1, _ in pairs],
                    [c1.bias for c1, _ in pairs],
                    [c2.effective_weight() for _, c2 in pairs],
                    [c2.bias for _, c2 in pairs])

        if torch.is_grad_enabled():
            return fold()
        return self._folded.get(list(self.parameters()), "folded", fold)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One chain through K2 (``resblock_chain``) at the block's slope."""
        return resblock_chain(x, *self.chain_weights(), self.dilations,
                              slope=self.slope, cache=self.packed)


class ResBlock(ChainBlock):
    """HiFi-GAN multi-dilation residual block (reference residuals.py):
    ``convs1.{i}`` of dilation d_i and ``convs2.{i}`` of dilation 1.
    ``slope`` is the leaky ReLU's (RefineGAN's chains take 0.2)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5),
                 slope: float = LRELU_SLOPE):
        super().__init__(kernel_size, dilations, slope)
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d, weight_norm=True)
            for d in self.dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=1, weight_norm=True)
            for _ in self.dilations)

    def conv_pairs(self):
        return list(zip(self.convs1, self.convs2))
