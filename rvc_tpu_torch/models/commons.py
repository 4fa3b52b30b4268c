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
        return F.conv_transpose1d(x.to(w.dtype), w, self.bias, self.stride,
                                  self.padding, self.output_padding)


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


class ResBlock(nn.Module):
    """HiFi-GAN multi-dilation residual block (reference residuals.py).

    Holds the chain's weight-normalized convs. The decoder does not call it
    per chain: ``generators.nsf._resblock_stage`` gathers every chain's
    folded weights and runs the stage tail through ``ops.resblock``.

    The folded weights and the kernel's packed weights are cached on the
    module and rebuilt when a parameter changes, so inference folds and
    packs once."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d, weight_norm=True)
            for d in self.dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=1, weight_norm=True)
            for _ in self.dilations)
        self._folded = WeightCache()   # weight norm applied
        self.packed = WeightCache()    # the chain kernel's packed weights

    def chain_weights(self):
        """(w1s, b1s, w2s, b2s): folded [C, C, K] weights and biases per
        dilation, as ``ops.resblock`` takes them. With gradients off the
        folded weights are kept until a parameter changes."""
        def fold():
            return ([c.effective_weight() for c in self.convs1],
                    [c.bias for c in self.convs1],
                    [c.effective_weight() for c in self.convs2],
                    [c.bias for c in self.convs2])

        if torch.is_grad_enabled():
            return fold()
        return self._folded.get(list(self.parameters()), "folded", fold)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resblock_chain(x, *self.chain_weights(), self.dilations,
                              slope=LRELU_SLOPE, cache=self.packed)
