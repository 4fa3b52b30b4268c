"""The products of the plain reference, with the operand precision of the
control.

Every convolution and matrix product of ``benchmark/reference`` goes through
these functions, and every activation the reference keeps between layers
through ``q``. By default they compute in float32 (the caller turns TF32
off). Under ``operand_precision("fp8")`` both operands of each product, its
result and each kept activation are rounded to float8 e4m3 with one scale
per tensor (amax to 448), sums staying in float32: a model computed and
stored in fp8, the control that the benchmark's comparisons have to
reject. ``"bf16"`` rounds the same values to bfloat16: the yardstick of
what bf16 rounding alone costs a model."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
_MODE = {"kind": "fp32"}


@contextlib.contextmanager
def operand_precision(kind: str):
    """``"fp32"``, ``"bf16"`` or ``"fp8"`` for what is computed inside."""
    if kind not in ("fp32", "bf16", "fp8"):
        raise ValueError(f"unknown operand precision {kind!r}")
    old = _MODE["kind"]
    _MODE["kind"] = kind
    try:
        yield
    finally:
        _MODE["kind"] = old


def q(t: torch.Tensor) -> torch.Tensor:
    """A value as the current precision keeps it (float32 out)."""
    t = t.float()
    if _MODE["kind"] == "bf16":
        return t.to(torch.bfloat16).float()
    if _MODE["kind"] != "fp8":
        return t
    amax = t.abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return q(q(a) @ q(b))


def linear(x, w, b=None):
    y = q(x) @ q(w).t()
    return q(y if b is None else y + b.float())


def conv1d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    return q(F.conv1d(q(x), q(w), None if b is None else b.float(), stride,
                      padding, dilation, groups))


def conv_transpose1d(x, w, b=None, stride=1, padding=0, output_padding=0):
    return q(F.conv_transpose1d(q(x), q(w), None if b is None else b.float(),
                                stride, padding, output_padding))


def conv2d(x, w, b=None, padding=0):
    return q(F.conv2d(q(x), q(w), None if b is None else b.float(), 1, padding))


def conv_transpose2d(x, w, stride, padding, output_padding):
    return q(F.conv_transpose2d(q(x), q(w), None, stride, padding, output_padding))


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """v / ||v|| * g, the norm over every axis but the first (float32)."""
    v = v.float()
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)),
                                keepdim=True) + 1e-12)
    return v / norm * g.float().reshape(norm.shape)


def leaky(x, slope):
    return q(torch.where(x >= 0, x, x * slope))


def layer_norm(x, w, b, eps=1e-5):
    return q(F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps))


def gelu(x):
    return q(0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0))))
