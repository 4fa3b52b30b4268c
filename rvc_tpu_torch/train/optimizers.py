"""Optimizers of the training step (port of ``rvc_tpu/train/optimizers.py``).

AdamW, RAdam and Ranger21 with betas (0.8, 0.99), eps 1e-9 and weight decay
0, written out as the optax chains the JAX package builds, so that the two
packages take the same step from the same gradients (``torch.optim.AdamW``
would add a weight decay of 1e-2 by default, and its RAdam places eps
elsewhere):

  - ``adamw``: ``optax.adamw`` (bias-corrected moments, eps outside the root);
  - ``radam``: ``optax.radam`` (rectified when rho_t >= 5, else momentum);
  - ``ranger21``: adaptive gradient clipping (0.01, eps 1e-3) -> gradient
    centralization of conv kernels -> the AdamW core -> lookahead (every 5
    steps the slow weights move half way; kept in the optimizer state).

AGC and gradient centralization reduce over the axes of the JAX package's
parameter layout, so each parameter carries its ``jax_layout`` (the
permutation that turns the torch tensor into the flax leaf, or ``FLAT``):
a conv kernel [out, in, K] is flax's [K, in, out]. The learning rate is a
function of the optimizer's step count (``schedules.py``), as optax's
schedules are.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

BETAS = (0.8, 0.99)
EPS = 1e-9
AGC_CLIP, AGC_EPS = 0.01, 1e-3
LOOKAHEAD_K, LOOKAHEAD_ALPHA = 5, 0.5
RADAM_THRESHOLD = 5.0
FLAT = "flat"

Layout = Union[Tuple[int, ...], str]
Schedule = Union[float, Callable[[int], float]]


def jax_layouts(module: nn.Module) -> Dict[str, Layout]:
    """Parameter name -> the layout of its flax counterpart: a permutation
    of the torch axes, or ``FLAT`` for a weight-norm gain (flax keeps it as
    a vector). Conv weights [out, in, K] -> [K, in, out]; transposed conv
    [in, out, K] -> [K, in, out]; 2D conv [out, in, kh, kw] -> HWIO; dense
    [out, in] -> [in, out]; everything else as it is."""
    from ..models.commons import Conv1d, ConvTranspose1d
    from ..models.discriminators import NormConv2d

    out: Dict[str, Layout] = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if pname == "weight_g":
                layout = FLAT
            elif pname in ("weight", "weight_v") and isinstance(mod, Conv1d):
                layout = (2, 1, 0)
            elif pname == "weight_v" and isinstance(mod, ConvTranspose1d):
                layout = (2, 0, 1)
            elif pname in ("weight", "weight_v") and isinstance(mod, NormConv2d):
                layout = (2, 3, 1, 0)
            elif pname == "weight" and isinstance(mod, nn.Linear):
                layout = (1, 0)
            else:
                layout = tuple(range(p.ndim))
            out[name] = layout
    return out


def _view(t: torch.Tensor, layout: Layout) -> torch.Tensor:
    return t.reshape(-1) if layout == FLAT else t.permute(*layout)


def _unview(v: torch.Tensor, layout: Layout, like: torch.Tensor) -> torch.Tensor:
    if layout == FLAT:
        return v.reshape(like.shape)
    inverse = [0] * len(layout)
    for i, a in enumerate(layout):
        inverse[a] = i
    return v.permute(*inverse)


def unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    """optax's ``unitwise_norm`` on a tensor in flax layout: the whole of a
    vector, axis 0 of a rank-2 or rank-3 tensor, axes (0, 1, 2) of a rank-4
    one; broadcast back to x's shape."""
    if x.squeeze().ndim <= 1:
        sq = torch.sum(x * x)
    elif x.ndim in (2, 3):
        sq = torch.sum(x * x, dim=0, keepdim=True)
    elif x.ndim == 4:
        sq = torch.sum(x * x, dim=(0, 1, 2), keepdim=True)
    else:
        raise ValueError(f"unitwise_norm: rank {x.ndim} parameter {tuple(x.shape)}")
    return torch.sqrt(sq).expand_as(x)


def adaptive_grad_clip(g: torch.Tensor, p: torch.Tensor, layout: Layout) -> torch.Tensor:
    """optax.adaptive_grad_clip(0.01, eps=1e-3) on one parameter."""
    gv, pv = _view(g, layout), _view(p, layout)
    g_norm, p_norm = unitwise_norm(gv), unitwise_norm(pv)
    max_norm = AGC_CLIP * torch.clamp(p_norm, min=AGC_EPS)
    clipped = gv * (max_norm / torch.clamp(g_norm, min=1e-6))
    return _unview(torch.where(g_norm < max_norm, gv, clipped), layout, g)


def centralize(g: torch.Tensor, layout: Layout) -> torch.Tensor:
    """Gradient centralization of conv kernels (rank >= 3 in flax layout):
    subtract the mean over every flax axis but the first."""
    gv = _view(g, layout)
    if gv.ndim < 3:
        return g
    gv = gv - gv.mean(dim=tuple(range(1, gv.ndim)), keepdim=True)
    return _unview(gv, layout, g)


class Optimizer:
    """One of ``adamw``, ``radam``, ``ranger21`` over a list of parameters,
    stepped with a list of gradients (``step``), the parameters updated in
    place. ``layouts`` (``jax_layouts``) are needed by ranger21 only."""

    def __init__(self, name: str, params: Sequence[torch.Tensor], lr: Schedule,
                 layouts: Optional[Sequence[Layout]] = None):
        self.name = name.lower()
        if self.name not in ("adamw", "radam", "ranger21"):
            raise ValueError(f"unknown optimizer {name!r} (expected AdamW/RAdam/Ranger21)")
        self.params = list(params)
        self.lr = lr if callable(lr) else (lambda count, v=float(lr): v)
        self.layouts = (list(layouts) if layouts is not None
                        else [tuple(range(p.ndim)) for p in self.params])
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.slow = ([p.detach().clone() for p in self.params]
                     if self.name == "ranger21" else [])
        self.lookahead_count = 0

    def current_lr(self) -> float:
        return float(self.lr(self.count))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = [g.float() for g in grads]
        if self.name == "ranger21":
            grads = [centralize(adaptive_grad_clip(g, p, lay), lay)
                     for g, p, lay in zip(grads, self.params, self.layouts)]
        lr = self.current_lr()
        self.count += 1
        t = self.count
        b1, b2 = BETAS
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** t)
        scale = lr
        if self.name == "radam":
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            ro = ro_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t)
            if ro < RADAM_THRESHOLD:
                torch._foreach_add_(self.params, mu_hat, alpha=-lr)
                return
            scale = lr * ((ro - 4.0) * (ro - 2.0) * ro_inf
                          / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)) ** 0.5
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(self.params, mu_hat, alpha=-scale)
        if self.name == "ranger21":
            self.lookahead_count += 1
            if self.lookahead_count % LOOKAHEAD_K == 0:
                torch._foreach_lerp_(self.slow, self.params, LOOKAHEAD_ALPHA)
                torch._foreach_copy_(self.params, self.slow)

    def state_dict(self) -> Dict[str, object]:
        return {"name": self.name, "count": self.count,
                "lookahead_count": self.lookahead_count,
                "mu": [t.detach().cpu() for t in self.mu],
                "nu": [t.detach().cpu() for t in self.nu],
                "slow": [t.detach().cpu() for t in self.slow]}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore a ``state_dict`` of the same optimizer over parameters of
        the same shapes; raises ValueError otherwise."""
        if state.get("name") != self.name:
            raise ValueError(f"optimizer state of {state.get('name')!r}, not {self.name!r}")
        for key in ("mu", "nu", "slow"):
            have, got = getattr(self, key), state[key]
            if len(have) != len(got) or any(a.shape != b.shape for a, b in zip(have, got)):
                raise ValueError(f"optimizer state {key!r} does not fit the parameters")
            for a, b in zip(have, got):
                a.copy_(b)
        self.count = int(state["count"])
        self.lookahead_count = int(state["lookahead_count"])


def module_optimizer(name: str, module: nn.Module, lr: Schedule) -> Optimizer:
    """An ``Optimizer`` over ``module``'s parameters in ``named_parameters``
    order, with their flax layouts."""
    layouts = jax_layouts(module)
    names = [n for n, _ in module.named_parameters()]
    return Optimizer(name, [p for _, p in module.named_parameters()], lr,
                     [layouts[n] for n in names])
