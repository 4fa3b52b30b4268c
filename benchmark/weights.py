"""Seeded weights and index, made on the device in a few large draws.

Each model's state_dict is one standard-normal draw on the device, cut into
its tensors and scaled by a rule of the tensor's role: fan-in scaling for
conv, linear and recurrent weights (so that activations keep their scale
through depth), unit gains for weight norms and layer norms, small biases,
unit running variances. The same seed gives the same tensors, which the
benchmark hands to the program and to the reference alike."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of ``seed`` (``tags``: strings or ints)."""
    words = [int(seed) % (1 << 63)]
    for tag in tags:
        words += list(tag.encode()) if isinstance(tag, str) else [int(tag) % (1 << 63)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def _scale(name: str, shape: Sequence[int]):
    """(mean, std) of one tensor, by its role."""
    last = name.rsplit(".", 1)[-1]
    if last == "running_var":
        return 1.0, 0.0
    if last in ("running_mean", "bias", "beta") or last.startswith(("bi_", "bhn_")):
        return 0.0, 0.02
    if ".blocks." in name and name.endswith((".0.weight", ".2.weight")) and len(shape) == 1:
        return 0.1, 0.002       # RefineGAN's AdaIN noise gains: a tenth of the signal
    if last == "gamma" or (last == "weight" and len(shape) == 1):
        return 1.0, 0.02
    if last == "weight_g":
        return 1.0, 0.02
    if last.startswith(("wi_", "wh_")):
        # half the fan-in scale: gates off saturation, a contracting
        # recurrence (a trained GRU's regime)
        return 0.0, 0.5 * shape[0] ** -0.5
    if last.startswith("emb_rel"):
        return 0.0, shape[-1] ** -0.5
    if name == "emb_g.weight":
        return 0.0, 1.0
    # the prior multiplies its embedded input by sqrt(hidden): VITS's
    # embedding std of hidden^-1/2 keeps the product at unit scale
    if name.endswith("emb_pitch.weight"):                   # [256, hidden]
        return 0.0, shape[1] ** -0.5
    if name.endswith("emb_phone.weight"):                   # [hidden, features]
        return 0.0, (shape[0] * shape[1]) ** -0.5
    if "decoder.layers" in name and name.endswith("conv1.0.weight"):
        return 0.0, (shape[0] * 9 / 4) ** -0.5      # stride-2 transposed 3x3
    return 0.0, math.prod(shape[1:]) ** -0.5


def seeded_state(shapes: Dict[str, Sequence[int]], seed: int, tag: str,
                 device, upsample_rates: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """float32 tensors for ``shapes`` (name -> shape), from one draw."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, tag))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        mean, std = _scale(name, shape)
        if name.endswith("weight_g") and ".ups." in name:
            # a transposed conv's per-input-channel norm that keeps the
            # scale: each output sample sums c_in * K / stride products
            v = shapes[name[:-1] + "v"]                 # [c_in, c_out, K]
            i = int(name.split(".ups.")[1].split(".")[0])
            mean = math.sqrt(v[1] * upsample_rates[i] / v[0])
            std = 0.02 * mean
        out[name] = flat[off:off + n].view(*shape) * std + mean
        off += n
    return out


# RMVPE's batch norms take their statistics from this much of a seeded voice
CALIBRATION_SAMPLES = 4 * 16000
CALIBRATION_SIGNAL = {"rate": 16000, "f0_hz": [100, 300], "third_harmonic": 0.3,
                      "tremolo_hz": 2.0, "gap_period_s": 0.4, "gap_on_s": 0.3,
                      "amplitude": 0.5, "noise": 0.03}


def model_states(config: dict, shapes: Dict[str, dict], seed: int, device) -> dict:
    """Each model's state_dict from ``seed``: ``seeded_state``, and for
    RMVPE batch-norm statistics calibrated on a seeded voice by the
    reference (``reference.rmvpe.calibrate``), as a trained model's are."""
    from .reference import rmvpe
    from .traffic import voice

    rates = config["synthesizer"]["upsample_rates"]
    out = {tag: seeded_state(s, seed, tag, device, rates) for tag, s in shapes.items()}
    rng = np.random.default_rng(derive_seed(seed, "calibration"))
    audio = torch.from_numpy(voice(CALIBRATION_SAMPLES, rng, CALIBRATION_SIGNAL))
    rmvpe.calibrate(out["rmvpe"], audio[None].to(device), config["rmvpe"])
    return out


def float_shapes(module: torch.nn.Module) -> Dict[str, Sequence[int]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()
            if torch.is_floating_point(v)}


def seeded_index(rows: int, dim: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "index"))
    return torch.randn((rows, dim), generator=gen, device=device)
