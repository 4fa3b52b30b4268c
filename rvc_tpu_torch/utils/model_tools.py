"""Model utilities: blending, information, metadata rewrite (port of
``rvc_tpu/utils/model_tools.py``).

Inputs are the reference's ``.pth`` (read by ``load_rvc_pth``, each plain
weight of a weight-normalized module folded into ``weight_v`` /
``weight_g`` as the JAX package's converter folds it) or the JAX package's
``.npz`` (carried across by ``convert.synthesizer_state_dict``). Both end
as the port's state_dict, whose weight-normalized convs keep ``weight_v``
and ``weight_g`` apart as the JAX tree keeps ``kernel`` and ``g``, so a
key-by-key blend computes what the JAX package's tree blend computes.

The blend is written as a deployable ``.pth`` in the reference's layout
(float32 tensors under ``"weight"``, the config list, ``sr``, ``f0``,
``version``, ``vocoder``) with the JAX package's ``blended_from``,
``blend_ratio`` and ``name`` beside them; the JAX package writes ``.npz``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .. import convert
from .checkpoints import (config_list, fold_plain_weights, load_checkpoint,
                          load_rvc_pth, normalize_sr, synthesizer_for)

StateDict = Dict[str, torch.Tensor]
# what a blend adds to the metadata it inherits
BLEND_KEYS = ("blended_from", "blend_ratio", "name")


def _load_any(path: str) -> Tuple[StateDict, Dict[str, Any]]:
    """(float32 state_dict in the port's layout, metadata) of a ``.pth`` or
    a JAX ``.npz``."""
    if path.endswith(".pth"):
        sd, meta = load_rvc_pth(path)
        blend = {k: v for k, v in torch.load(path, map_location="cpu", mmap=True,
                                             weights_only=True).items()
                 if k in BLEND_KEYS}
        return fold_plain_weights(sd, meta), {**meta, **blend}
    tree, meta = load_checkpoint(path)
    return convert.synthesizer_state_dict(tree.get("model", tree)), meta


def _blend(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """alpha*a + (1-alpha)*b in float32 over the shapes' common corner
    (``emb_g`` rows differ when the speaker counts do)."""
    a, b = a.float(), b.float()
    if a.shape != b.shape:
        corner = tuple(slice(0, min(x, y)) for x, y in zip(a.shape, b.shape))
        a, b = a[corner], b[corner]
    return alpha * a + (1.0 - alpha) * b


def model_blender(name: str, path_a: str, path_b: str, ratio: float = 0.5,
                  output_dir: str = "logs") -> str:
    """Blend model A into model B with ``ratio`` (A's share); writes
    ``<output_dir>/<name>.pth`` and returns its path. Models of different
    sample rates are refused; a missing rate is warned about."""
    sd_a, meta_a = _load_any(path_a)
    sd_b, meta_b = _load_any(path_b)
    sr_a = normalize_sr(meta_a.get("sample_rate", meta_a.get("sr")))
    sr_b = normalize_sr(meta_b.get("sample_rate", meta_b.get("sr")))
    # '48k' strings and 48000 ints compare equal; two unknown rates must
    # not pass as equal
    if sr_a is None or sr_b is None:
        print("model_blender: WARNING — sample-rate metadata missing on "
              f"{'both' if sr_a is None and sr_b is None else 'one'} model(s);"
              " blending without the rate compatibility check")
    elif sr_a != sr_b:
        raise ValueError(f"cannot blend models with different sample rates "
                         f"({sr_a} vs {sr_b})")
    blended = {k: (_blend(v, sd_b[k], ratio) if k in sd_b else v.float())
               for k, v in sd_a.items()}
    config = list(meta_b.get("config") or [])
    if len(config) != 18:  # a full training file: the list its shapes give
        with torch.device("meta"):
            config = config_list(synthesizer_for(sd_b, meta_b,
                                                  torch.device("meta"))[1])
    if "emb_g.weight" in blended:  # the cropped speaker count
        config[15] = int(blended["emb_g.weight"].shape[0])
    meta = dict(meta_b)
    meta.update({"config": config,
                 "blended_from": [os.path.basename(path_a), os.path.basename(path_b)],
                 "blend_ratio": ratio, "name": name})
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir, f"{name}.pth")
    torch.save({"weight": blended, **meta}, out)
    return out


def model_information(path: str) -> Dict[str, Any]:
    """Return (and print) a model file's metadata and parameter count."""
    sd, meta = _load_any(path)
    info = dict(meta)
    n_params = int(sum(v.numel() for v in sd.values()))
    if n_params:
        info["parameters"] = n_params
    for k, v in info.items():
        print(f"{k}: {v}")
    return info


def change_model_info(path: str, **updates) -> None:
    """Rewrite metadata fields (author, name, ...) in place: the top-level
    fields of a ``.pth``, the ``__meta__`` of a JAX ``.npz`` (whose
    ``model_hash`` is the digest of its arrays, as the JAX package writes
    it)."""
    if path.endswith(".pth"):
        cpt = torch.load(path, map_location="cpu", weights_only=True)
        cpt.update(updates)
        torch.save(cpt, path)
        return
    import hashlib

    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__meta__"}
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8")) \
            if "__meta__" in data.files else {}
    meta.update(updates)
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(k.encode())
        digest.update(flat[k].tobytes())
    meta["model_hash"] = digest.hexdigest()
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **flat)
