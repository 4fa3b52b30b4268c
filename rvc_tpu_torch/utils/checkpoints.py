"""Model files: the reference's ``.pth`` and the JAX package's ``.npz``
(port of the loading half of ``rvc_tpu/utils/checkpoints.py``).

The port's synthesizer already carries the reference torch module names, so
``load_rvc_pth`` returns a ``state_dict`` in that layout (float32) and the
file's metadata, not a parameter tree. ``build_synthesizer`` rebuilds the
architecture the file records (``derive_synth_arch``) and loads the weights
strictly: only the posterior encoder (``enc_q.*``, training only) is
skipped; any other key that the model lacks, or that the file lacks, raises.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device

StateDict = Dict[str, torch.Tensor]

META_KEYS = ("config", "sr", "f0", "version", "vocoder", "embedder_model",
             "speakers_id", "author", "model_hash", "epoch", "step")
# the first ConvTranspose's kernel size is unique per sample rate (NSF's
# dec.ups.0, MRF HiFi-GAN's dec.upsamples.0; RefineGAN has none)
_SR_BY_UP0_KERNEL = {20: 32000, 16: 40000, 24: 48000}
_UP0_KEYS = ("dec.ups.0.weight_v", "dec.ups.0.weight", "dec.upsamples.0.weight_v",
             "dec.upsamples.0.weight")
# a key only that decoder has
_VOCODER_KEYS = (("dec.mrfs.0.0.layers.0.conv1.weight_v", "MRF HiFi-GAN"),
                 ("dec.mel_conv.weight_v", "RefineGAN"))


def detect_vocoder(sd: Dict[str, Any], meta: Dict[str, Any]) -> str:
    """The decoder a state_dict holds, by its keys as the JAX package's
    ``convert_torch_synthesizer`` recognises it (a full ``G_`` file carries
    no metadata); else the file's ``vocoder`` field, else HiFi-GAN."""
    for key, vocoder in _VOCODER_KEYS:
        if key in sd:
            return vocoder
    return meta.get("vocoder") or "HiFi-GAN"


def normalize_weight_norm_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Map ``parametrizations.weight.original{0,1}`` to ``weight_g/weight_v``."""
    out = {}
    for k, v in sd.items():
        k = k.replace(".parametrizations.weight.original0", ".weight_g")
        k = k.replace(".parametrizations.weight.original1", ".weight_v")
        out[k] = v
    return out


def normalize_sr(sr: Union[str, int, float, None]) -> Union[int, str, float, None]:
    """"48k" -> 48000; other values pass through."""
    if isinstance(sr, str) and sr.lower().endswith("k"):
        try:
            return int(float(sr[:-1]) * 1000)
        except ValueError:
            return sr
    return sr


def load_rvc_pth(path: str) -> Tuple[StateDict, Dict[str, Any]]:
    """Read a reference ``.pth``: (float32 state_dict in the port's layout
    without ``enc_q.*``, metadata).

    A deployable file keeps fp16 tensors under ``"weight"`` beside the
    18-element ``"config"`` list and the metadata fields; a full training
    checkpoint keeps them under ``"model"`` with no config and no sample
    rate, which then comes from the kernel size of the first transposed
    conv (``dec.ups.0``, or MRF HiFi-GAN's ``dec.upsamples.0``); where
    there is none that tells (RefineGAN), a warning is printed and callers
    assume 48 kHz, as in the JAX package. A discriminator checkpoint is
    refused."""
    cpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(cpt, dict) and "weight" in cpt:
        weights = cpt["weight"]
    elif isinstance(cpt, dict) and "model" in cpt:
        weights = cpt["model"]
    else:
        weights = cpt
    weights = {k: v for k, v in weights.items() if torch.is_tensor(v)}
    if any(k.startswith("discriminators.") for k in weights):
        raise ValueError(f"{path} is a discriminator checkpoint, not a voice model")
    sd = {k: (v.float() if torch.is_floating_point(v) else v)
          for k, v in normalize_weight_norm_keys(weights).items()
          if not k.startswith("enc_q.")}
    meta = {k: cpt.get(k) for k in META_KEYS} if isinstance(cpt, dict) else {}
    if not meta.get("sr"):
        k0 = next((int(sd[k].shape[-1]) for k in _UP0_KEYS if k in sd), None)
        sr = _SR_BY_UP0_KERNEL.get(k0)
        if sr is not None:
            meta["sr"] = sr
            print(f"load_rvc_pth: inferred sample_rate={sr} from decoder "
                  "shapes (checkpoint carries no sr metadata)")
        else:
            print("load_rvc_pth: WARNING - checkpoint has no sr metadata and "
                  "the decoder shape is unrecognized; callers will assume 48k, "
                  "which may mismatch")
    return sd, meta


def derive_synth_arch(sd: StateDict, meta: Dict[str, Any]
                      ) -> Tuple[Dict[str, Any], Optional[int]]:
    """Architecture overrides for rebuilding a synthesizer around loaded
    weights: the 18-element config list, as the reference reads it
    positionally, and the content-feature width from ``enc_p.emb_phone``
    (256 for v1 models, whose HuBERT then needs ``final_proj``). The flow's
    WaveNet depth is not in the list: each coupling's ``cond_layer`` emits
    2 x hidden x layers channels. Returns (``get_config`` overrides,
    flow layers or None)."""
    over: Dict[str, Any] = {}
    cfg_list = meta.get("config") or []
    if len(cfg_list) == 18:
        try:
            over = dict(
                filter_length=(int(cfg_list[0]) - 1) * 2,
                inter_channels=int(cfg_list[2]),
                hidden_channels=int(cfg_list[3]),
                filter_channels=int(cfg_list[4]),
                n_heads=int(cfg_list[5]),
                n_layers=int(cfg_list[6]),
                kernel_size=int(cfg_list[7]),
                p_dropout=float(cfg_list[8]),
                resblock_kernel_sizes=tuple(int(k) for k in cfg_list[10]),
                resblock_dilation_sizes=tuple(
                    tuple(int(d) for d in t) for t in cfg_list[11]),
                upsample_rates=tuple(int(r) for r in cfg_list[12]),
                upsample_initial_channel=int(cfg_list[13]),
                upsample_kernel_sizes=tuple(int(k) for k in cfg_list[14]),
                spk_embed_dim=int(cfg_list[15]),
                gin_channels=int(cfg_list[16]),
            )
        except (TypeError, ValueError):
            over = {}
    if "enc_p.emb_phone.weight" in sd:
        over["text_enc_hidden_dim"] = int(sd["enc_p.emb_phone.weight"].shape[1])
    flow_layers = None
    pre, cond = "flow.flows.0.pre.weight", "flow.flows.0.enc.cond_layer.weight_v"
    if pre in sd and cond in sd:
        hidden, cond_out = int(sd[pre].shape[0]), int(sd[cond].shape[0])
        if hidden > 0 and cond_out % (2 * hidden) == 0:
            flow_layers = cond_out // (2 * hidden)
    return over, flow_layers


def _fold_plain_weights(sd: StateDict, expected) -> StateDict:
    """A weight-normalized module's weight stored plain (``X.weight``) ->
    ``X.weight_v`` = the weight, ``X.weight_g`` = its norm over every axis
    but the first, so the module's effective weight is the stored one."""
    out = dict(sd)
    for k, w in sd.items():
        base = k[:-len(".weight")]
        if (k.endswith(".weight") and k not in expected
                and f"{base}.weight_v" in expected):
            out.pop(k)
            axes = tuple(range(1, w.ndim))
            out[f"{base}.weight_v"] = w
            out[f"{base}.weight_g"] = torch.sqrt(
                torch.sum(w * w, dim=axes, keepdim=True) + 1e-12)
    return out


def synthesizer_for(sd: StateDict, meta: Dict[str, Any], device: torch.device):
    """The unloaded synthesizer a file records, on ``device``: (model,
    ExperimentConfig, use_f0)."""
    from ..models.synthesizer import Synthesizer

    sr = normalize_sr(meta.get("sample_rate", meta.get("sr")))
    tgt_sr = int(sr) if sr else 48000
    vocoder = detect_vocoder(sd, meta)
    # full training checkpoints carry f0=None: pitch guidance unless 0
    f0_meta = meta.get("f0")
    use_f0 = bool(1 if f0_meta is None else f0_meta)
    arch, flow_layers = derive_synth_arch(sd, meta)
    arch.setdefault("spk_embed_dim", int(meta.get("speakers_id") or 109))
    cfg = get_config(tgt_sr, vocoder=vocoder, use_f0=use_f0, **arch)
    extra = {} if flow_layers is None else {"flow_layers": flow_layers}
    return Synthesizer.from_config(cfg, device=device, **extra), cfg, use_f0


def fold_plain_weights(sd: StateDict, meta: Dict[str, Any]) -> StateDict:
    """A file's state_dict with each plain weight of a weight-normalized
    module folded into ``weight_v`` / ``weight_g`` (the norm, as the JAX
    package's converter makes it), as ``build_synthesizer`` loads it."""
    with torch.device("meta"):
        model, _, _ = synthesizer_for(sd, meta, torch.device("meta"))
    return _fold_plain_weights(sd, model.state_dict())


def build_synthesizer(sd: StateDict, meta: Dict[str, Any],
                      device: Union[str, torch.device] = "cuda"):
    """Rebuild the synthesizer a loaded file records and load its weights
    strictly. Returns (model on ``device``, ExperimentConfig, use_f0)."""
    dev = resolve_device(device)
    model, cfg, use_f0 = synthesizer_for(sd, meta, torch.device("cpu"))
    expected = model.state_dict()
    sd = _fold_plain_weights(sd, expected)
    missing = sorted(set(expected) - set(sd))
    unexpected = sorted(set(sd) - set(expected))
    if missing or unexpected:
        raise ValueError(f"model file does not fit the architecture it records: "
                         f"missing {missing[:8]}, unexpected {unexpected[:8]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(f"{k}: file shape {tuple(v.shape)} != model shape "
                             f"{tuple(expected[k].shape)}")
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval(), cfg, use_f0


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read the JAX package's native ``.npz``: (parameter tree of numpy
    arrays, metadata from its ``__meta__`` JSON). A synthesizer's tree goes
    through ``convert.synthesizer_state_dict``."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__meta__"}
        meta = {}
        if "__meta__" in data.files:
            meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
    return _unflatten(flat), meta


def config_list(cfg) -> list:
    """The reference's 18-element deployable config list of a configuration
    (extract_model.py; read back positionally by ``derive_synth_arch``)."""
    d, m = cfg.data, cfg.model
    return [d.filter_length // 2 + 1, cfg.train.segment_size // d.hop_length,
            m.inter_channels, m.hidden_channels, m.filter_channels, m.n_heads,
            m.n_layers, m.kernel_size, m.p_dropout, "1",
            list(m.resblock_kernel_sizes),
            [list(t) for t in m.resblock_dilation_sizes], list(m.upsample_rates),
            m.upsample_initial_channel, list(m.upsample_kernel_sizes),
            m.spk_embed_dim, m.gin_channels, d.sample_rate]


def _cpu_state(module) -> StateDict:
    return {k: v.detach().float().cpu().clone() for k, v in module.state_dict().items()}


def export_rvc_pth(model, path: str, cfg, epoch: int = 0, step: int = 0,
                   name: Optional[str] = None) -> str:
    """Write a deployable ``.pth`` in the layout of the JAX package's
    ``export_rvc_pth`` (reference extract_model.py): fp16 tensors without
    the posterior encoder under ``"weight"``, the config list and the
    metadata fields ``load_rvc_pth`` reads."""
    import datetime
    import hashlib
    import os

    weight = {k: v.half() for k, v in _cpu_state(model).items()
              if not k.startswith("enc_q.")}
    config = config_list(cfg)
    sr = cfg.data.sample_rate
    name = name or os.path.splitext(os.path.basename(path))[0]
    hash_input = f"{name}-{epoch}-{step}-{sr}-v2-{config}"
    torch.save({"weight": weight, "config": config, "epoch": epoch, "step": step,
                "sr": sr, "f0": int(cfg.model.use_f0), "version": "v2",
                "creation_date": datetime.datetime.now().isoformat(),
                "model_hash": hashlib.sha256(hash_input.encode()).hexdigest(),
                "model_name": name, "vocoder": cfg.model.vocoder}, path)
    return path


def export_full_pth(model, path: str, epoch: int, learning_rate: float,
                    optimizer: Optional[Dict[str, Any]] = None, **extra) -> str:
    """Write a full training checkpoint in the layout of the JAX package's
    ``export_rvc_g_pth`` / ``export_rvc_d_pth`` (reference utils.py
    save_checkpoint): the float32 state_dict under ``"model"`` (a G keeps
    ``enc_q``), ``"iteration"`` (the epoch), ``"optimizer"`` (here the
    port's optimizer state, which resume reads back) and
    ``"learning_rate"``; ``extra`` keys beside them."""
    torch.save({"model": _cpu_state(model), "iteration": epoch,
                "optimizer": optimizer or {}, "learning_rate": learning_rate,
                **extra}, path)
    return path
