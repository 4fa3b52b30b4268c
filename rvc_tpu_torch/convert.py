"""Weights carried across from the JAX package.

Each function takes a flax parameter tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)`` on the JAX side) and returns a
``state_dict`` of torch tensors for the port's module. The synthesizer
mapping is the port's own copy of the key layout of the JAX package's
``utils/export_torch.py`` (the reference torch layout), so a later ``.pth``
loader reads the same names. Flax conv kernels are [K, in, out]; scanned
stacks (TextEncoder ``blocks``, WaveNet ``layers``, HuBERT ``layers``) carry
a leading layer axis.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _layer(stacked: Tree, i: int) -> Tree:
    """Slice layer i out of a scanned parameter stack (nested dicts)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else np.asarray(v)[i])
            for k, v in stacked.items()}


def _conv1d(sd, prefix: str, p: Tree, weight_norm: bool = False) -> None:
    w = np.transpose(np.asarray(p["kernel"]), (2, 1, 0))  # [out, in, K]
    if weight_norm:
        sd[f"{prefix}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
        sd[f"{prefix}.weight_v"] = _t(w)
    else:
        sd[f"{prefix}.weight"] = _t(w)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _dense(sd, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd, prefix: str, p: Tree, names=("weight", "bias")) -> None:
    sd[f"{prefix}.{names[0]}"] = _t(p["scale"])
    sd[f"{prefix}.{names[1]}"] = _t(p["bias"])


def _wavenet(sd, prefix: str, p: Tree) -> None:
    if "cond_layer" in p:
        _conv1d(sd, f"{prefix}.cond_layer", p["cond_layer"], weight_norm=True)
    n_scan = 0
    if "layers" in p:
        n_scan = int(next(iter(_flatten(p["layers"]).values())).shape[0])
    for i in range(n_scan):
        layer = _layer(p["layers"], i)
        _conv1d(sd, f"{prefix}.in_layers.{i}", layer["in"], weight_norm=True)
        _conv1d(sd, f"{prefix}.res_skip_layers.{i}", layer["res_skip"],
                weight_norm=True)
    _conv1d(sd, f"{prefix}.in_layers.{n_scan}", p["in_final"], weight_norm=True)
    _conv1d(sd, f"{prefix}.res_skip_layers.{n_scan}", p["res_skip_final"],
            weight_norm=True)


def synthesizer_state_dict(params: Tree,
                           posterior: bool = False) -> Dict[str, torch.Tensor]:
    """flax ``Synthesizer`` params (NSF decoder, or the plain HiFi-GAN
    decoder of a model without pitch: no ``emb_pitch``, ``m_source`` or
    ``noise_convs``) -> the port's ``Synthesizer`` state_dict. The
    posterior encoder (``enc_q``) comes across with ``posterior``, for a
    model built to train."""
    sd: Dict[str, torch.Tensor] = {}
    if posterior:
        _conv1d(sd, "enc_q.pre", params["enc_q"]["pre"])
        _wavenet(sd, "enc_q.enc", params["enc_q"]["enc"])
        _conv1d(sd, "enc_q.proj", params["enc_q"]["proj"])
    enc = params["enc_p"]
    _dense(sd, "enc_p.emb_phone", enc["emb_phone"])
    if "emb_pitch" in enc:
        sd["enc_p.emb_pitch.weight"] = _t(enc["emb_pitch"]["embedding"])
    blocks = enc["encoder"]["blocks"]
    n_layers = int(next(iter(_flatten(blocks).values())).shape[0])
    for i in range(n_layers):
        layer = _layer(blocks, i)
        a = f"enc_p.encoder.attn_layers.{i}"
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv1d(sd, f"{a}.{name}", layer["attn"][name])
        sd[f"{a}.emb_rel_k"] = _t(layer["attn"]["emb_rel_k"])
        sd[f"{a}.emb_rel_v"] = _t(layer["attn"]["emb_rel_v"])
        _norm(sd, f"enc_p.encoder.norm_layers_1.{i}", layer["norm1"],
              ("gamma", "beta"))
        _conv1d(sd, f"enc_p.encoder.ffn_layers.{i}.conv_1", layer["ffn"]["conv_1"])
        _conv1d(sd, f"enc_p.encoder.ffn_layers.{i}.conv_2", layer["ffn"]["conv_2"])
        _norm(sd, f"enc_p.encoder.norm_layers_2.{i}", layer["norm2"],
              ("gamma", "beta"))
    _conv1d(sd, "enc_p.proj", enc["proj"])

    n_couplings = sum(1 for k in params["flow"] if k.startswith("coupling_"))
    for i in range(n_couplings):
        c = params["flow"][f"coupling_{i}"]
        f = f"flow.flows.{2 * i}"
        _conv1d(sd, f"{f}.pre", c["pre"])
        _wavenet(sd, f"{f}.enc", c["enc"])
        _conv1d(sd, f"{f}.post", c["post"])

    dec = params["dec"]
    _conv1d(sd, "dec.conv_pre", dec["conv_pre"])
    _conv1d(sd, "dec.conv_post", dec["conv_post"])
    if "m_source" in dec:
        _dense(sd, "dec.m_source.l_linear", dec["m_source"]["l_linear"])
    if "cond" in dec:
        _conv1d(sd, "dec.cond", dec["cond"])
    n_ups = sum(1 for k in dec if k.startswith("ups_"))
    num_kernels = sum(1 for k in dec if k.startswith("resblock_0_"))
    for i in range(n_ups):
        up = dec[f"ups_{i}"]
        sd[f"dec.ups.{i}.weight_g"] = _t(np.asarray(up["g"]).reshape(-1, 1, 1))
        sd[f"dec.ups.{i}.weight_v"] = _t(
            np.transpose(np.asarray(up["kernel"]), (1, 2, 0)))  # [in, out, K]
        sd[f"dec.ups.{i}.bias"] = _t(up["bias"])
        if f"noise_convs_{i}" in dec:
            _conv1d(sd, f"dec.noise_convs.{i}", dec[f"noise_convs_{i}"])
        for j in range(num_kernels):
            rb = dec[f"resblock_{i}_{j}"]
            flat = i * num_kernels + j
            c = 0
            while f"conv1_{c}" in rb:
                _conv1d(sd, f"dec.resblocks.{flat}.convs1.{c}", rb[f"conv1_{c}"],
                        weight_norm=True)
                _conv1d(sd, f"dec.resblocks.{flat}.convs2.{c}", rb[f"conv2_{c}"],
                        weight_norm=True)
                c += 1
    sd["emb_g.weight"] = _t(params["emb_g"]["embedding"])
    return sd


def _conv2d_wn(sd, prefix: str, p: Tree) -> None:
    """A flax HWIO conv -> torch [out, in, kh, kw] (weight-normalized when
    the tree has ``g``)."""
    w = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
    if "g" in p:
        sd[f"{prefix}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1, 1))
        sd[f"{prefix}.weight_v"] = _t(w)
    else:
        sd[f"{prefix}.weight"] = _t(w)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def mpd_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """flax ``MultiPeriodDiscriminator`` params (weight or spectral norm) ->
    the port's ``MultiPeriodDiscriminator`` state_dict: the reference torch
    layout (``discriminators.0`` the scale discriminator, then one per
    period in the order of ``periods``)."""
    sd: Dict[str, torch.Tensor] = {}
    s = params["disc_s"]
    for i in range(6):
        _conv1d(sd, f"discriminators.0.convs.{i}", s[f"conv_{i}"],
                weight_norm="g" in s[f"conv_{i}"])
    _conv1d(sd, "discriminators.0.conv_post", s["conv_post"],
            weight_norm="g" in s["conv_post"])
    periods = sorted(int(k[len("disc_p"):]) for k in params if k.startswith("disc_p"))
    for j, per in enumerate(periods, start=1):
        d = params[f"disc_p{per}"]
        for i in range(5):
            _conv2d_wn(sd, f"discriminators.{j}.convs.{i}", d[f"conv_{i}"])
        _conv2d_wn(sd, f"discriminators.{j}.conv_post", d["conv_post"])
    return sd


def hubert_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """flax ``FlaxHubert`` params -> the port's ``Hubert`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    fe = params["feature_extractor"]
    i = 0
    while f"conv_{i}" in fe:
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = _t(
            np.transpose(np.asarray(fe[f"conv_{i}"]["kernel"]), (2, 1, 0)))
        i += 1
    _norm(sd, "feature_extractor.conv_layers.0.layer_norm", fe["group_norm"])
    _norm(sd, "feature_projection.layer_norm", params["feature_projection_norm"])
    _dense(sd, "feature_projection.projection", params["feature_projection"])
    pc = params["pos_conv_embed"]
    sd["encoder.pos_conv_embed.conv.weight_v"] = _t(
        np.transpose(np.asarray(pc["kernel"]), (2, 1, 0)))
    sd["encoder.pos_conv_embed.conv.weight_g"] = _t(
        np.asarray(pc["g"]).reshape(-1, 1, 1))
    sd["encoder.pos_conv_embed.conv.bias"] = _t(pc["bias"])
    _norm(sd, "encoder.layer_norm", params["encoder_layer_norm"])
    stacked = params["layers"]["layer"]
    n_layers = int(next(iter(_flatten(stacked).values())).shape[0])
    for li in range(n_layers):
        layer = _layer(stacked, li)
        pre = f"encoder.layers.{li}"
        att = layer["attention"]
        for src, dst in (("query", "q_proj"), ("key", "k_proj"),
                         ("value", "v_proj")):
            k = np.asarray(att[src]["kernel"])  # [in, heads, head_dim]
            sd[f"{pre}.attention.{dst}.weight"] = _t(k.reshape(k.shape[0], -1).T)
            sd[f"{pre}.attention.{dst}.bias"] = _t(
                np.asarray(att[src]["bias"]).reshape(-1))
        k = np.asarray(att["out"]["kernel"])    # [heads, head_dim, out]
        sd[f"{pre}.attention.out_proj.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
        sd[f"{pre}.attention.out_proj.bias"] = _t(att["out"]["bias"])
        _norm(sd, f"{pre}.layer_norm", layer["layer_norm"])
        _dense(sd, f"{pre}.feed_forward.intermediate_dense",
               layer["intermediate_dense"])
        _dense(sd, f"{pre}.feed_forward.output_dense", layer["output_dense"])
        _norm(sd, f"{pre}.final_layer_norm", layer["final_layer_norm"])
    if "final_proj" in params:
        _dense(sd, "final_proj", params["final_proj"])
    return sd


def _conv2d_weight(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))  # [out, in, kh, kw]


def _bn(sd, prefix: str, p: Tree, s: Tree) -> None:
    _norm(sd, prefix, p)
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])


def _conv_block(sd, prefix: str, p: Tree, s: Tree) -> None:
    sd[f"{prefix}.conv.0.weight"] = _conv2d_weight(p["conv1"]["kernel"])
    _bn(sd, f"{prefix}.conv.1", p["bn1"], s["bn1"])
    sd[f"{prefix}.conv.3.weight"] = _conv2d_weight(p["conv2"]["kernel"])
    _bn(sd, f"{prefix}.conv.4", p["bn2"], s["bn2"])
    if "shortcut" in p:
        sd[f"{prefix}.shortcut.weight"] = _conv2d_weight(p["shortcut"]["kernel"])
        sd[f"{prefix}.shortcut.bias"] = _t(p["shortcut"]["bias"])


def _blocks(sd, prefix: str, p: Tree, s: Tree) -> None:
    j = 0
    while f"block_{j}" in p:
        _conv_block(sd, f"{prefix}.{j}", p[f"block_{j}"], s[f"block_{j}"])
        j += 1


def rmvpe_state_dict(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """flax ``E2EModel`` params + batch_stats -> the port's ``E2EModel``
    state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _bn(sd, "unet.encoder.bn", params["in_bn"], batch_stats["in_bn"])
    i = 0
    while f"enc_{i}" in params:
        _blocks(sd, f"unet.encoder.layers.{i}.conv", params[f"enc_{i}"],
                batch_stats[f"enc_{i}"])
        i += 1
    i = 0
    while f"inter_{i}" in params:
        _blocks(sd, f"unet.intermediate.layers.{i}.conv", params[f"inter_{i}"],
                batch_stats[f"inter_{i}"])
        i += 1
    i = 0
    while f"dec_{i}" in params:
        p, s = params[f"dec_{i}"], batch_stats[f"dec_{i}"]
        pre = f"unet.decoder.layers.{i}"
        sd[f"{pre}.conv1.0.weight"] = _t(
            np.transpose(np.asarray(p["up_kernel"]), (2, 3, 0, 1)))  # [in, out, 3, 3]
        _bn(sd, f"{pre}.conv1.1", p["up_bn"], s["up_bn"])
        _blocks(sd, f"{pre}.conv2", p, s)
        i += 1
    sd["cnn.weight"] = _conv2d_weight(params["cnn"]["kernel"])
    sd["cnn.bias"] = _t(params["cnn"]["bias"])
    for k, v in params["bigru"].items():
        sd[f"fc.0.gru.{k}"] = _t(v)
    _dense(sd, "fc.1", params["fc"])
    return sd


def crepe_state_dict(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """flax ``CrepeModel`` params + batch_stats -> torchcrepe's state_dict
    (the layout of the port's ``CrepeModel``)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(1, 7):
        sd[f"conv{i}.weight"] = _conv2d_weight(params[f"conv{i}"]["kernel"])
        sd[f"conv{i}.bias"] = _t(params[f"conv{i}"]["bias"])
        _bn(sd, f"conv{i}_BN", params[f"bn{i}"], batch_stats[f"bn{i}"])
    _dense(sd, "classifier", params["classifier"])
    return sd


def fcpe_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """flax ``CFNaiveMelPE`` params -> torchfcpe's state_dict (the layout
    of the port's ``CFNaiveMelPE``; the output projection as a plain
    weight, FAVOR+'s projection matrix as the attention's buffer)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv1d(sd, "input_stack.0", params["in_conv1"])
    _norm(sd, "input_stack.1", params["in_gn"])
    _conv1d(sd, "input_stack.3", params["in_conv2"])
    i = 0
    while f"layer_{i}" in params:
        p, pre = params[f"layer_{i}"], f"net.encoder_layers.{i}"
        if "attn" in p:
            _norm(sd, f"{pre}.norm", p["norm"])
            sd[f"{pre}.attn.fast_attention.projection_matrix"] = _t(
                p["attn"]["projection_matrix"])
            for name in ("to_q", "to_k", "to_v", "to_out"):
                _dense(sd, f"{pre}.attn.{name}", p["attn"][name])
        c = p["conformer"]
        _norm(sd, f"{pre}.conformer.net.0", c["norm"])
        _conv1d(sd, f"{pre}.conformer.net.2", c["pw1"])
        _conv1d(sd, f"{pre}.conformer.net.4.conv", c["dw"])
        _conv1d(sd, f"{pre}.conformer.net.6", c["pw2"])
        i += 1
    _norm(sd, "norm", params["norm"])
    _dense(sd, "output_proj", params["output_proj"])
    return sd


def load_into(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Strict load that keeps the module's device and dtype."""
    ref = module.state_dict()
    module.load_state_dict(
        {k: v.to(ref[k].device, ref[k].dtype) for k, v in sd.items()
         if k in ref} | {k: v for k, v in sd.items() if k not in ref},
        strict=True)
