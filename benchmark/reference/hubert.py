"""HuBERT / ContentVec content features, plain PyTorch over a state_dict.

The published HuBERT-base encoder: seven strided convs (group norm on the
first, GELU), a layer norm and a projection to 768, a weight-normalised
grouped conv positional embedding (kernel 128, 16 groups, the trailing
sample dropped), then twelve post-LN transformer layers of full softmax
attention and a GELU feed-forward. Keys are ``transformers.HubertModel``'s,
the positional conv's weight norm stored per output channel."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import conv1d, gelu, layer_norm, linear, mm, q, weight_norm


def features(sd, audio: torch.Tensor, arch: dict) -> torch.Tensor:
    """audio [B, T] 16 kHz -> [B, frames, hidden] float32."""
    eps = arch["layer_norm_eps"]
    x = audio.float()[:, None, :]
    for i, stride in enumerate(arch["conv_stride"]):
        p = f"feature_extractor.conv_layers.{i}"
        x = conv1d(x, sd[f"{p}.conv.weight"], stride=stride)
        if i == 0:
            x = q(F.group_norm(x, x.shape[1], sd[f"{p}.layer_norm.weight"].float(),
                               sd[f"{p}.layer_norm.bias"].float(), eps))
        x = gelu(x)
    x = x.transpose(1, 2)
    x = layer_norm(x, sd["feature_projection.layer_norm.weight"],
                   sd["feature_projection.layer_norm.bias"], eps)
    x = linear(x, sd["feature_projection.projection.weight"],
               sd["feature_projection.projection.bias"])

    p = "encoder.pos_conv_embed.conv"
    k, groups = arch["num_conv_pos_embeddings"], arch["num_conv_pos_embedding_groups"]
    w = weight_norm(sd[f"{p}.weight_v"], sd[f"{p}.weight_g"])
    pos = conv1d(x.transpose(1, 2), w, sd[f"{p}.bias"], padding=k // 2,
                 groups=groups)
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = layer_norm(x + gelu(pos).transpose(1, 2), sd["encoder.layer_norm.weight"],
                   sd["encoder.layer_norm.bias"], eps)
    heads = arch["num_heads"]
    for i in range(arch["num_layers"]):
        p = f"encoder.layers.{i}"
        x = layer_norm(x + _attention(sd, f"{p}.attention", x, heads),
                       sd[f"{p}.layer_norm.weight"], sd[f"{p}.layer_norm.bias"], eps)
        h = gelu(linear(x, sd[f"{p}.feed_forward.intermediate_dense.weight"],
                        sd[f"{p}.feed_forward.intermediate_dense.bias"]))
        h = linear(h, sd[f"{p}.feed_forward.output_dense.weight"],
                   sd[f"{p}.feed_forward.output_dense.bias"])
        x = layer_norm(x + h, sd[f"{p}.final_layer_norm.weight"],
                       sd[f"{p}.final_layer_norm.bias"], eps)
    return x


def _attention(sd, p, x, heads):
    b, t, c = x.shape
    d = c // heads

    def proj(name):
        y = linear(x, sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"])
        return y.reshape(b, t, heads, d).transpose(1, 2)

    qh, kh, vh = proj("q_proj") * d ** -0.5, proj("k_proj"), proj("v_proj")
    attn = q(torch.softmax(mm(qh, kh.transpose(-1, -2)), dim=-1))
    out = mm(attn, vh).transpose(1, 2).reshape(b, t, c)
    return linear(out, sd[f"{p}.out_proj.weight"], sd[f"{p}.out_proj.bias"])
