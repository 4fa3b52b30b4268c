"""``benchmark/work`` against hand sums and against PyTorch's own count of
the reference's products: a stage-tail conv, one HuBERT layer, k-NN, and
the bounds and readers built on them."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import hubert as ref_hubert
from benchmark.work import flops


def test_stage_tail_one_conv_pair():
    # one chain of one dilation: a conv of dilation d and a conv of
    # dilation 1, both C x C x K, over B x T
    b, c, t, k = 2, 32, 1000, 7
    f, nbytes = flops.stage_tail(b, c, t, [k], [3], act_bytes=2, weight_bytes=2)
    assert f == 2 * (2 * b * t * c * c * k)
    assert nbytes == 2 * b * c * t * 2 + 2 * (c * c * k + c) * 2
    # three chains (k = 3, 7, 11) over dilations 1, 3, 5
    f3, _ = flops.stage_tail(1, c, t, [3, 7, 11], [1, 3, 5], 2, 2)
    assert f3 == sum(3 * 2 * (2 * t * c * c * k) for k in (3, 7, 11))


def test_knn_and_bound():
    f, nbytes = flops.knn(100, 65536, 768, 8)
    assert f == 2 * 100 * 65536 * 768
    assert nbytes == 4 * (100 + 65536) * 768 + 12 * 100 * 8
    assert flops.bound_s(f, nbytes, "tf32") == pytest.approx(
        max(f / 495e12, nbytes / 3.35e12))


def _hubert_arch(layers):
    return dict(hidden_size=32, num_layers=layers, num_heads=4, intermediate_size=64,
                conv_dim=[16] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4, layer_norm_eps=1e-5)


def test_hubert_layer_hand_sum():
    samples = 16000
    n = samples
    for k, s in zip([10, 3, 3, 3, 3, 2, 2], [5, 2, 2, 2, 2, 2, 2]):
        n = (n - k) // s + 1
    h, f = 32, 64
    one = flops.hubert(samples, _hubert_arch(1)) - flops.hubert(samples, _hubert_arch(0))
    assert one == 4 * 2 * n * h * h + 2 * 2 * n * n * h + 2 * 2 * n * h * f


def test_hubert_layer_against_torch_count():
    """The reference's attention and feed-forward of one layer, counted by
    PyTorch's flop counter, equal the formula's layer."""
    torch.manual_seed(0)
    h, f, n, heads = 32, 64, 49, 4
    sd = {}
    p = "encoder.layers.0"
    for name, shape in (("attention.q_proj", (h, h)), ("attention.k_proj", (h, h)),
                        ("attention.v_proj", (h, h)), ("attention.out_proj", (h, h)),
                        ("feed_forward.intermediate_dense", (f, h)),
                        ("feed_forward.output_dense", (h, f))):
        sd[f"{p}.{name}.weight"] = torch.randn(shape)
        sd[f"{p}.{name}.bias"] = torch.zeros(shape[0])
    x = torch.randn(1, n, h)
    with FlopCounterMode(display=False) as counter:
        ref_hubert._attention(sd, f"{p}.attention", x, heads)
        ref_hubert.linear(ref_hubert.linear(x, sd[f"{p}.feed_forward.intermediate_dense.weight"]),
                          sd[f"{p}.feed_forward.output_dense.weight"])
    counted = counter.get_total_flops()
    assert counted == 4 * 2 * n * h * h + 2 * 2 * n * n * h + 2 * 2 * n * h * f


def test_conversion_grows_with_length():
    import json
    import os

    from conftest import ROOT
    with open(os.path.join(ROOT, "benchmark", "configs", "nsf48.json")) as fh:
        cfg = json.load(fh)
    short, long = flops.conversion(16000 * 2, cfg), flops.conversion(16000 * 12, cfg)
    assert 0 < short < long
    # about 150 GFLOP an input second at full width, most of it the decoder
    per_s = (flops.conversion(16000 * 60, cfg) - flops.conversion(16000 * 30, cfg)) / 30
    assert 5e10 < per_s < 5e11
