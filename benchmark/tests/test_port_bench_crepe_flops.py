"""``benchmark/work/crepe_flops.py`` against a hand count of CREPE full's
six blocks and classifier, against PyTorch's own count of the reference's
products at tiny widths, and its bound against the TF32 peak."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH

from benchmark.reference import crepe as ref
from benchmark.work import crepe_flops

with open(os.path.join(BENCH, "configs", "crepe48.json")) as f:
    FULL = json.load(f)["f0"]
with open(os.path.join(BENCH, "tests", "data", "tinycrepe.json")) as f:
    TINY = json.load(f)["f0"]


def test_full_by_hand():
    # (output length, C_in, C_out, K): conv1 at stride 4 gives 256 outputs,
    # each 2x pool halves the length for the next block
    macs = (256 * 1 * 1024 * 512 + 128 * 1024 * 128 * 64 + 64 * 128 * 128 * 64
            + 32 * 128 * 128 * 64 + 16 * 128 * 256 * 64 + 8 * 256 * 512 * 64 + 2048 * 360)
    assert crepe_flops.frame_flops(FULL) == 2 * macs
    assert round(2 * macs / 1e9, 2) == 2.82                 # 282 GFLOP an input second
    assert round(crepe_flops.parameters(FULL) / 1e6, 2) == 22.24
    f, nbytes = crepe_flops.salience(512, FULL)
    assert f == 512 * 2 * macs
    assert nbytes == 4 * (512 * 1024 + crepe_flops.parameters(FULL) + 512 * 360)
    assert crepe_flops.bound_s(512, FULL) == pytest.approx(f / 495e12)   # bound by operations


def test_tiny_against_pytorchs_count():
    from benchmark import weights
    from rvc_tpu_torch.predictors.crepe import CrepeModel

    sd = weights.seeded_state(weights.float_shapes(CrepeModel("tiny")), 1, "crepe", "cpu")
    frames = torch.randn(6, 1024)
    with FlopCounterMode(display=False) as counter:
        ref.salience(sd, frames, TINY)
    assert counter.get_total_flops() == 6 * crepe_flops.frame_flops(TINY)
