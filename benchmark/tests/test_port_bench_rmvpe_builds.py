"""The reader of RMVPE's rebuild counter
(``benchmark/metrics/rmvpe_norm_builds_per_request.py``): a ``--trace 1``
rehearsal of the tiny cell on the CPU reads 0 rebuilds a request, since
set-up built every derived weight; over a made-up log it reads the main
window's mean, and nothing for a program that never counted it."""

from __future__ import annotations

import time
from collections import deque

import pytest
import torch

from conftest import ROOT, TINY

from benchmark import program_spans, serve, spec
from rvc_tpu_torch.utils import profiling

NAMES = ("rmvpe_norm_builds_per_request.clips", "rmvpe_norm_builds_per_request.long")


def test_rehearsal_reads_no_rebuilds(tiny_root, monkeypatch):
    cell = spec.load(tiny_root, TINY)
    cell.root = ROOT
    monkeypatch.setattr(profiling, "_log", deque(maxlen=profiling.LOG_SIZE))
    res = serve.run(cell, 3000000779, 1.0, True, torch.device("cpu"), time.perf_counter())
    out = serve.result(cell, res, True, {"platform": "cpu"})
    assert out["correct"]
    for name in NAMES:
        assert out["metrics"][name]["value"] == 0, name


@pytest.mark.parametrize("counted", [True, False])
def test_reader_over_a_log(counted, monkeypatch):
    main = [{"samples": 16000, "profiled": False, "counters": {"rmvpe_norm_builds": n}}
            for n in (3, 0, 0)]
    traced = [{"samples": 16000, "profiled": True, "counters": {}}]
    totals = {"weight_packs": 1, **({"rmvpe_norm_builds": 3} if counted else {})}
    monkeypatch.setattr(program_spans, "_records", lambda: main + traced)
    monkeypatch.setattr(profiling, "counters", lambda: totals)
    for name in NAMES:
        got = spec.reader(ROOT, name)({"audio_s": 3.0})
        assert got == (1.0 if counted else None)
