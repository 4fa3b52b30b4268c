"""The readers of the program's own spans and counters
(``benchmark/program_spans.py``): a ``--trace 1`` rehearsal of the tiny
cell on the CPU reads all twelve, from exactly the main window's requests;
the main-window rule returns None where the log cannot hold the window and
where no request ran under the profiler."""

from __future__ import annotations

import time
from collections import deque

import pytest
import torch

from conftest import ROOT, TINY

from benchmark import program_spans, serve, spec
from rvc_tpu_torch.utils import profiling

QUANTITIES = ("host_dsp_ms_per_audio_s", "upload_ms_per_audio_s", "dispatch_ms_per_audio_s",
              "download_ms_per_audio_s", "pinned_allocs_per_request",
              "weight_packs_per_request")
NEW = [f"{q}.{group}" for q in QUANTITIES for group in ("clips", "long")]


def test_rehearsal_reads_the_main_window(tiny_root, monkeypatch):
    cell = spec.load(tiny_root, TINY)
    cell.root = ROOT        # this checkout's serve.py, whose window is watched
    assert spec.kind(cell) is serve
    windows = []
    serve_window = serve._serve

    def watched(*args, **kwargs):
        windows.append(serve_window(*args, **kwargs))
        return windows[-1]

    monkeypatch.setattr(serve, "_serve", watched)
    # the log of this run alone, as in a benchmark's process
    monkeypatch.setattr(profiling, "_log", deque(maxlen=profiling.LOG_SIZE))
    res = serve.run(cell, 3000000777, 1.0, True, torch.device("cpu"), time.perf_counter())
    out = serve.result(cell, res, True, {"platform": "cpu"})
    assert out["correct"]
    main, traced = windows
    window = program_spans.main_window({"audio_s": sum(main["audio_s"])})
    assert [r["samples"] for r in window] == main["samples"]
    assert not any(r["profiled"] for r in window)
    after = program_spans._records()[-len(traced["samples"]):]
    assert [r["samples"] for r in after] == traced["samples"]
    assert all(r["profiled"] for r in after)
    got = out["metrics"]
    for name in NEW:
        assert name in got, name
        if "_ms_" in name:
            assert got[name]["value"] > 0
    # the CPU path page-locks nothing, and set-up packed every weight
    assert got["pinned_allocs_per_request.clips"]["value"] == 0
    assert got["weight_packs_per_request.long"]["value"] == 0


def _rec(samples, profiled=False):
    return {"samples": samples, "profiled": profiled}


@pytest.mark.parametrize("case", ["whole", "cut", "unprofiled", "no_window"])
def test_main_window_rule(case):
    warm = [_rec(80000), _rec(96000)]
    main = [_rec(n) for n in (32000, 48000, 40000)]
    traced = [_rec(n, True) for n in (48000, 32000)]
    records = {"whole": warm + main + traced, "cut": main[1:] + traced,
               "unprofiled": warm + main, "no_window": warm + main + traced}[case]
    audio_s = 0 if case == "no_window" else sum(r["samples"] for r in main) / 16000
    got = program_spans.main_window({"audio_s": audio_s}, records)
    assert got == (main if case == "whole" else None)
