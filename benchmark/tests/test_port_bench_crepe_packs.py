"""The reader of CREPE's pack counter
(``benchmark/metrics/crepe_packs_per_request.py``): over a made-up log it
reads the main window's mean rebuilds a request, and nothing for a process
that never counted it (the CPU's plain blocks pack nothing)."""

from __future__ import annotations

import pytest

from conftest import ROOT

from benchmark import program_spans, spec
from rvc_tpu_torch.utils import profiling


@pytest.mark.parametrize("counted", [True, False])
def test_reader_over_a_log(counted, monkeypatch):
    main = [{"samples": 16000, "profiled": False, "counters": {"crepe_packs": n}}
            for n in (2, 0, 0, 0)]
    traced = [{"samples": 16000, "profiled": True, "counters": {}}]
    totals = {"weight_packs": 1, **({"crepe_packs": 2} if counted else {})}
    monkeypatch.setattr(program_spans, "_records", lambda: main + traced)
    monkeypatch.setattr(profiling, "counters", lambda: totals)
    got = spec.reader(ROOT, "crepe_packs_per_request.long")({"audio_s": 4.0})
    assert got == (0.5 if counted else None)
