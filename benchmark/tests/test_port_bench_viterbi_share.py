"""The reader of kernel V's decoded share
(``benchmark/metrics/viterbi_device_share.py``): over a made-up log it reads
the main window's V frames over its f0 frames in %, and nothing for a
process that never counted V (the CPU's host decode, a program without V)
or a window without f0 frames."""

from __future__ import annotations

import pytest

from conftest import ROOT

from benchmark import program_spans, spec
from rvc_tpu_torch.utils import profiling


@pytest.mark.parametrize("counted, v_frames, want", [
    (True, (1001, 2003, 0, 1001), 100.0 * 4005 / 5006),
    (True, (1001, 2003, 1001, 1001), 100.0),
    (False, (0, 0, 0, 0), None)])
def test_reader_over_a_log(counted, v_frames, want, monkeypatch):
    f0 = (1001, 2003, 1001, 1001)
    main = [{"samples": 16000, "profiled": False,
             "counters": {"f0_frames": n, **({"viterbi_device_frames": v} if v else {})}}
            for n, v in zip(f0, v_frames)]
    traced = [{"samples": 16000, "profiled": True,
               "counters": {"f0_frames": 5, "viterbi_device_frames": 5}}]
    totals = {"f0_frames": 5011, **({"viterbi_device_frames": 4010} if counted else {})}
    monkeypatch.setattr(program_spans, "_records", lambda: main + traced)
    monkeypatch.setattr(profiling, "counters", lambda: totals)
    got = spec.reader(ROOT, "viterbi_device_share.long")({"audio_s": 4.0})
    assert got == pytest.approx(want) if want is not None else got is None


def test_no_f0_frames_reads_nothing(monkeypatch):
    main = [{"samples": 16000, "profiled": False, "counters": {}} for _ in range(4)]
    traced = [{"samples": 16000, "profiled": True, "counters": {}}]
    monkeypatch.setattr(program_spans, "_records", lambda: main + traced)
    monkeypatch.setattr(profiling, "counters", lambda: {"viterbi_device_frames": 3})
    assert spec.reader(ROOT, "viterbi_device_share.long")({"audio_s": 4.0}) is None
