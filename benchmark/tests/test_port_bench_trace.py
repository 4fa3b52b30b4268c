"""The trace reader on a synthetic chrome trace: overlapping kernels count
once toward busy time, idle gaps are labelled by what the host was doing,
and a kernel belongs to the benchmark range whose launch it followed."""

from __future__ import annotations

import json

import pytest

from benchmark import spec, trace
from conftest import ROOT


def _trace(path):
    ev = [
        {"cat": "user_annotation", "name": "bench.window", "ts": 0.0, "dur": 100.0, "tid": 1},
        {"cat": "user_annotation", "name": "bench.stage_tails", "ts": 10.0, "dur": 5.0, "tid": 1},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 60.0, "dur": 30.0, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 11.0, "dur": 1.0, "tid": 1,
         "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20.0, "dur": 1.0, "tid": 1,
         "args": {"correlation": 8}},
        # two kernels that overlap (20-40 and 30-50) and one apart (70-80)
        {"cat": "kernel", "name": "k_tail", "ts": 20.0, "dur": 20.0, "args": {"correlation": 7}},
        {"cat": "kernel", "name": "k_other", "ts": 30.0, "dur": 20.0, "args": {"correlation": 8}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70.0, "dur": 10.0, "args": {}},
        {"cat": "kernel", "name": "outside", "ts": 150.0, "dur": 10.0, "args": {}},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_union_and_gaps():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert trace.gaps([(1, 3), (2, 4), (6, 7)], 0, 10) == [(0, 1), (4, 6), (7, 10)]


def test_summary_of_overlapping_kernels(tmp_path):
    path = str(tmp_path / "t.json")
    _trace(path)
    s = trace.summarize(path, "bench.window", ["bench.stage_tails"])
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)            # 20-50 and 70-80
    assert s["kernels"] == 2
    assert s["scoped_device_s"]["bench.stage_tails"] == pytest.approx(20e-6)
    # a gap is labelled by what the host was in when it began: 0-20 and
    # 50-70 in no range or op, 80-100 in the copy
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({"python": 40e-6, "python > aten::copy_": 20e-6})
    # a main window at the profiled window's pace reads the trace's own
    # idle share; one that did twice the operations in the same time (the
    # profiler's host cost slowed the traced one) reads the device's busy
    # time per operation at the main window's pace
    ctx = {"trace": s, "trace_audio_s": 2.0, "trace_model_flops": 4.0,
           "model_flops": 4.0, "window_s": 100e-6}
    assert spec.reader(ROOT, "idle_share.clips")(ctx) == pytest.approx(60.0)
    ctx["model_flops"] = 8.0
    assert spec.reader(ROOT, "idle_share.long")(ctx) == pytest.approx(20.0)
    assert spec.reader(ROOT, "kernels_per_audio_s.clips")(ctx) == 1.0
