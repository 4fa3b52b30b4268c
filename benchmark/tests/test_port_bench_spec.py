"""``BENCHMARK.json`` and the files it names: each cell resolves to its
configuration, mix and readers; the file keeps the benchmark contract's
shape; and a cell, configuration, mix or metric added as new files and
entries is found with no existing file edited."""

from __future__ import annotations

import hashlib
import json
import os
import re

from conftest import ROOT, TINY, tiny_copy

from benchmark import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.load(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["lengths"]["set_size"] > 0
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert callable(spec.reader(ROOT, m["name"]))


def test_contract_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    assert bench["command"][1].startswith("benchmark/")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert c["reduced"] == []
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        cells.add(w["name"])
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"]: m["bound"] for m in bench["end_to_end"]}["setup_s"] == 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_added_files_are_found(tmp_path):
    root = tiny_copy(str(tmp_path))
    before = _digests(root)
    metric = os.path.join(root, "benchmark", "metrics", "requests_per_s.serve.py")
    with open(metric, "w") as f:
        f.write('def read(ctx):\n    return ctx["requests"] / ctx["window_s"]\n')
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "requests_per_s.serve", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "host orchestration (infer/pipeline.py)",
                               "moves": "serve_latency_p95_ms", "workloads": [TINY]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.load(root, TINY)
    assert cell.config["name"] == "tiny" and cell.traffic["lengths"]["max_s"] == 1.5
    assert "requests_per_s.serve" in [m["name"] for m in cell.per_layer]
    got = spec.read_metrics(root, cell.per_layer, {"requests": 30, "window_s": 2.0,
                                                   "trace": {"busy_s": 0, "window_s": 0,
                                                             "kernels": 0, "scoped_device_s": {}},
                                                   "trace_audio_s": 0, "trace_model_flops": 0,
                                                   "bound_s": {},
                                                   "spans_s": {}, "audio_s": 0,
                                                   "model_flops": 0, "peak_flops": 1})
    assert got["requests_per_s.serve"]["value"] == 15.0
    # readers with nothing to read leave their metric out
    assert "idle_share.clips" not in got
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


KIND = """
def run(cell, seed, seconds, trace, device, t0):
    return {"seed": seed, "steps": cell.traffic["steps"]}


def result(cell, res, trace, device_info):
    return {"correct": True, "attempted": res["steps"], "failed": 0,
            "metrics": {m["name"]: {"value": float(res["seed"]), "unit": m["unit"]}
                        for m in cell.end_to_end},
            "device": device_info, "checks": {}}
"""


def test_added_kind_is_found(tmp_path):
    """Another kind of run than serving (a training step, say) arrives as a
    module ``benchmark/<kind>.py``, a mix that names it, a metric and a cell:
    ``run.py`` drives it with no existing file edited."""
    root = tiny_copy(str(tmp_path))
    before = _digests(root)
    with open(os.path.join(root, "benchmark", "steps.py"), "w") as f:
        f.write(KIND)
    with open(os.path.join(root, "benchmark", "traffic", "fixed.json"), "w") as f:
        json.dump({"kind": "steps", "steps": 3}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.fixed", "config": "tiny", "traffic": "fixed",
                               "chips": 1, "why": "another kind of run"})
    bench["end_to_end"].append({"name": "step_ms", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny.fixed"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    args = run.parse(["--workload", "tiny.fixed", "--seed", "7", "--seconds", "1"])
    out = run.run(args, "cpu", root=root)
    assert out["attempted"] == 3
    assert out["metrics"] == {"step_ms": {"value": 7.0, "unit": "ms"},
                              "setup_s": {"value": 7.0, "unit": "s"}}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
