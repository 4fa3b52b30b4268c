"""The ``windowed`` kind on the CPU, at two tiny float32 cells added by
files and entries alone (``tests/data/tinycrepe.json`` and ``tiny.json``
under ``tests/data/tinysongs.json``: 3.5-5 s inputs cut every 2 s): a run
with CREPE and one with RMVPE's host predictor are correct, read the new
spans and counters and load no JAX; a salience altered where CREPE produces
it, and the reference's bf16 CREPE in the program's place, come out not
correct; a program whose CREPE keeps another batch-norm epsilon fails
before its set-up."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, tiny_copy

from benchmark import run, spec, windowed

CELLS = ("tinycrepe.tinysongs", "tiny.tinysongs")
NEW = ("f0_net_ms_per_audio_s.long", "f0_decode_ms_per_audio_s.long",
       "cut_points_ms_per_audio_s.long", "windows_per_request.long")


def songs_copy(dest: str) -> str:
    """``tiny_copy`` with the two windowed cells added, each joining the
    lists of the metrics that list the new cells of its configuration."""
    tiny_copy(dest)
    data = os.path.join(BENCH, "tests", "data")
    shutil.copy(os.path.join(data, "tinycrepe.json"), os.path.join(dest, "benchmark", "configs"))
    shutil.copy(os.path.join(data, "tinysongs.json"), os.path.join(dest, "benchmark", "traffic"))
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tinycrepe", "source": "benchmark/tests/data/tinycrepe.json",
                             "file": "benchmark/configs/tinycrepe.json", "reduced": [],
                             "why": "CPU rehearsal"})
    for cell in CELLS:
        bench["workloads"].append({"name": cell, "config": cell.split(".")[0],
                                   "traffic": "tinysongs", "chips": 1, "why": "CPU rehearsal"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        listed = m.get("workloads", [])
        listed += [c for c, real in zip(CELLS, ("crepe48.songs", "nsf48.songs")) if real in listed]
    with open(path, "w") as f:
        json.dump(bench, f)
    return dest


@pytest.fixture(scope="module")
def songs_root(tmp_path_factory):
    return songs_copy(str(tmp_path_factory.mktemp("songs")))


REHEARSE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import run
args = run.parse(["--workload", {cell!r}, "--seed", "3000000123", "--seconds", "1",
                  "--trace", "1"])
out = run.run(args, "cpu", root={songs!r})
print(json.dumps({{"out": out, "forbidden": run.forbidden_modules()}}))
"""


def test_crepe_rehearsal_is_correct_and_loads_no_jax(songs_root):
    code = REHEARSE.format(root=ROOT, cell=CELLS[0], songs=songs_root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    out = got["out"]
    assert got["forbidden"] == []
    assert out["correct"] and out["failed"] == 0 and list(out)[-1] == "checks"
    for name in NEW + ("mfu.long", "synth_ms_per_audio_s.long", "host_dsp_ms_per_audio_s.long"):
        assert out["metrics"][name]["value"] > 0, name
    assert out["metrics"]["windows_per_request.long"]["value"] >= 2
    assert "rmvpe_ms_per_audio_s.long" not in out["metrics"]
    assert "crepe_roofline.long" not in out["metrics"]       # device kernels: a card's
    assert "f0_frames_as_framed=True" in proc.stderr


def test_rmvpe_rehearsal_is_correct(songs_root):
    args = run.parse(["--workload", CELLS[1], "--seed", "3000000124", "--seconds", "1",
                      "--trace", "0"])
    out = run.run(args, "cpu", root=songs_root)
    assert out["correct"], out["checks"]
    cell = spec.load(songs_root, CELLS[1])
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {"long_audio_s_per_s", "setup_s"} <= set(out["metrics"])


def test_an_altered_salience_is_not_correct(songs_root, monkeypatch):
    from rvc_tpu_torch.predictors.crepe import CrepeModel

    forward = CrepeModel.forward
    monkeypatch.setattr(CrepeModel, "forward", lambda self, x: forward(self, x) * 0.99)
    args = run.parse(["--workload", CELLS[0], "--seed", "3000000321", "--seconds", "1",
                      "--trace", "0"])
    out = run.run(args, "cpu", root=songs_root)
    assert not out["correct"]
    assert out["checks"]["salience_vs_bf16"]["value"] > out["checks"]["salience_vs_bf16"]["limit"]


def test_bf16_crepe_is_rejected(songs_root):
    cell = spec.load(songs_root, CELLS[0])
    limits = cell.config["limits"]
    control = windowed.control_gaps(cell, 3000000456, torch.device("cpu"), "bf16", "fp32")
    assert control["gaps"]["salience_vs_bf16"] > limits["salience_vs_bf16"]
    same = windowed.control_gaps(cell, 3000000456, torch.device("cpu"), "fp32", "fp32")
    assert all(same["gaps"][n] <= limits[n] for n in limits), same


def test_another_epsilon_fails_before_set_up(songs_root, monkeypatch):
    from rvc_tpu_torch.predictors import crepe

    monkeypatch.setattr(crepe.CrepeModel.__init__, "__defaults__", ("full", 1e-5))
    cell = spec.load(songs_root, CELLS[0])
    with pytest.raises(RuntimeError, match="epsilon"):
        windowed.build(cell.config, cell.traffic, 1, torch.device("cpu"))
