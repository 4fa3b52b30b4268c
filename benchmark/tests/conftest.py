"""Fixtures of the benchmark's CPU tests: the checkout root on the import
path, and a copy of the benchmark with a tiny float32 cell added by files
and entries alone (``tiny.tinymix``: ``tests/data/tiny.json`` widths, 0.5-1.5
s requests), which the harness runs on the CPU.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = "tiny.tinymix"


def tiny_copy(dest: str) -> str:
    """``dest`` as a checkout root: the benchmark's files, and the tiny
    cell added as a configuration file, a mix file and entries."""
    shutil.copytree(BENCH, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    data = os.path.join(BENCH, "tests", "data")
    shutil.copy(os.path.join(data, "tiny.json"), os.path.join(dest, "benchmark", "configs"))
    shutil.copy(os.path.join(data, "tinymix.json"), os.path.join(dest, "benchmark", "traffic"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "benchmark/tests/data/tiny.json",
                             "file": "benchmark/configs/tiny.json", "reduced": [],
                             "why": "CPU rehearsal"})
    bench["workloads"].append({"name": TINY, "config": "tiny", "traffic": "tinymix",
                               "chips": 1, "why": "CPU rehearsal"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("checkout")))
