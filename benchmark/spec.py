"""``BENCHMARK.json`` resolved: a workload's configuration file, traffic file
and metrics, and each per-layer metric's reader, all found by name.

A workload reads its configuration's file (the one ``BENCHMARK.json``
names) and ``benchmark/traffic/<traffic>.json``; the mix's ``kind`` names
the module ``benchmark/<kind>.py`` whose ``run`` and ``result`` drive the
cell (``serve``: a closed-loop client of the pipeline). A per-layer metric
``<name>`` is read by ``benchmark/metrics/<name>.py``'s ``read(ctx)``, or,
where a quantity is split by the end-to-end metric it moves
(``<quantity>.<group>``) and the group has no file of its own, by
``benchmark/metrics/<quantity>.py``'s. Adding a cell, a configuration, a
mix, a kind of run or a metric is adding files and entries."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

BENCH = "benchmark"


@dataclass
class Cell:
    root: str
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """A metric with ``workloads`` is that list's; an end-to-end metric
    without one is every cell's; a per-layer metric without one is every
    cell's that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; one of {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, BENCH, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, [])]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    return Cell(root, workload, int(w["chips"]), config, traffic, e2e, layer)


def _load(name: str, path: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(cell: Cell) -> ModuleType:
    """``benchmark/<kind>.py`` of ``cell``'s root, for its mix's ``kind``:
    the module whose ``run(cell, seed, seconds, trace, device, t0)`` makes a
    run and whose ``result(cell, res, trace, device_info)`` its line. The
    checkout's own module where it is the one imported."""
    name = f"{BENCH}.{cell.traffic['kind']}"
    path = os.path.join(cell.root, BENCH, f"{cell.traffic['kind']}.py")
    mod = sys.modules.get(name)
    if mod is not None and os.path.samefile(mod.__file__, path):
        return mod
    return _load(name, path)


def reader(root: str, metric: str) -> Callable[[dict], Optional[float]]:
    """``benchmark/metrics/<metric>.py``'s ``read``, else, for
    ``<quantity>.<group>``, ``benchmark/metrics/<quantity>.py``'s."""
    base = os.path.join(root, BENCH, "metrics")
    path = os.path.join(base, f"{metric}.py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(base, f"{metric.rsplit('.', 1)[0]}.py")
    return _load(f"bench_metric_{metric.replace('.', '_')}", path).read


def read_metrics(root: str, metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    """Each metric its reader finds something for: {name: {value, unit}}."""
    out = {}
    for m in metrics:
        value = reader(root, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
