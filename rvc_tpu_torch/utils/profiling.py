"""Tracing and profiling (port of ``rvc_tpu/utils/profiling.py``):
``torch.profiler`` device traces written as Chrome traces, named regions
that show in them, an aggregating wall-clock stage timer, and the memory
each card holds.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Trace the host and, where there is one, the card into
    ``log_dir/trace.json`` (Chrome trace format, for Perfetto or
    chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in device traces (``record_function``)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


class StageTimer:
    """Aggregating wall-clock timer for pipeline stages."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(self.totals[k], 4), "count": self.counts[k],
                "mean_ms": round(1000 * self.totals[k] / max(self.counts[k], 1), 3)}
            for k in sorted(self.totals)}

    def dump(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.summary(), indent=2)
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w") as f:
                f.write(text)
        return text


def memory_stats() -> Dict[str, int]:
    """Bytes allocated by torch on each card now (none without a card)."""
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get(
        "allocated_bytes.all.current", 0)) for i in range(torch.cuda.device_count())}
