"""The program's own spans and counters (``rvc_tpu_torch/utils/profiling.py``)
over the main serving window, for the per-layer readers.

The program logs one record a request (``profiling.requests()``, oldest
first) and the harness does not tell it where the main window starts, so
the window is found from the log: the records before the first one that
ran under the profiler (the traced window's first), walked back until their
input samples sum to the main window's exactly (``ctx["audio_s"]`` x 16 000;
a request's seconds are its samples / 16 000). Where no record ran under the
profiler, or no run of records sums to it (a log too short for the window,
a program without the recorder), there is no window and the metric is left
out."""

from __future__ import annotations

from typing import List, Optional

SAMPLE_RATE = 16000


def _records() -> List[dict]:
    from rvc_tpu_torch.utils import profiling

    requests = getattr(profiling, "requests", None)     # a program without the recorder
    return requests() if requests is not None else []


def main_window(ctx: dict, records: Optional[List[dict]] = None) -> Optional[List[dict]]:
    """The main window's request records, in order, or None."""
    records = _records() if records is None else records
    first = next((i for i, r in enumerate(records) if r["profiled"]), None)
    want = round(ctx["audio_s"] * SAMPLE_RATE)
    if first is None or want <= 0:
        return None
    total = 0
    for i in range(first - 1, -1, -1):
        total += records[i]["samples"]
        if total == want:
            return records[i:first]
        if total > want:
            return None
    return None


def _self_ns(spans: List[dict], i: int) -> int:
    """A span's time less that of the spans opened inside it on its thread."""
    inner = sum(s["dur_ns"] for s in spans
                if s["parent"] == i and s["thread"] == spans[i]["thread"])
    return spans[i]["dur_ns"] - inner


def ms_per_audio_s(ctx: dict, names, self_time: bool = False) -> Optional[float]:
    """Host milliseconds of the spans ``names`` (their self time with
    ``self_time``) over the main window's requests, per input second."""
    window = main_window(ctx)
    if not window:
        return None
    total, found = 0, False
    for r in window:
        spans = r["spans"]
        for i, s in enumerate(spans):
            if s["name"] in names:
                found = True
                total += _self_ns(spans, i) if self_time else s["dur_ns"]
    seconds = sum(r["samples"] for r in window) / SAMPLE_RATE
    return total / 1e6 / seconds if found else None


def per_request(ctx: dict, counter: str) -> Optional[float]:
    """The counter ``counter`` summed over the main window's requests, per
    request (0 where it never counted)."""
    window = main_window(ctx)
    if not window:
        return None
    return sum(r["counters"].get(counter, 0) for r in window) / len(window)
