"""What a ``torch.profiler`` chrome trace of a window says: device busy
time (the union of kernel, copy and set intervals), kernels launched, the
device time of the kernels that each benchmark range launched (a kernel is
tied to its launch by the trace's correlation id), the device operations
that took most time, and the idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union_length(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """The idle stretches of [lo, hi) between the intervals' union."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _host_at(events, times):
    """For each time (ascending), the innermost host event open at it on
    one thread: events are (ts, end, name), properly nested."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    stack, j, out = [], 0, []
    for t in times:
        while j < len(events) and events[j][0] <= t:
            while stack and stack[-1][1] <= events[j][0]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "python")
    return out


def summarize(path: str, window_range: str, scopes: List[str]) -> dict:
    """Read a chrome trace; ``window_range`` names the user range of the
    window, ``scopes`` the user ranges whose kernels are summed apart."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = next(e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == window_range)
    lo, hi, tid = window["ts"], window["ts"] + window["dur"], window["tid"]
    device, launches, ranges, host = [], {}, defaultdict(list), []
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS and "dur" in e:
            device.append(e)
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e["ts"]
        elif cat == "user_annotation" and e.get("name") in scopes:
            ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        if cat in ("user_annotation", "cpu_op") and e.get("tid") == tid and "dur" in e:
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    device = [e for e in device if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    by_name = defaultdict(float)
    for e in device:
        by_name[e["name"]] += e["dur"]
    scoped = {}
    for name, rs in ranges.items():
        rs.sort()
        starts = [r[0] for r in rs]
        total = 0.0
        for e in device:
            t = launches.get(e.get("args", {}).get("correlation"))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= rs[i][1]:
                total += e["dur"]
        scoped[name] = total * 1e-6
    idle = gaps(intervals, lo, hi)
    starts = [s for s, _ in idle]
    inner = _host_at([h for h in host if h[2] != window_range], starts)
    stage = _host_at([h for h in host if h[2].startswith("bench.")
                      and h[2] != window_range], starts)
    gap_by = defaultdict(float)
    for (s, e), a, b in zip(idle, stage, inner):
        gap_by[a if a == b else f"{a} > {b}"] += e - s
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": union_length(intervals, lo, hi) * 1e-6,
        "kernels": sum(1 for e in device if e.get("cat") == "kernel"),
        "scoped_device_s": scoped,
        "device_ops": sorted(([n[:120], v * 1e-6] for n, v in by_name.items()),
                             key=lambda r: -r[1])[:10],
        "idle_gaps": sorted(([n[:120], v * 1e-6] for n, v in gap_by.items()),
                            key=lambda r: -r[1])[:10],
    }
