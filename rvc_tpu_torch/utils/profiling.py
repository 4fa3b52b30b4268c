"""The program's one recorder: spans and counters of each request, and
device traces that carry them (port of ``rvc_tpu/utils/profiling.py``).

``request(samples)`` opens a request's root span ``rvc.request``; inside
it, ``span(name)`` records host time (``time.perf_counter_ns``) with its
parent span, and ``count(name)`` adds to the request's counters and the
process's totals. Each request is anchored to the wall clock
(``time.time_ns``, read with ``perf_counter_ns``), which is the time base of
``torch.profiler``'s Chrome trace: an event there lies at ``ts +
baseTimeNanoseconds / 1000`` µs. Finished requests stay in a log of the
last ``LOG_SIZE`` (``requests()``), in memory; nothing is written while
they run.

Only in a request that starts while a profiler runs does a span also
open a ``record_function`` range of its name (with no profiler a range
costs ~12 µs, the check ~0.1 µs); ``annotate(name)`` is such a range
alone, opened while a profiler runs, for sites inside the ops
(``annotated(name)`` wraps a function's calls in one). A range's
name never carries a request id. ``device_trace`` writes a Chrome trace
with the requests that ran inside it on a track of their own.

The current request is one per thread, the thread that drives it, so
that conversions on several threads (the web UI's) record apart; a span
on another thread (the stream's drain thread) names its request by
handle: ``span(name, req)``. Every span closes in the request it opened
in.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd.profiler import record_function

LOG_SIZE = 4096
REQUEST = "rvc.request"
TRACK_PID = 1 << 30   # the requests' track in an exported trace
TRACK_CAT = "rvc_span"

_profiling = torch.autograd._profiler_enabled
_now = time.perf_counter_ns
_thread = threading.get_ident
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_log: deque = deque(maxlen=LOG_SIZE)
_totals: Dict[str, int] = {}


class _Local(threading.local):
    req: Optional["Request"] = None     # the thread's current request


_local = _Local()


def annotate(name: str):
    """A ``record_function`` range of ``name`` while a profiler runs, else
    nothing."""
    return record_function(name) if _profiling() else _NULL


def annotated(name: str):
    """A decorator: the function's calls run in ``annotate(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def _range(name: str):
    """An open ``record_function`` range of ``name``."""
    rng = record_function(name)
    rng.__enter__()
    return rng


def _close_range(rec: list) -> None:
    rec[5].__exit__(None, None, None)
    rec[5] = None


class Request:
    """One request's record: its spans (the root ``rvc.request`` first),
    counters, input length in 16 kHz samples, bucket (the padded length the
    device ran, set by the pipeline), and whether a profiler ran at its
    start. A context manager (``start`` ... ``end``); ``start`` makes it the
    current request of its thread, ``end`` logs it and, on that thread,
    gives the current back."""

    __slots__ = ("id", "samples", "bucket", "profiled", "failed", "counters", "ended",
                 "_wall", "_perf", "_owner", "_spans", "_top", "_prev", "_dict")

    def __init__(self, samples: int):
        self.id, self.samples, self.bucket = next(_ids), int(samples), None
        self.profiled = self.failed = self.ended = False
        self.counters: Dict[str, int] = {}
        self._spans: List[list] = []
        self._prev = self._dict = None

    def start(self) -> "Request":
        self.profiled = _profiling()
        rng = _range(REQUEST) if self.profiled else None
        self._owner = _thread()
        self._wall, self._perf = time.time_ns(), _now()
        # a span: name, parent, start, end, thread (0: the request's own,
        # 1: another), its open range
        root = [REQUEST, None, self._perf, 0, 0, rng]
        self._spans.append(root)
        self._top = root    # the innermost open span on the request's own thread
        self._prev, _local.req = _local.req, self
        return self

    def end(self, failed: bool = False) -> None:
        if self.ended:
            return
        root = self._spans[0]
        root[3] = _now()
        if root[5] is not None:
            _close_range(root)
        self.ended, self.failed = True, failed
        if _local.req is self:
            prev = self._prev
            while prev is not None and prev.ended:
                prev = prev._prev
            _local.req = prev
        _log.append(self)

    __enter__ = start

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end(failed=exc_type is not None)

    def as_dict(self) -> dict:
        """The record: ``spans`` in opening order, each with its ``parent``
        (an index into ``spans``; the root's is None), ``start_ns`` on the
        trace's time base (``time.time_ns``), ``dur_ns``, and ``thread``
        (0: the request's own, 1: another)."""
        if self._dict is None:
            at = {id(s): i for i, s in enumerate(self._spans)}
            shift = self._wall - self._perf
            spans = [{"name": s[0], "parent": None if s[1] is None else at[id(s[1])],
                      "start_ns": s[2] + shift, "dur_ns": max(s[3] - s[2], 0),
                      "thread": s[4]} for s in self._spans]
            self._dict = {"id": self.id, "samples": self.samples, "bucket": self.bucket,
                          "profiled": self.profiled, "failed": self.failed,
                          "start_ns": spans[0]["start_ns"], "dur_ns": spans[0]["dur_ns"],
                          "spans": spans, "counters": dict(self.counters)}
        return self._dict


def request(samples: int) -> Request:
    """A new request of ``samples`` 16 kHz input samples, to use as a
    context manager (or ``start`` / ``end``)."""
    return Request(samples)


def current() -> Optional[Request]:
    """This thread's current request, or None outside one."""
    return _local.req


class _Span:
    """A span of ``req``, which it opens and closes in: on the request's
    own thread it nests in the innermost open span; on another (the
    stream's drain thread) it hangs from the request's root."""

    __slots__ = ("name", "req", "rec")

    def __init__(self, name: str, req: Request):
        self.name, self.req = name, req

    def __enter__(self) -> None:
        req = self.req
        own = _thread() == req._owner
        self.rec = rec = [self.name, req._top if own else req._spans[0], _now(), 0,
                          0 if own else 1, _range(self.name) if req.profiled else None]
        if own:
            req._top = rec
        req._spans.append(rec)

    def __exit__(self, exc_type, exc, tb) -> None:
        rec = self.rec
        rec[3] = _now()
        if not rec[4]:
            self.req._top = rec[1]
        if rec[5] is not None:
            _close_range(rec)


def span(name: str, req: Optional[Request] = None):
    """A span of ``name`` in ``req``, by default this thread's current
    request, to use in a ``with``; outside a running request it is the
    profiler's range alone (``annotate``)."""
    if req is None:
        req = _local.req
    return annotate(name) if req is None or req.ended else _Span(name, req)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of this thread's current request
    and to the process's total."""
    _totals[name] = _totals.get(name, 0) + n
    req = _local.req
    if req is not None and not req.ended:
        req.counters[name] = req.counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """The process's counter totals."""
    return dict(_totals)


def requests() -> List[dict]:
    """The finished requests' records (``Request.as_dict``), oldest first:
    the last ``LOG_SIZE``."""
    return [r.as_dict() for r in list(_log)]


def _trace_events(records: List[dict], base_ns: int) -> List[dict]:
    """Chrome-trace events of ``records`` on the requests' track: one
    complete event a span, ``ts`` in µs from ``base_ns``, a row a request
    (and one for its spans on another thread)."""
    events = [{"ph": "M", "name": "process_name", "pid": TRACK_PID, "tid": 0,
               "args": {"name": "rvc requests"}}]
    for r in records:
        args = {"request": r["id"], "samples": r["samples"], "bucket": r["bucket"]}
        for s in r["spans"]:
            events.append({"ph": "X", "cat": TRACK_CAT, "name": s["name"], "pid": TRACK_PID,
                           "tid": 2 * r["id"] + s["thread"],
                           "ts": (s["start_ns"] - base_ns) / 1e3, "dur": s["dur_ns"] / 1e3,
                           "args": args})
    return events


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Trace the host and, where there is one, the card into
    ``log_dir/trace.json`` (Chrome trace format, for Perfetto or
    chrome://tracing), with the requests that ran inside it on their own
    track, on the trace's clock."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = next(_ids)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    ran = [r.as_dict() for r in list(_log) if r.id > first]
    if ran:
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"] += _trace_events(ran, int(trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f)
