"""The program's recorder (``rvc_tpu_torch/utils/profiling.py``) on the
serving path, on the CPU with tiny random models: each request's spans nest
under ``rvc.request`` on the fused path, the windowed path (its host f0's
network and decode, with RMVPE and with CREPE, and its counters) and
``pipeline_many`` (the stream's drain thread records under the request that
dispatched its item), and on two threads converting at once; no ``record_function`` range opens without a profiler,
and with one every span is a range whose start lies on the request's clock;
``device_trace`` writes the requests' track; the log stays bounded; the
counters count. This file imports no JAX: its ``cuda``-marked test runs on
the card (``python -m pytest --noconftest -m cuda -s
tests/test_torch_port_tracing.py``) and names every stream synchronisation
of a warm fused 10 s conversion, with the recorder's cost per request.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import contextlib
import json
import linecache
import os
import statistics
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from rvc_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HUB = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
           conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
           num_conv_pos_embedding_groups=4)
SYN = dict(inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
           n_layers=2, kernel_size=3, resblock_kernel_sizes=(3, 5),
           resblock_dilation_sizes=((1, 3), (1, 3)), upsample_rates=(12, 10, 2, 2),
           upsample_initial_channel=32, upsample_kernel_sizes=(24, 20, 4, 4),
           spk_embed_dim=4, gin_channels=8, sr=48000, text_enc_hidden_dim=32)
E2E = dict(n_blocks=1, en_de_layers=2, inter_layers=1, en_out_channels=4,
           gru_hidden=16)
WIN = dict(x_pad=1, x_query=1, x_center=2, x_max=3)
KW = dict(sid=1, pitch_shift=2, index_rate=0.75, protect=0.33, filter_radius=3)

STAGES = ("rvc.prep", "rvc.upload", "rvc.dispatch", "rvc.download", "rvc.finish")
MODELS = ("rvc.mel", "rvc.rmvpe", "rvc.f0", "rvc.hubert", "rvc.retrieval", "rvc.synth")
# the fused path's one span inside rvc.prep: the cut-point search, which
# returns at once for an input up to x_max
FUSED = ("rvc.request",) + STAGES + MODELS + ("rvc.decoder", "rvc.cut_points")
OPS = ("rvc.stage_tails", "rvc.knn", "rvc.bigru")


def _pipe(cfg=None):
    from rvc_tpu_torch.embedders.hubert import Hubert, HubertConfig
    from rvc_tpu_torch.infer.pipeline import Pipeline, PipelineConfig
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.predictors.rmvpe import RMVPE, E2EModel

    torch.manual_seed(0)
    syn = Synthesizer(flow_layers=2, zero_noise=True, **SYN)
    pipe = Pipeline(48000, syn, Hubert(HubertConfig(**HUB)),
                    PipelineConfig(**(cfg or {})), upsample_factor=480,
                    precision="fp32", device="cpu")
    return pipe, RMVPE(E2EModel(**E2E).eval(), device="cpu")


@pytest.fixture(scope="module")
def fused():
    pipe, rmvpe = _pipe()
    pipe.set_rmvpe(rmvpe)
    (cold,) = _new_records(lambda: pipe.pipeline(_audio(16000), **KW))
    assert cold["counters"]["weight_packs"] > 0     # the first call packs the decoder's
    return pipe


@pytest.fixture(scope="module")
def windowed():
    return _pipe(WIN)


def _audio(n, seed=21):
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / 16000
    return (0.4 * np.sin(2 * np.pi * 220 * tt) + 0.05 * rng.normal(size=n)).astype(np.float32)


def _index():
    return np.random.default_rng(22).normal(size=(300, 32)).astype(np.float32)


def _new_records(run):
    """The records that ``run()`` adds to the log."""
    last = profiling.requests()[-1]["id"] if profiling.requests() else 0
    run()
    return [r for r in profiling.requests() if r["id"] > last]


def _check_nesting(rec):
    spans = rec["spans"]
    root = spans[0]
    assert root["name"] == "rvc.request" and root["parent"] is None
    assert root["start_ns"] == rec["start_ns"] and root["dur_ns"] == rec["dur_ns"]
    for s in spans[1:]:
        parent = spans[s["parent"]]
        assert parent["start_ns"] <= s["start_ns"]
        if s["thread"] == 0:    # the request's own thread: nested in time too
            assert s["start_ns"] + s["dur_ns"] <= parent["start_ns"] + parent["dur_ns"]
        else:                   # another thread's span hangs from the root
            assert s["parent"] == 0
    return {s["name"]: spans[s["parent"]]["name"] for s in spans[1:]}


def test_fused_request_spans_nest(fused):
    audio = _audio(24000)
    (rec,) = _new_records(lambda: fused.pipeline(audio, index_vectors=_index(), **KW))
    parents = _check_nesting(rec)
    assert set(parents) == set(FUSED[1:])
    assert all(parents[n] == "rvc.request" for n in STAGES)
    assert all(parents[n] == "rvc.dispatch" for n in MODELS)
    assert parents["rvc.decoder"] == "rvc.synth"
    assert parents["rvc.cut_points"] == "rvc.prep"
    assert rec["samples"] == 24000 and rec["bucket"] == fused._bucket_len(24000 + 2 * 48000)
    assert not rec["profiled"] and not rec["failed"]
    assert rec["counters"] == {}    # nothing page-locked, no weights packed: CPU, warm
    assert profiling.current() is None


def test_windowed_request_records_the_drain_thread(windowed):
    pipe, rmvpe = windowed
    audio = _audio(112000)
    (rec,) = _new_records(lambda: pipe.pipeline(
        audio, f0_method="rmvpe", predictors={"rmvpe": rmvpe.infer_from_audio},
        index_vectors=_index(), **KW))
    parents = _check_nesting(rec)
    names = [s["name"] for s in rec["spans"]]
    assert parents["rvc.host_f0"] == "rvc.request" and "rvc.mel" not in names
    windows = names.count("rvc.dispatch")
    assert windows == 4 and names.count("rvc.upload") == 4
    drained = [s for s in rec["spans"] if s["thread"] == 1]
    assert [s["name"] for s in drained] == ["rvc.download"] * windows
    assert names.count("rvc.download") == windows       # the wait, on the drain thread
    assert names.count("rvc.download_enqueue") == windows
    assert all(parents[n] == "rvc.request" for n in ("rvc.download", "rvc.download_enqueue"))
    assert rec["bucket"] % 16000 == 0 and rec["bucket"] < 112000 + 2 * 16000


@pytest.mark.parametrize("method", ["rmvpe", "crepe"])
def test_windowed_f0_spans_and_counters(windowed, method):
    """The host f0 splits into the network (``rvc.f0_net``) and the decode
    (``rvc.f0_decode``); the request counts the frames the network saw
    (CREPE: the padded input's samples // 160 + 1; RMVPE: its one-second
    bucket's frames to a multiple of 32) and its windows."""
    from rvc_tpu_torch.predictors.crepe import CREPE

    pipe, rmvpe = windowed
    predict = rmvpe.infer_from_audio if method == "rmvpe" else CREPE("tiny", device="cpu").predict
    (rec,) = _new_records(lambda: pipe.pipeline(
        _audio(112000), f0_method=method, predictors={method: predict}, **KW))
    parents = _check_nesting(rec)
    names = [s["name"] for s in rec["spans"]]
    assert parents["rvc.f0_net"] == parents["rvc.f0_decode"] == "rvc.host_f0"
    assert parents["rvc.cut_points"] == "rvc.prep"
    assert names.count("rvc.f0_net") == names.count("rvc.f0_decode") == 1
    padded = 112000 + 2 * 16000
    frames = (padded // 160 + 1 if method == "crepe"
              else -(-(pipe._bucket_len(padded) // 160 + 1) // 32) * 32)
    assert rec["counters"]["f0_frames"] == frames
    assert rec["counters"]["windows"] == names.count("rvc.dispatch") == 4


def test_crepe_batches_open_their_range(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from rvc_tpu_torch.predictors.crepe import CREPE

    pred = CREPE("tiny", device="cpu")
    ranges = _Ranges(profiling.record_function)
    monkeypatch.setattr(profiling, "record_function", ranges)
    audio = _audio(16000)
    pred.predict(audio, batch_size=40)
    assert ranges.names == []
    with profile(activities=[ProfilerActivity.CPU]):
        pred.predict(audio, batch_size=40)
    assert ranges.names.count("rvc.crepe") == 3         # 101 frames in batches of 40
    assert {"rvc.f0_net", "rvc.f0_decode"} <= set(ranges.names)


def test_pipeline_many_records_a_request_per_clip(fused):
    audios = [_audio(n, seed=s) for n, s in ((20000, 6), (27000, 7), (9000, 8))]
    recs = _new_records(lambda: fused.pipeline_many(audios, index_vectors=_index(), **KW))
    assert [r["samples"] for r in recs] == [20000, 27000, 9000]
    assert len({r["id"] for r in recs}) == 3
    for rec in recs:
        parents = _check_nesting(rec)
        assert set(STAGES) <= set(parents)
        drained = [s["name"] for s in rec["spans"] if s["thread"] == 1]
        assert drained == ["rvc.download"], rec["id"]
    assert profiling.current() is None


def test_concurrent_conversions_record_apart(fused):
    """Two threads convert at once, as the web UI's do: each request holds
    its own thread's spans, nested, and both convert as they do alone."""
    audios = {n: _audio(n, seed=n % 97) for n in (20000, 26000)}
    alone = {n: fused.pipeline(a, index_vectors=_index(), **KW) for n, a in audios.items()}
    start, outs, errors = threading.Barrier(2), {}, []

    def convert(n):
        try:
            start.wait()
            outs[n] = [fused.pipeline(audios[n], index_vectors=_index(), **KW)
                       for _ in range(2)]
        except Exception as e:      # noqa: BLE001  re-raised on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=convert, args=(n,)) for n in audios]
    recs = _new_records(lambda: [t.start() for t in threads] + [t.join() for t in threads])
    assert not errors, errors
    for n, out in outs.items():
        assert all(np.array_equal(o, alone[n]) for o in out)
    assert sorted(r["samples"] for r in recs) == [20000, 20000, 26000, 26000]
    for rec in recs:
        parents = _check_nesting(rec)
        assert set(parents) == set(FUSED[1:]) and not rec["failed"]
        assert all(s["thread"] == 0 for s in rec["spans"])
        assert sorted(s["name"] for s in rec["spans"]) == sorted(FUSED)
    assert profiling.current() is None


def test_spans_close_in_their_own_request():
    """Thread A's spans close in A's request while thread B's request is
    open on B, and B's in B's, whatever order they interleave in."""
    span = profiling.span
    a_open, b_open, a_closed = threading.Event(), threading.Event(), threading.Event()
    done = {}

    def a():
        with profiling.request(160) as req:
            with span("rvc.dispatch"):
                with span("rvc.rmvpe"):
                    a_open.set()
                    b_open.wait(5)
            a_closed.set()
        done["a"] = req.as_dict()

    def b():
        a_open.wait(5)
        with profiling.request(320) as req:
            with span("rvc.prep"):
                b_open.set()
                a_closed.wait(5)
            with span("rvc.finish"):
                pass
        done["b"] = req.as_dict()

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert {n: _check_nesting(done[n]) for n in "ab"} == {
        "a": {"rvc.dispatch": "rvc.request", "rvc.rmvpe": "rvc.dispatch"},
        "b": {"rvc.prep": "rvc.request", "rvc.finish": "rvc.request"}}
    assert [done[n]["samples"] for n in "ab"] == [160, 320]


def test_a_failed_request_is_logged(fused):
    bad = _audio(8000)
    recs = _new_records(lambda: pytest.raises(Exception, fused.pipeline, bad,
                                              index_vectors=_index(), sid=99))
    assert len(recs) == 1 and recs[0]["failed"]
    assert profiling.current() is None


class _Ranges:
    """Counts ``record_function`` ranges the recorder opens."""

    def __init__(self, real):
        self.real, self.names = real, []

    def __call__(self, name):
        self.names.append(name)
        return self.real(name)


def test_no_range_without_a_profiler(fused, monkeypatch):
    ranges = _Ranges(profiling.record_function)
    monkeypatch.setattr(profiling, "record_function", ranges)
    fused.pipeline(_audio(20000), index_vectors=_index(), **KW)
    assert ranges.names == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        fused.pipeline(_audio(20000), index_vectors=_index(), **KW)
    assert set(FUSED + OPS) <= set(ranges.names)


def test_trace_holds_each_span_on_its_clock(fused, tmp_path):
    audio = _audio(24000)
    recs = _new_records(lambda: _traced(fused, audio, tmp_path))
    (rec,) = recs
    assert rec["profiled"]
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith("rvc."):
            ranges.setdefault(e["name"], []).append(e["ts"] + base_us)
    assert set(FUSED + OPS) <= set(ranges)
    assert set(ranges) <= set(FUSED + OPS)      # fixed names: no request id in any
    for s in rec["spans"]:                      # each span's start within 1 ms
        near = min(abs(t - s["start_ns"] / 1e3) for t in ranges[s["name"]])
        assert near < 1000.0, (s["name"], near)
    track = [e for e in trace["traceEvents"] if e.get("cat") == profiling.TRACK_CAT]
    assert len(track) == len(rec["spans"])
    assert {e["pid"] for e in track} == {profiling.TRACK_PID}
    assert all(e["ph"] == "X" and e["args"] == {"request": rec["id"], "samples": 24000,
                                                "bucket": rec["bucket"]} for e in track)
    root = next(e for e in track if e["name"] == "rvc.request")
    assert abs(root["ts"] + base_us - rec["start_ns"] / 1e3) < 1.0
    assert abs(root["ts"] + base_us - min(ranges["rvc.request"])) < 1000.0


def _traced(pipe, audio, tmp_path):
    with profiling.device_trace(str(tmp_path)):
        pipe.pipeline(audio, index_vectors=_index(), **KW)


def test_log_stays_bounded():
    last = None
    for i in range(profiling.LOG_SIZE + 10):
        with profiling.request(160 + i) as req:
            with profiling.span("rvc.prep"):
                last = req.id
    recs = profiling.requests()
    assert len(recs) == profiling.LOG_SIZE
    assert recs[-1]["id"] == last and recs[0]["id"] == last - profiling.LOG_SIZE + 1
    assert [r["samples"] for r in recs[-2:]] == [160 + profiling.LOG_SIZE + 8,
                                                 160 + profiling.LOG_SIZE + 9]


def test_counters_count():
    from rvc_tpu_torch.utils.weight_cache import WeightCache

    before = profiling.counters().get("weight_packs", 0)
    cache, w = WeightCache(), torch.ones(3)
    with profiling.request(16000) as req:
        cache.get([w], "k", lambda: w * 2)
        cache.get([w], "k", lambda: w * 2)      # warm: no rebuild
        w.add_(1)                               # changed in place: rebuilt
        cache.get([w], "k", lambda: w * 2)
        profiling.count("pinned_allocs", 2)
    assert cache.builds == 2
    assert req.as_dict()["counters"] == {"weight_packs": 2, "pinned_allocs": 2}
    assert profiling.counters()["weight_packs"] == before + 2
    profiling.count("pinned_allocs")            # outside a request: the total alone
    assert profiling.requests()[-1]["counters"]["pinned_allocs"] == 2


def _request_shape(ops):
    """An empty request shaped as a fused one: the root, 12 spans and one
    count, with ``ops`` the 6 op ranges of the 48 kHz path (4 stage
    tails, K3, G)."""
    span, op = profiling.span, profiling.annotate
    with profiling.request(16000) as req:
        req.bucket = 16000
        with span("rvc.prep"):
            pass
        with span("rvc.upload"):
            profiling.count("pinned_allocs")
        with span("rvc.dispatch"):
            with span("rvc.mel"):
                pass
            with span("rvc.rmvpe"):
                if ops:
                    with op("rvc.bigru"):
                        pass
            with span("rvc.f0"):
                pass
            with span("rvc.hubert"):
                pass
            with span("rvc.retrieval"):
                if ops:
                    with op("rvc.knn"):
                        pass
            with span("rvc.synth"), span("rvc.decoder"):
                for _ in range(4 if ops else 0):
                    with op("rvc.stage_tails"):
                        pass
        with span("rvc.download"):
            pass
        with span("rvc.finish"):
            pass


def span_cost_us(profiled=False, ops=True, repeats=7, n=2000):
    """Least and median host microseconds of ``_request_shape`` over
    ``repeats`` of ``n``, with or without a profiler running."""
    from torch.profiler import ProfilerActivity, profile

    costs = []
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(n):
                _request_shape(ops)
            costs.append((time.perf_counter() - t0) / n * 1e6)
    return min(costs), statistics.median(costs)


@pytest.mark.cuda
def test_sync_sites_of_a_warm_fused_conversion():
    """Every stream synchronisation of one warm fused 10 s conversion of the
    benchmark's 48 kHz configuration, named by its line and the span it ran
    in; the recorder's cost per request without and with a profiler."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import sys

    sys.path.insert(0, REPO)
    from benchmark import serve, traffic

    def load(*path):
        with open(os.path.join(REPO, "benchmark", *path)) as f:
            return json.load(f)

    built = serve.build(load("configs", "nsf48.json"), 7, torch.device("cuda"))
    pipe, mix = built["pipe"], load("traffic", "clips.json")
    audio = traffic.voice(160000, np.random.default_rng(7), mix["signal"])
    s = mix["settings"]
    kw = dict(sid=s["sid"], pitch_shift=s["pitch_shift"], f0_method=s["f0_method"],
              index_vectors=built["index"], index_rate=s["index_rate"],
              protect=s["protect"], filter_radius=s["filter_radius"])
    for _ in range(2):
        pipe.pipeline(audio, **kw)
    torch.cuda.synchronize()

    sites = []

    def seen(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        req, path = profiling.current(), []
        rec = req._top if req is not None else None     # the innermost open span
        while rec is not None:
            path.insert(0, rec[0])
            rec = rec[1]
        where = " > ".join(path) or "-"
        code = linecache.getline(filename, lineno).strip()
        sites.append((os.path.relpath(filename, REPO), lineno, code, where))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            (rec,) = _new_records(lambda: pipe.pipeline(audio, **kw))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    print(f"\nsyncs {len(sites)} in a warm fused 10 s conversion "
          f"({torch.cuda.get_device_name(0)})")
    for s in sites:
        print("sync", *s, sep=" | ")
    split = {}
    for s in rec["spans"][1:]:
        if s["parent"] == 0:
            split[s["name"]] = split.get(s["name"], 0) + s["dur_ns"] / 1e6
    print("request ms", rec["dur_ns"] / 1e6, "stages ms",
          {k: round(v, 3) for k, v in split.items()}, "counters", rec["counters"])
    for profiled in (False, True):
        for ops in (False, True):
            print("recorder us a request (least, median): profiler", profiled, "op ranges", ops,
                  span_cost_us(profiled, ops, n=2000 if not profiled else 300))
    assert sites and all(s[3] != "-" for s in sites)
    assert any("rvc.download" in s[3] for s in sites)
    assert rec["counters"] == {"pinned_allocs": 1}
    assert sum(split.values()) >= 0.95 * rec["dur_ns"] / 1e6
