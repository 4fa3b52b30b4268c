"""The ``serve`` kind of run: a mix whose ``kind`` is ``serve``. ``run``
makes the set-up (seeded weights and index on the device, the port's
``Pipeline`` built as ``VoiceConverter`` builds it, every bucket the mix can
draw warmed), the measured window of a closed-loop client calling
``Pipeline.pipeline``, with ``--trace 1`` CUDA-event spans over that window
and a second, profiled window, and the comparison with the reference;
``result`` makes the result line."""

from __future__ import annotations

import gc
import math
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, weights
from .traffic import Traffic
from .work import flops

PACKAGE = "rvc_tpu_torch"
WINDOW_RANGE = "bench.window"
SCOPES = ("bench.stage_tails", "bench.knn")


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def program_models(config: dict, device) -> dict:
    """The port's synthesizer, HuBERT and RMVPE models for ``config``, with
    the weights they are built with."""
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.embedders.hubert import Hubert, HubertConfig
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.predictors.rmvpe import E2EModel

    m = config["synthesizer"]
    exp = get_config(config["sample_rate"], vocoder=m["vocoder"],
                     **{k: _tuples(v) for k, v in m.items() if k != "vocoder"})
    hub = HubertConfig(**{k: _tuples(v) for k, v in config["hubert"].items()})
    return {"synth": Synthesizer.from_config(exp, device=device),
            "hubert": Hubert.build(hub, device),
            "rmvpe": E2EModel(**config["rmvpe"]).to(device).eval()}


def build_shapes(config: dict) -> dict:
    """Each model's floating tensors by name and shape (built on the CPU)."""
    return {tag: weights.float_shapes(m) for tag, m in program_models(config, "cpu").items()}


def build(config: dict, seed: int, device) -> dict:
    """The program's pipeline on ``device`` with weights and index from
    ``seed``; the state_dicts are dropped once loaded (the check makes them
    again), only their shapes are kept."""
    from rvc_tpu_torch.infer.pipeline import Pipeline, PipelineConfig
    from rvc_tpu_torch.predictors.rmvpe import RMVPE

    m = config["synthesizer"]
    models = program_models(config, device)
    shapes = {tag: weights.float_shapes(model) for tag, model in models.items()}
    for tag, sd in weights.model_states(config, shapes, seed, device).items():
        model = models[tag]
        missing, unexpected = model.load_state_dict(sd, strict=False)
        if unexpected or any(torch.is_floating_point(model.state_dict()[k]) for k in missing):
            raise RuntimeError(f"{tag}: state_dict mismatch {missing} {unexpected}")
    pipe = Pipeline(config["sample_rate"], models["synth"], models["hubert"],
                    PipelineConfig.from_device(device),
                    upsample_factor=math.prod(m["upsample_rates"]),
                    precision=config["precision"], device=device)
    pipe.set_rmvpe(RMVPE(models["rmvpe"], device=device))
    index = weights.seeded_index(config["index"]["rows"], config["index"]["dim"], seed, device)
    return {"pipe": pipe, "index": index, "shapes": shapes}


class HostPool:
    """Page-locked host memory taken once at set-up, handed out in slices:
    a capture copies into it without a wait, and allocates no page-locked
    memory inside the window (``cudaHostAlloc`` stalls the device)."""

    def __init__(self, nbytes: int, cuda: bool):
        self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
        self.cuda, self.used = cuda, 0

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return t.detach().clone()
        n = t.numel() * t.element_size()
        if self.used + n > self.buf.numel():
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        else:
            out = self.buf[self.used:self.used + n].view(t.dtype).view(t.shape)
            self.used += -(-n // 256) * 256
        out.copy_(t, non_blocking=True)
        return out


def capture_bytes(samples: int) -> int:
    """An upper bound of one request's captured bytes at a bucket of
    ``samples`` (4 bytes an element, 8 for integers)."""
    frames = samples // 160
    salience = -(-(frames + 1) // 32) * 32 * 360
    features = ((samples - 400) // 320 + 1) * 768
    return 4 * (salience + features + frames * 768 + frames) + 8 * frames + 4096


class Recorder:
    """Keeps, for the requests that the check compares (the seed's sample
    and the longest so far), the program's RMVPE salience, content
    features, synthesizer inputs and output; with ``spans`` on, a
    device-timed span of each layer of every request."""

    def __init__(self, pipe, sample: set, pool: HostPool):
        self.sample, self.cur, self.kept, self.pool = sample, None, {}, pool
        self.longest: Optional[int] = None
        self.spans_on, self.spans = False, {}
        self.cuda = pipe.device.type == "cuda"
        for name, mod in (("rmvpe", pipe._rmvpe_model), ("hubert", pipe.embedder),
                          ("decoder", pipe.synthesizer.dec)):
            mod.register_forward_pre_hook(lambda *a, n=name: self._open(n))
            mod.register_forward_hook(lambda m, a, out, n=name: self._close(n, out))
        infer = pipe.synthesizer.infer

        def traced_infer(*args, **kwargs):
            if self.cur is not None:
                self.cur["synth_in"] = [self.pool.copy(t) for t in args[:5]]
            self._open("synth")
            out = infer(*args, **kwargs)
            self._close("synth", None)
            return out

        pipe.synthesizer.infer = traced_infer
        self._open_at: Dict[str, object] = {}

    def _stamp(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def _open(self, name):
        if self.spans_on:
            self._open_at[name] = self._stamp()

    def _close(self, name, out):
        if self.cur is not None and name in ("rmvpe", "hubert"):
            self.cur[name] = self.pool.copy(out)
        if self.spans_on:
            self.spans.setdefault(name, []).append((self._open_at.pop(name), self._stamp()))

    def begin(self, req) -> None:
        new_longest = (self.longest is None
                       or len(req.audio) > len(self.kept[self.longest]["req"].audio))
        self.cur = {"req": req} if (req.index in self.sample or new_longest) else None
        if new_longest:
            self.cur["longest"] = True

    def end(self, out: np.ndarray) -> None:
        if self.cur is None:
            return
        req = self.cur["req"]
        self.cur["out"] = out
        self.kept[req.index] = self.cur
        if self.cur.get("longest"):
            old = self.longest
            self.longest = req.index
            if old is not None and old not in self.sample:
                del self.kept[old]
        self.cur = None

    def span_seconds(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
            return {n: sum(a.elapsed_time(b) for a, b in v) / 1e3 for n, v in self.spans.items()}
        return {n: sum(b - a for a, b in v) for n, v in self.spans.items()}


class Entries:
    """``record_function`` ranges around the port's public entries of the
    stage tails (``ops/resblock.py``) and of retrieval (``ops/retrieval.py``),
    installed wherever the port's modules hold them, with the work of each
    call counted from its shapes while ``on``."""

    def __init__(self):
        import rvc_tpu_torch.ops.resblock as rb
        import rvc_tpu_torch.ops.retrieval as rt

        self.on, self.bound_s = False, {s: 0.0 for s in SCOPES}
        self._wrap(rb.mrf_stage, "bench.stage_tails", self._stage_work)
        self._wrap(rb.resblock_chain, "bench.stage_tails", self._chain_work)
        self._wrap(rt.knn_topk, "bench.knn", self._knn_work)

    def _wrap(self, fn, scope, work):
        def wrapped(*args, **kwargs):
            if self.on:
                self.bound_s[scope] += work(*args, **kwargs)
            with torch.autograd.profiler.record_function(scope):
                return fn(*args, **kwargs)

        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").split(".")[0] != PACKAGE:
                continue
            for attr, value in list(vars(mod).items()):
                if value is fn:
                    setattr(mod, attr, wrapped)

    @staticmethod
    def _stage_work(x, chains, kernel_sizes, dilations, slope=0.1, cache=None):
        b, c, t = x.shape
        wbytes = chains[0][0][0].element_size()
        f, nb = flops.stage_tail(b, c, t, kernel_sizes, dilations, x.element_size(), wbytes)
        return flops.bound_s(f, nb, "bf16" if x.dtype == torch.bfloat16 else "tf32")

    @staticmethod
    def _chain_work(x, w1s, b1s, w2s, b2s, dilations, slope=0.1, cache=None):
        b, c, t = x.shape
        f, nb = flops.stage_tail(b, c, t, [w1s[0].shape[-1]], dilations,
                                 x.element_size(), w1s[0].element_size())
        return flops.bound_s(f, nb, "tf32")

    @staticmethod
    def _knn_work(queries, vectors, k=8):
        f, nb = flops.knn(queries.shape[0], vectors.shape[0], queries.shape[1], k)
        return flops.bound_s(f, nb, "tf32")


def _generator(device, seed):
    return torch.Generator(device=device).manual_seed(int(seed))


def _serve(pipe, requests, seconds, kwargs, recorder, device) -> dict:
    """Closed loop: one request at a time, timed from the call into
    ``Pipeline.pipeline`` to its host array; the window closes at the first
    completion after ``seconds``, and every request and second counts."""
    lat, secs, samples, failed = [], [], [], 0
    start = time.perf_counter()
    while True:
        req = next(requests)
        gen = _generator(device, req.seed)
        recorder.begin(req)
        t0 = time.perf_counter()
        try:
            out = pipe.pipeline(req.audio, generator=gen, **kwargs)
        except Exception:           # a request that fails counts as failed
            print(f"request {req.index} failed:\n{traceback.format_exc()}", file=sys.stderr)
            failed, out = failed + 1, None
        t1 = time.perf_counter()
        if out is not None:
            recorder.end(out)
        else:
            recorder.cur = None
        lat.append(t1 - t0)
        secs.append(req.seconds)
        samples.append(len(req.audio))
        if t1 - start >= seconds:
            return {"window_s": t1 - start, "latency_s": lat, "audio_s": secs,
                    "samples": samples, "failed": failed}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    torch.backends.cudnn.benchmark = False
    config, mix = cell.config, cell.traffic
    built = build(config, seed, device)
    pipe, index = built["pipe"], built["index"]
    traffic = Traffic(mix, seed)
    s = mix["settings"]
    kwargs = dict(sid=s["sid"], pitch_shift=s["pitch_shift"], f0_method=s["f0_method"],
                  index_vectors=index, index_rate=s["index_rate"], protect=s["protect"],
                  filter_radius=s["filter_radius"])
    # warm every bucket the set can draw: one conversion of its longest member
    warm = {}
    for audio in traffic.set:
        warm[-(-(len(audio) + 2 * 3 * 16000) // 16000)] = audio
    sample = traffic.check_sample()
    pool = HostPool(capture_bytes(16000 * max(warm)) * (len(sample) + 8),
                    device.type == "cuda")
    recorder = Recorder(pipe, sample, pool)
    entries = Entries() if trace else None
    for audio in warm.values():
        pipe.pipeline(audio, generator=_generator(device, 0), **kwargs)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    requests = iter(traffic)
    gc.collect()
    gc.freeze()          # set-up's objects leave the collector's scans
    recorder.spans_on = trace
    main = _serve(pipe, requests, seconds, kwargs, recorder, device)
    sync()
    window_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    result = {"setup_s": setup_s, "main": main, "window_peak": window_peak,
              "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        recorder.spans_on = False
        result["spans_s"] = recorder.span_seconds()
        result["traced"] = _traced_window(pipe, requests, mix, kwargs, recorder,
                                          entries, device)
    # the program's state is freed before the reference runs
    t_check = time.perf_counter()
    kept, shapes = recorder.kept, built["shapes"]
    del pipe, built, recorder, entries
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = check.compare(config, mix, seed, kept, shapes, device)
    traced = (" audio_s_per_s_main={main:.2f} audio_s_per_s_traced={traced:.2f}"
              .format(**rates(result)) if trace else "")
    print(f"timing setup_s={setup_s:.3f} window_s={main['window_s']:.3f} "
          f"requests={len(main['latency_s'])} check_s={time.perf_counter() - t_check:.3f} "
          f"compared={result['checks']['compared']} "
          f"audio_s_per_s_by_quarter={_quarters(main)}{traced}", file=sys.stderr)
    return result


def _quarters(main: dict) -> List[float]:
    """Input audio seconds per second in each quarter of the window, by the
    requests that ended in it: whether a run's rate drifts within it."""
    ends = np.cumsum(main["latency_s"])
    q = np.minimum((4 * ends / ends[-1]).astype(int), 3)
    audio = np.asarray(main["audio_s"])
    return [round(float(audio[q == i].sum() / (main["window_s"] / 4)), 2) for i in range(4)]


def _traced_window(pipe, requests, mix, kwargs, recorder, entries, device) -> dict:
    """A second window of ``trace_seconds`` under ``torch.profiler``, the
    layer ranges on; its chrome trace is read and deleted."""
    import os
    from torch.profiler import ProfilerActivity, profile

    from .trace import summarize

    rf = torch.autograd.profiler.record_function
    opened = []
    hooks = []
    for name, mod in (("bench.rmvpe", pipe._rmvpe_model), ("bench.hubert", pipe.embedder),
                      ("bench.decoder", pipe.synthesizer.dec)):
        hooks.append(mod.register_forward_pre_hook(
            lambda *a, n=name: opened.append(rf(n).__enter__())))
        hooks.append(mod.register_forward_hook(
            lambda *a: opened.pop().__exit__(None, None, None)))
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    entries.on = True
    with profile(activities=activities) as prof:
        with rf(WINDOW_RANGE):
            traced = _serve(pipe, requests, mix["trace_seconds"], kwargs, recorder, device)
            if device.type == "cuda":
                torch.cuda.synchronize()
    entries.on = False
    for h in hooks:
        h.remove()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), "rvc_bench_trace.json")
    prof.export_chrome_trace(path)
    try:
        traced["summary"] = summarize(path, WINDOW_RANGE, list(SCOPES))
    finally:
        os.remove(path)
    traced["bound_s"] = dict(entries.bound_s)
    return traced


def metrics_e2e(result: dict) -> dict:
    """The end-to-end readings of the main window. The input rate is
    ``long_audio_s_per_s``, the long takes' own: on the short clips the host
    sets it and it spreads too widely for a bound, so there it is the
    per-layer ``audio_s_per_s.clips``."""
    main = result["main"]
    lat = sorted(main["latency_s"])
    return {
        "long_audio_s_per_s": sum(main["audio_s"]) / main["window_s"],
        "serve_latency_p95_ms": 1e3 * float(np.percentile(lat, 95)),
        "peak_mem_gib": result["window_peak"] / 2 ** 30,
        "setup_s": result["setup_s"],
    }


def reader_context(result: dict, config: dict) -> dict:
    """What the per-layer readers read: the traced window's summary, counted
    bounds and work, the spans of the main window, and its work."""
    main, traced = result["main"], result["traced"]
    return {
        "trace": traced["summary"],
        "trace_audio_s": sum(traced["audio_s"]),
        "trace_model_flops": sum(flops.conversion(n, config) for n in traced["samples"]),
        "bound_s": traced["bound_s"],
        "spans_s": result["spans_s"],
        "audio_s": sum(main["audio_s"]),
        "window_s": main["window_s"],
        "model_flops": sum(flops.conversion(n, config) for n in main["samples"]),
        "peak_flops": flops.PEAK_FLOPS["bf16"],
    }


def rates(result: dict) -> dict:
    """Input seconds per second of the main window and of the profiled one:
    how far the profiler's host cost slows the traced window."""
    return {name: sum(w["audio_s"]) / w["window_s"]
            for name, w in (("main", result["main"]), ("traced", result["traced"]))}


def result(cell, res: dict, trace: bool, device_info: dict) -> dict:
    """The result line's object: ``correct`` from the comparison's gaps and
    the requests that failed, the cell's metrics, the device, with ``trace``
    the breakdown and both windows' rates, and last the numbers compared."""
    from . import spec

    main = res["main"]
    gaps = res["checks"]["gaps"]
    failed = main["failed"] + (res["traced"]["failed"] if trace else 0)
    attempted = len(main["latency_s"]) + (len(res["traced"]["latency_s"]) if trace else 0)
    correct = failed == 0 and res["checks"]["compared"] > 0 and all(
        g["value"] <= g["limit"] for g in gaps.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        ctx = reader_context(res, cell.config)
        out["metrics"] = spec.read_metrics(cell.root, cell.per_layer, ctx)
        summary = res["traced"]["summary"]
        device_info = {**device_info, "busy_s": summary["busy_s"],
                       "window_s": summary["window_s"]}
    else:
        values = metrics_e2e(res)
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
    out["device"] = device_info
    if trace:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        out["audio_s_per_s"] = rates(res)
    out["checks"] = {n: {"value": g["value"], "limit": g["limit"]} for n, g in gaps.items()}
    return out
