"""The ``windowed`` kind of run: a mix whose ``kind`` is ``windowed``, of
inputs longer than the fused path takes. The port converts each through
``Pipeline.pipeline``'s windowed path: the f0 of the whole input on the
host side (``rvc.host_f0``), the cut points, the windows through
``_convert_core``, their concatenation.

``run`` builds the pipeline as ``serve`` does and the configuration's f0
predictor as ``VoiceConverter.get_predictors`` builds it (``build_predictors``:
CREPE for a configuration with an ``f0`` section, RMVPE's host predictor
otherwise), with seeded weights; converts every member of the set once
(every bucket and window length the set can draw); then runs ``serve``'s
closed-loop window and, with ``--trace 1``, a profiled one. ``result``
makes the result line with ``serve``'s end-to-end metrics and the readers'
context of this path's work.

``correct`` is decided as ``check.py`` decides it, stage by stage, per
window where the path cuts, on the compared requests (the seed's sample and
the window's longest), by the reference in float32 with TF32 off:

- ``salience_vs_bf16``: the f0 network's salience of the whole padded input
  (CREPE's frames, or RMVPE's one-second bucket) against the reference's,
  over the gap of the reference computed with bf16 operands;
- ``features_gap``: each window's HuBERT features from its audio;
- ``synth_inputs_gap``: each window's synthesizer inputs rebuilt from the
  program's salience and features (the decode, median filter, shift and
  quantisation over the whole input, the window's slice, its row, the
  retrieval and protect): the worst of the features' and f0's relative
  gaps and the share of frames whose coarse pitch is off by more than one;
- ``output_gap``: each window's span of the returned waveform against the
  reference synthesizer run on the program's inputs, with the request's
  one generator drawn window after window, trimmed, joined and
  peak-normalised.

A window count that differs from the reference's cut points reads as an
infinite gap. ``control_gaps`` puts the reference in the program's place
(the f0 network and the rest each in a precision of their own), for the
limits."""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from . import check, serve, weights
from .reference import conversion, crepe, hubert, rmvpe, synth
from .reference import windows as geometry
from .reference.ops import operand_precision
from .traffic import Traffic, voice
from .work import crepe_flops, flops

CREPE_RANGE = "rvc.crepe"
SCOPES = serve.SCOPES + (CREPE_RANGE,)


def f0_network(config: dict) -> str:
    """``crepe`` for a configuration with an ``f0`` section, else ``rmvpe``."""
    return config["f0"]["method"] if "f0" in config else "rmvpe"


def program_models(config: dict, device) -> dict:
    """The port's synthesizer and HuBERT for ``config`` and its f0 network:
    RMVPE (``serve``'s), or CREPE at the configuration's capacity."""
    if "f0" not in config:
        return serve.program_models(config, device)
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.embedders.hubert import Hubert, HubertConfig
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.predictors.crepe import CrepeModel

    m = config["synthesizer"]
    exp = get_config(config["sample_rate"], vocoder=m["vocoder"],
                     **{k: serve._tuples(v) for k, v in m.items() if k != "vocoder"})
    hub = HubertConfig(**{k: serve._tuples(v) for k, v in config["hubert"].items()})
    return {"synth": Synthesizer.from_config(exp, device=device),
            "hubert": Hubert.build(hub, device),
            "crepe": CrepeModel(config["f0"]["capacity"]).to(device).eval()}


def build_shapes(config: dict) -> dict:
    return {tag: weights.float_shapes(m) for tag, m in program_models(config, "cpu").items()}


def model_states(config: dict, shapes: Dict[str, dict], seed: int, device) -> dict:
    """Each model's state_dict from ``seed``: ``weights.model_states`` with
    RMVPE; with CREPE its batch norms calibrated on the same seeded voice."""
    if "crepe" not in shapes:
        return weights.model_states(config, shapes, seed, device)
    rates = config["synthesizer"]["upsample_rates"]
    out = {tag: weights.seeded_state(s, seed, tag, device, rates) for tag, s in shapes.items()}
    rng = np.random.default_rng(weights.derive_seed(seed, "calibration"))
    audio = torch.from_numpy(voice(weights.CALIBRATION_SAMPLES, rng, weights.CALIBRATION_SIGNAL))
    crepe.calibrate(out["crepe"], audio.to(device), config["f0"])
    return out


def build(config: dict, mix: dict, seed: int, device) -> dict:
    """The program's pipeline and f0 predictor on ``device`` with weights and
    index from ``seed``."""
    from rvc_tpu_torch.infer.pipeline import Pipeline, PipelineConfig
    from rvc_tpu_torch.predictors.f0_extractor import build_predictors
    from rvc_tpu_torch.predictors.rmvpe import RMVPE

    method = f0_network(config)
    models = program_models(config, device)
    if method == "crepe":
        # the predictor VoiceConverter.get_predictors builds, its model given
        # the seeded weights below
        name = "crepe" if config["f0"]["capacity"] == "full" else "crepe-tiny"
        predict = build_predictors((name,), crepe_ckpt="", device=device)[name]
        models["crepe"] = predict.__self__.model
        eps = {m.eps for m in models["crepe"].modules() if isinstance(m, torch.nn.BatchNorm2d)}
        if eps != {config["f0"]["bn_eps"]}:
            raise RuntimeError(f"the program's CREPE batch norms use epsilon {sorted(eps)}, "
                               f"the configuration torchcrepe's {config['f0']['bn_eps']}")
    else:
        predict = RMVPE(models["rmvpe"], device=device).infer_from_audio
    shapes = {tag: weights.float_shapes(model) for tag, model in models.items()}
    for tag, sd in model_states(config, shapes, seed, device).items():
        model = models[tag]
        missing, unexpected = model.load_state_dict(sd, strict=False)
        if unexpected or any(torch.is_floating_point(model.state_dict()[k]) for k in missing):
            raise RuntimeError(f"{tag}: state_dict mismatch {missing} {unexpected}")
    m = config["synthesizer"]
    pipe = Pipeline(config["sample_rate"], models["synth"], models["hubert"],
                    PipelineConfig(**mix["windows"]),
                    upsample_factor=math.prod(m["upsample_rates"]),
                    precision=config["precision"], device=device)
    index = weights.seeded_index(config["index"]["rows"], config["index"]["dim"], seed, device)
    return {"pipe": pipe, "predictor": predict.__self__, "f0_model": models[method],
            "predictors": {method: predict}, "index": index, "shapes": shapes}


def capture_bytes(samples: int, win: dict) -> int:
    """An upper bound of one request's captured bytes: the salience (4
    bytes an element, RMVPE's padded to 32 frames) and, for each window
    with its pads and bucket, its features and synthesizer inputs."""
    pads = 2 * 16000 * win["x_pad"]
    n_windows = samples // (16000 * (win["x_center"] - win["x_query"])) + 2
    frames = (samples + pads + n_windows * (pads + 2 * 16000)) // 160
    salience = ((samples + pads) // 160 + 64) * 360 * 4
    return salience + frames * (2 * 768 * 4 + 16) + 256 * (n_windows * 8 + 256) + 4096


class Recorder(serve.Recorder):
    """``serve``'s recorder for this path: keeps, for the compared requests
    (the seed's sample and the longest so far), the program's f0 salience
    (each forward's), each window's content features and synthesizer
    inputs, and the output; with ``spans`` on, a device-timed span of each
    model's every call."""

    def __init__(self, pipe, f0_name: str, f0_model, sample: set, pool: serve.HostPool):
        self.sample, self.cur, self.kept, self.pool = sample, None, {}, pool
        self.longest = None
        self.spans_on, self.spans, self._open_at = False, {}, {}
        self.cuda = pipe.device.type == "cuda"
        for name, mod, key in ((f0_name, f0_model, "f0"), ("hubert", pipe.embedder, "hubert"),
                               ("decoder", pipe.synthesizer.dec, None)):
            mod.register_forward_pre_hook(lambda *a, n=name: self._open(n))
            mod.register_forward_hook(lambda m, a, out, n=name, k=key: self._close(n, out, k))
        infer = pipe.synthesizer.infer

        def traced_infer(*args, **kwargs):
            if self.cur is not None:
                self.cur["synth_in"].append([self.pool.copy(t) for t in args[:5]])
            self._open("synth")
            out = infer(*args, **kwargs)
            self._close("synth", None)
            return out

        pipe.synthesizer.infer = traced_infer

    def _close(self, name, out, key=None):
        if self.cur is not None and key is not None:
            self.cur[key].append(self.pool.copy(out))
        if self.spans_on:
            self.spans.setdefault(name, []).append((self._open_at.pop(name), self._stamp()))

    def begin(self, req) -> None:
        super().begin(req)
        if self.cur is not None:
            self.cur.update(f0=[], hubert=[], synth_in=[])


class CrepeWork:
    """Counts, while ``on``, the least time of each call into the CREPE
    predictor's salience (a batch of frames), which the program's
    ``rvc.crepe`` range covers."""

    def __init__(self, predictor, arch: dict):
        self.on, self.bound_s = False, 0.0
        salience = predictor.salience

        def counted(frames):
            if self.on:
                self.bound_s += crepe_flops.bound_s(frames.shape[0], arch)
            return salience(frames)

        predictor.salience = counted


def conversion_flops(audio: np.ndarray, config: dict, win: dict) -> int:
    """Model operations of one windowed conversion: the f0 network over the
    whole padded input (CREPE's frames, RMVPE's bucket), and HuBERT and the
    synthesizer over each window at its length."""
    _, pad, segs = _padded(audio, win)
    if "f0" in config:
        total = crepe_flops.salience(len(pad) // config["f0"]["hop"] + 1, config["f0"])[0]
    else:
        total = flops.rmvpe(conversion.bucket(len(pad)), config["rmvpe"])
    m = config["synthesizer"]
    dec = flops.refinegan_decoder if m["vocoder"] == "RefineGAN" else flops.nsf_decoder
    for a, b, _, _ in segs:
        n = (b - a) // 160
        total += (flops.hubert(b - a, config["hubert"]) + flops.text_encoder(n, m)
                  + flops.flow(n, m) + dec(n, m))
    return total


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    torch.backends.cudnn.benchmark = False
    cudnn_tf32 = torch.backends.cudnn.allow_tf32      # the program's convolutions' precision
    config, mix = cell.config, cell.traffic
    built = build(config, mix, seed, device)
    pipe, index = built["pipe"], built["index"]
    method = f0_network(config)
    traffic = Traffic(mix, seed)
    s = mix["settings"]
    kwargs = dict(sid=s["sid"], pitch_shift=s["pitch_shift"], f0_method=method,
                  index_vectors=index, index_rate=s["index_rate"], protect=s["protect"],
                  filter_radius=s["filter_radius"], predictors=built["predictors"])
    sample = traffic.check_sample()
    longest = max(len(a) for a in traffic.set)
    pool = serve.HostPool(capture_bytes(longest, mix["windows"]) * (len(sample) + len(traffic.set)),
                          device.type == "cuda")
    recorder = Recorder(pipe, method, built["f0_model"], sample, pool)
    entries = serve.Entries() if trace else None
    work = CrepeWork(built["predictor"], config["f0"]) if trace and method == "crepe" else None
    # every member once: every bucket and window length the set can draw
    for audio in traffic.set:
        pipe.pipeline(audio, generator=serve._generator(device, 0), **kwargs)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    requests = iter(traffic)
    gc.collect()
    gc.freeze()
    recorder.spans_on = trace
    main = serve._serve(pipe, requests, seconds, kwargs, recorder, device)
    sync()
    window_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    result = {"setup_s": setup_s, "main": main, "window_peak": window_peak,
              "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        recorder.spans_on = False
        result["spans_s"] = recorder.span_seconds()
        result["traced"] = _traced_window(pipe, requests, mix, kwargs, recorder, entries,
                                          work, built["f0_model"], method, device)
    t_check = time.perf_counter()
    if trace:
        result["work"] = {len(a): conversion_flops(a, config, mix["windows"])
                          for a in traffic.set}
    kept, shapes = recorder.kept, built["shapes"]
    del pipe, built, recorder, entries
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = compare(config, mix, seed, kept, shapes, device)
    traced = (" audio_s_per_s_main={main:.2f} audio_s_per_s_traced={traced:.2f}"
              .format(**serve.rates(result)) if trace else "")
    print(f"timing setup_s={setup_s:.3f} window_s={main['window_s']:.3f} "
          f"requests={len(main['latency_s'])} check_s={time.perf_counter() - t_check:.3f} "
          f"compared={result['checks']['compared']} "
          f"cudnn_tf32={cudnn_tf32}{_f0_frames_as_framed(config, mix['windows'])} "
          f"audio_s_per_s_by_quarter={serve._quarters(main)}{traced}", file=sys.stderr)
    return result


def _traced_window(pipe, requests, mix, kwargs, recorder, entries, work, f0_model, method,
                   device) -> dict:
    """A second window of ``trace_seconds`` under ``torch.profiler``, the
    layer ranges on; its chrome trace is read and deleted."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from .trace import summarize

    rf = torch.autograd.profiler.record_function
    opened, hooks = [], []
    for name, mod in ((f"bench.{method}", f0_model), ("bench.hubert", pipe.embedder),
                      ("bench.decoder", pipe.synthesizer.dec)):
        hooks.append(mod.register_forward_pre_hook(
            lambda *a, n=name: opened.append(rf(n).__enter__())))
        hooks.append(mod.register_forward_hook(
            lambda *a: opened.pop().__exit__(None, None, None)))
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    entries.on = True
    if work is not None:
        work.on = True
    with profile(activities=activities) as prof:
        with rf(serve.WINDOW_RANGE):
            traced = serve._serve(pipe, requests, mix["trace_seconds"], kwargs, recorder, device)
            if device.type == "cuda":
                torch.cuda.synchronize()
    entries.on = False
    for h in hooks:
        h.remove()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), "rvc_bench_trace.json")
    prof.export_chrome_trace(path)
    try:
        traced["summary"] = summarize(path, serve.WINDOW_RANGE, list(SCOPES))
    finally:
        os.remove(path)
    traced["bound_s"] = dict(entries.bound_s)
    if work is not None:
        work.on = False
        traced["bound_s"][CREPE_RANGE] = work.bound_s
    return traced


def _padded(audio: np.ndarray, win: dict):
    """(the high-passed input, its reflect-padded copy, its windows)."""
    hp = conversion.highpass(audio)
    pad = np.pad(hp, (16000 * win["x_pad"],) * 2, mode="reflect")
    return hp, pad, geometry.windows(len(pad), geometry.cut_points(hp, win), win)


def _salience(sd, config: dict, pad: np.ndarray, device) -> torch.Tensor:
    """The reference's salience of a whole padded input."""
    if "f0" in config:
        frames = crepe.frames_of(torch.from_numpy(pad).to(device), config["f0"]["hop"])
        return crepe.salience(sd["crepe"], frames, config["f0"], config["f0"]["batch_frames"])
    bucket = geometry.reflect_to(pad, conversion.bucket(len(pad)))
    x = torch.from_numpy(bucket)[None].to(device)
    return rmvpe.salience_of_audio(sd["rmvpe"], x, len(bucket) // 160 + 1, config["rmvpe"])[0]


def _shaped_f0(sal: torch.Tensor, config: dict, settings: dict, n_padded: int):
    """The whole input's (coarse, f0) from a salience: the decode, then the
    median filter, shift and quantisation over its ``p_len`` frames."""
    if "f0" in config:
        f0 = crepe.decode(sal, config["f0"]["fmin"], config["f0"]["fmax"])
    else:
        f0 = rmvpe.decode(sal)
    p_len = n_padded // 160
    f0 = torch.nn.functional.pad(f0[:p_len], (0, max(p_len - f0.shape[0], 0)))
    return conversion.shape_f0(f0, settings["pitch_shift"], settings["filter_radius"])


def _finish(outs: List[np.ndarray], config: dict, win: dict, plens: List[int]):
    """The windows' outputs, each cut to its frames and trimmed of its pads,
    joined and peak-normalised: (the waveform, each window's (start, end))."""
    upp = math.prod(config["synthesizer"]["upsample_rates"])
    trim = config["sample_rate"] * win["x_pad"]
    parts = [o[:p * upp][trim:-trim] for o, p in zip(outs, plens)]
    out = np.concatenate(parts)
    peak = np.abs(out).max() / 0.99 if out.size else 0.0
    ends = np.cumsum([len(p) for p in parts]).tolist()
    return (out / peak if peak > 1.0 else out).astype(np.float32), list(zip([0] + ends, ends))


@torch.no_grad()
def gaps(sd, index, config: dict, mix: dict, record: dict, device) -> Dict[str, float]:
    """The numbers that ``config``'s limits name, for one recorded
    conversion: the worst window of each."""
    names, s, win = config["limits"], mix["settings"], mix["windows"]
    req = record["req"]
    _, pad, segs = _padded(req.audio, win)
    if len(record["hubert"]) != len(segs) or len(record["synth_in"]) != len(segs):
        return {n: math.inf for n in names}
    out = {}
    sal_ref = _salience(sd, config, pad, device)
    with operand_precision("bf16"):
        sal_bf16 = _salience(sd, config, pad, device)
    sal_prog = torch.cat([t.to(device).float().reshape(-1, t.shape[-1])
                          for t in record["f0"]])[:sal_ref.shape[0]]
    out["salience_vs_bf16"] = (check.rel(sal_prog, sal_ref)
                               / max(check.rel(sal_bf16, sal_ref), 1e-12))
    coarse, f0 = _shaped_f0(sal_prog, config, s, len(pad))
    gen = torch.Generator(device=device).manual_seed(int(req.seed))
    feats_gap = synth_gap = 0.0
    outs, plens = [], []
    for (a, b, p0, p1), feats, args in zip(segs, record["hubert"], record["synth_in"]):
        x = torch.from_numpy(conversion.in_bucket(pad[a:b]))[None].to(device)
        feats = feats[0].to(device).float()
        feats_gap = max(feats_gap, check.rel(feats, hubert.features(sd["hubert"], x,
                                                                    config["hubert"])[0]))
        phone, lengths, pitch, pitchf, sid = (t.to(device) for t in args)
        want_phone, want_pitch, want_pitchf = geometry.window_inputs(
            feats, coarse[p0:p1], f0[p0:p1], index, s, b - a, x.shape[1])
        off = (pitch[0].long() - want_pitch).abs() > 1
        synth_gap = max(synth_gap, check.rel(phone[0], want_phone),
                        check.rel(pitchf[0], want_pitchf), float(off.double().mean()))
        audio = synth.infer(sd["synth"], phone, lengths, pitch.long(), pitchf.float(),
                            sid.long(), gen, check.synth_arch(config), config["sample_rate"])
        outs.append(audio[0].cpu().numpy())
        plens.append(conversion.p_len(b - a, x.shape[1]))
    want, spans = _finish(outs, config, win, plens)
    prog = np.asarray(record["out"])
    out["features_gap"], out["synth_inputs_gap"] = feats_gap, synth_gap
    out["output_gap"] = (max(check.rel(prog[i:j], want[i:j]) for i, j in spans)
                         if len(prog) == len(want) else math.inf)
    return {n: out[n] for n in names}


def compare(config: dict, mix: dict, seed: int, kept: dict, shapes, device) -> dict:
    """Worst gaps over the kept records, each beside its limit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = model_states(config, shapes, seed, device)
    index = weights.seeded_index(config["index"]["rows"], config["index"]["dim"], seed, device)
    worst = {n: 0.0 for n in config["limits"]}
    for i in sorted(kept):
        g = gaps(sd, index, config, mix, kept[i], device)
        worst = {n: max(worst[n], g[n]) for n in worst}
    return {"compared": len(kept),
            "gaps": {n: {"value": v, "limit": config["limits"][n]} for n, v in worst.items()}}


def reference_conversion(sd, index, config, mix, req, device, f0_precision="fp32",
                         precision="fp32") -> dict:
    """One windowed conversion by the reference, in the record layout of
    the program's recorder: its f0 network in ``f0_precision``, HuBERT,
    retrieval and the synthesizer in ``precision``."""
    s, win = mix["settings"], mix["windows"]
    _, pad, segs = _padded(req.audio, win)
    with operand_precision(f0_precision):
        sal = _salience(sd, config, pad, device)
    coarse, f0 = _shaped_f0(sal, config, s, len(pad))
    gen = torch.Generator(device=device).manual_seed(int(req.seed))
    record = {"req": req, "f0": [sal], "hubert": [], "synth_in": []}
    outs, plens = [], []
    with operand_precision(precision):
        for a, b, p0, p1 in segs:
            x = torch.from_numpy(conversion.in_bucket(pad[a:b]))[None].to(device)
            feats = hubert.features(sd["hubert"], x, config["hubert"])
            phone, pitch, pitchf = geometry.window_inputs(
                feats[0], coarse[p0:p1], f0[p0:p1], index, s, b - a, x.shape[1])
            plen = conversion.p_len(b - a, x.shape[1])
            args = [phone[None], torch.tensor([min(plen, phone.shape[0])], device=device),
                    pitch[None], pitchf[None], torch.tensor([s["sid"]], device=device)]
            audio = synth.infer(sd["synth"], *args, gen, check.synth_arch(config),
                                config["sample_rate"])
            record["hubert"].append(feats)
            record["synth_in"].append(args)
            outs.append(audio[0].cpu().numpy())
            plens.append(plen)
    record["out"] = _finish(outs, config, win, plens)[0]
    return record


def control_gaps(cell, seed: int, device, f0_precision: str = "bf16",
                 precision: str = "fp8") -> dict:
    """The worst gaps of the reference standing in for the program (its f0
    network in ``f0_precision``, the rest in ``precision``) over the
    requests a run of ``seed`` compares."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, mix = cell.config, cell.traffic
    sd = model_states(config, build_shapes(config), seed, device)
    index = weights.seeded_index(config["index"]["rows"], config["index"]["dim"], seed, device)
    traffic = Traffic(mix, seed)
    sample = traffic.check_sample()
    reqs, longest = [], None
    for req in traffic:
        if req.index >= mix["check"]["from_first"]:
            break
        if req.index in sample:
            reqs.append(req)
        if longest is None or len(req.audio) > len(longest.audio):
            longest = req
    if longest not in reqs:
        reqs.append(longest)
    worst = {n: 0.0 for n in config["limits"]}
    with torch.no_grad():
        for req in reqs:
            record = reference_conversion(sd, index, config, mix, req, device,
                                          f0_precision, precision)
            g = gaps(sd, index, config, mix, record, device)
            worst = {n: max(worst[n], g[n]) for n in worst}
    return {"seed": seed, "f0_precision": f0_precision, "precision": precision,
            "compared": len(reqs), "gaps": worst}


def reader_context(result: dict, config: dict) -> dict:
    """What the per-layer readers read, as ``serve.reader_context`` gives it,
    with this path's work: each request's model operations by its length."""
    main, traced, work = result["main"], result["traced"], result["work"]
    return {
        "trace": traced["summary"],
        "trace_audio_s": sum(traced["audio_s"]),
        "trace_model_flops": sum(work[n] for n in traced["samples"]),
        "bound_s": traced["bound_s"],
        "spans_s": result["spans_s"],
        "audio_s": sum(main["audio_s"]),
        "window_s": main["window_s"],
        "model_flops": sum(work[n] for n in main["samples"]),
        "peak_flops": flops.PEAK_FLOPS["bf16"],
    }


def _f0_frames_as_framed(config: dict, win: dict) -> str:
    """Whether every logged request's ``f0_frames`` is what its input's
    framing gives (CREPE: the padded input's samples // hop + 1; RMVPE: its
    bucket's frames to a multiple of 32), and the fewest windows a request
    was cut into; empty for a program without the counters."""
    from rvc_tpu_torch.utils import profiling

    records = [r for r in profiling.requests() if "f0_frames" in r["counters"]]
    if not records:
        return ""
    pads = 2 * 16000 * win["x_pad"]

    def framed(n):
        if "f0" in config:
            return (n + pads) // config["f0"]["hop"] + 1
        return -(-(conversion.bucket(n + pads) // 160 + 1) // 32) * 32

    ok = all(r["counters"]["f0_frames"] == framed(r["samples"]) for r in records)
    fewest = min(r["counters"].get("windows", 0) for r in records)
    return f" f0_frames_as_framed={ok} windows_fewest={fewest}"


def result(cell, res: dict, trace: bool, device_info: dict) -> dict:
    """The result line's object, as ``serve.result`` makes it, with this
    path's readers' context."""
    from . import spec

    main = res["main"]
    gaps_ = res["checks"]["gaps"]
    failed = main["failed"] + (res["traced"]["failed"] if trace else 0)
    attempted = len(main["latency_s"]) + (len(res["traced"]["latency_s"]) if trace else 0)
    correct = failed == 0 and res["checks"]["compared"] > 0 and all(
        g["value"] <= g["limit"] for g in gaps_.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        out["metrics"] = spec.read_metrics(cell.root, cell.per_layer,
                                           reader_context(res, cell.config))
        summary = res["traced"]["summary"]
        device_info = {**device_info, "busy_s": summary["busy_s"],
                       "window_s": summary["window_s"]}
    else:
        values = serve.metrics_e2e(res)
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
    out["device"] = device_info
    if trace:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        out["audio_s_per_s"] = serve.rates(res)
    out["checks"] = {n: {"value": g["value"], "limit": g["limit"]} for n, g in gaps_.items()}
    return out
