"""Chip smoke test of the PyTorch/CUDA port (``rvc_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in this order, each printing one JSON line:
  env      card name and power limit, torch / CUDA / nvcc / triton versions
  build    compile the CUDA kernels from ``rvc_tpu_torch/csrc`` (nvcc) and
           read ``ptxas -v``: registers and spills of every kernel, and no
           note that ``wgmma`` products were serialised (C7518-C7520)
  small    a small fp32 model on the card (kernels) against the same model
           on the CPU (plain versions)
  pipeline full-width 48 kHz bf16 conversion of 10 s of audio through
           ``Pipeline.pipeline`` (RMVPE + HuBERT + retrieval + NSF-HiFi-GAN,
           random weights from numpy seed 0): the warm-up run records the
           shapes the path gives each kernel, the next run the launch counts
  stream   ``voice_conversion_fused_stream`` over 4 requests, with the
           launch counts of that run
  kernels  hold each kernel against its plain PyTorch version at the shapes
           the pipeline recorded (bf16 and f32) and at shapes off the path
           (K1 in bf16 and f32 at batch 2, T = 1, 77, one tile +- 1, 9001,
           C = 16 and a padded C = 48, two chains with two dilations; K2 at
           C=512 and at a padded C=48; K3 at k=3 and at a compressed index),
           with stated tolerances, and time the kernel, the plain version
           and one library call
  stages   device time of each stage of one conversion (CUDA events)
  trace    (only when asked for) one conversion under torch.profiler:
           device busy time, idle share, the heaviest kernels

    python3 chip_smoke.py env,build,pipeline,kernels   # a subset of the phases
    python3 chip_smoke.py env,build,unit   # the kernel checks alone, at the
                                           # serving shapes, without the models
Then a ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
the result line. There is no CPU fallback: without CUDA the script fails.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s
PEAK_BF16 = 989e12         # dense bf16 tensor-core FLOP/s
PEAK_TF32 = 495e12         # dense tf32 tensor-core FLOP/s (3xTF32: 3 per f32 FLOP)
EXTRA_KNN_N = 10000        # a k-means-compressed index, checked beside the path's
# the kernels' shapes on the 48 kHz serving path, for the `unit` phase (the
# `kernels` phase takes them from the pipeline's own run)
UNIT_SHAPES = [("stage", 256, 19176, "bfloat16", (3, 7, 11), (1, 3, 5)),
               ("stage", 128, 191760, "bfloat16", (3, 7, 11), (1, 3, 5)),
               ("stage", 64, 383520, "bfloat16", (3, 7, 11), (1, 3, 5)),
               ("stage", 32, 767040, "bfloat16", (3, 7, 11), (1, 3, 5)),
               ("knn", 799, 65536, 768, 8)]
# off the path: (batch, C, T, kernel sizes, dilations) for K1 in bf16 and
# f32 (T = 1, 77, one output tile - 1 and + 1 at each width, an odd T near
# 9001; C = 48 runs padded to 64), (C, T, kernel size) for K2 in f32,
# (Q, N, D, k) for K3
EXTRA_STAGE_SHAPES = [
    (2, 128, 1, (3, 7, 11), (1, 3, 5)), (2, 64, 77, (3, 7, 11), (1, 3, 5)),
    (1, 128, 391, (3, 7, 11), (1, 3, 5)), (1, 128, 393, (3, 7, 11), (1, 3, 5)),
    (1, 64, 903, (3, 7, 11), (1, 3, 5)), (1, 64, 905, (3, 7, 11), (1, 3, 5)),
    (2, 32, 903, (3, 7, 11), (1, 3, 5)), (2, 32, 9001, (3, 7, 11), (1, 3, 5)),
    (2, 48, 9001, (3, 7), (1, 3)), (1, 16, 1929, (3, 7, 11), (1, 3, 5)),
    (2, 16, 9001, (3, 7), (1, 3))]
EXTRA_CHAIN_SHAPES = [(512, 4099, 7), (48, 3000, 11)]
EXTRA_KNN_SHAPES = [(799, EXTRA_KNN_N, 768, 8), (301, 5003, 256, 3)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def gpu_time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of one call, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = None
    try:
        from rvc_tpu_torch.ops._build import nvcc_path

        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True).stdout
        nvcc = [ln for ln in out.splitlines() if "release" in ln][-1].strip()
    except (RuntimeError, OSError, IndexError) as e:  # the build phase fails on it
        nvcc = f"unavailable: {e}"
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc, "triton": triton_version,
          "ninja_on_path": shutil.which("ninja") is not None,
          "device_count": torch.cuda.device_count()})
    return smi


def phase_build():
    from rvc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    seconds = time.perf_counter() - t0
    ptxas, serialised = {}, []
    for name in _build.SOURCES:
        log = _build.build_log(name)
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
        notes = collections.Counter(re.findall(r"C75\d\d", log))
        ptxas[name] = {"registers": regs, "spill_store_bytes": spills,
                       "notes": dict(notes)}
        # "Potential Performance Loss: wgmma.mma_async instructions are
        # serialized": C7518 and C7520 (C7519 only reports a fence the
        # compiler added where plain code writes the accumulators)
        serialised += [f"{name}.cu: {n}" for n in notes if n in ("C7518", "C7520")]
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas,
          "libraries": sorted(os.path.basename(p) for p in
                              os.listdir(_build.BUILD_DIR) if p.endswith(".so"))})
    require(not serialised, f"ptxas serialised wgmma products: {serialised}")


def _rand_chain(gen, c, k, device, dil):
    import torch

    def w():
        return (torch.randn((c, c, k), generator=gen) * (0.5 / (c * k) ** 0.5)).to(device)

    def b():
        return (torch.randn((c,), generator=gen) * 0.05).to(device)

    return [w() for _ in dil], [b() for _ in dil], [w() for _ in dil], [b() for _ in dil]


def _library_chain(x, chain, dil):
    """cuDNN conv chain in the input's own dtype (the yardstick)."""
    import torch.nn.functional as F

    y = x
    for d, w1, b1, w2, b2 in zip(dil, *chain):
        k = w1.shape[-1]
        a = F.leaky_relu(y, 0.1)
        m = F.conv1d(a, w1.to(x.dtype), b1.to(x.dtype), padding=(k * d - d) // 2,
                     dilation=d)
        y = y + F.conv1d(F.leaky_relu(m, 0.1), w2.to(x.dtype), b2.to(x.dtype),
                         padding=(k - 1) // 2)
    return y


def _err(ref, out):
    ref, out = ref.float(), out.float()
    abs_err = (ref - out).abs().max().item()
    return abs_err, abs_err / max(ref.abs().max().item(), 1e-12)


def record_path_shapes(fn):
    """Run fn() with the decoder's stage tails and the retrieval search
    wrapped to record the shapes the main path gives the kernels:
    [("stage", C, T, dtype, kernel sizes, dilations)] and
    [("knn", Q, N, D, k)]."""
    from rvc_tpu_torch.models.generators import nsf
    from rvc_tpu_torch.ops import retrieval as rt

    shapes = []
    stage, knn = nsf._resblock_stage, rt.knn_topk

    def stage_hook(x, blocks, cache=None):
        shapes.append(("stage", x.shape[1], x.shape[2], x.dtype,
                       tuple(blk.kernel_size for blk in blocks),
                       tuple(blocks[0].dilations)))
        return stage(x, blocks, cache)

    def knn_hook(q, v, k=8):
        shapes.append(("knn", q.shape[0], v.shape[0], q.shape[1], k))
        return knn(q, v, k)

    nsf._resblock_stage, rt.knn_topk = stage_hook, knn_hook
    try:
        fn()
    finally:
        nsf._resblock_stage, rt.knn_topk = stage, knn
    return shapes


def phase_kernels(shapes):
    """K1/K2/K3 against their plain versions at the shapes the main path
    gave them (``shapes`` from record_path_shapes), in the path's dtype and
    in f32, then at the shapes off the path. The wrappers get a weight
    cache, as the modules give them, so the times are the kernels'. Returns
    per-kernel records summed over the path's launches."""
    import torch

    from rvc_tpu_torch.models.generators.nsf import MRF_MAX_CHANNELS
    from rvc_tpu_torch.ops import resblock as rb
    from rvc_tpu_torch.ops import retrieval as rt

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rec = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": 0.0}
           for n in ("mrf_stage", "resblock_chain", "knn_topk")}

    def bound(nbytes, flops_by_peak):
        """(bound ms, bytes ms, operations ms): bytes over the memory rate,
        FLOP over the peak of the unit that does them."""
        b_ms = 1e3 * nbytes / PEAK_BYTES
        o_ms = 1e3 * sum(f / p for f, p in flops_by_peak)
        return max(b_ms, o_ms), b_ms, o_ms

    def check(name, key, fn, plain, lib, ref_out, tol, bnd, on_path):
        out = fn()
        ref = ref_out()
        torch.cuda.synchronize()
        abs_err, rel = _err(ref, out)
        row = {"kernel": name, **key, "max_abs_err": abs_err, "rel_err": rel,
               "tol": tol, "ms": gpu_time_ms(fn), "plain_ms": gpu_time_ms(plain, 3),
               "library_ms": gpu_time_ms(lib, 3), "bound_ms": bnd[0],
               "bound_by": "operations" if bnd[2] >= bnd[1] else "bytes",
               "on_path": on_path}
        emit({"phase": "kernel_check", **row})
        require(rel <= tol, f"{name} {key}: rel err {rel} > {tol}")
        if on_path:  # one of the main path's launches: sum into the record
            r = rec[name]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            for f in ("ms", "plain_ms", "library_ms"):
                r[f] += row[f]
            r["bound_ms"] += bnd[0]
            r["bytes_ms"] += bnd[1]
            r["ops_ms"] += bnd[2]

    for kind, *shape in shapes:
        if kind != "stage":
            continue
        c, t, path_dtype, ks, dil = shape
        path_dtype = getattr(torch, path_dtype) if isinstance(path_dtype, str) \
            else path_dtype
        chains = [_rand_chain(gen, c, k, dev, dil) for k in ks]
        caches = [rb.WeightCache() for _ in range(len(ks) + 1)]
        x32 = (torch.randn((1, c, t), generator=gen) * 0.3).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            nbytes = 2 * x.numel() * x.element_size()
            key = {"C": c, "T": t, "dtype": str(dtype).split(".")[-1]}
            on_path = dtype == path_dtype
            if c <= MRF_MAX_CHANNELS:  # K1: all chains in one launch
                flops = 2.0 * sum(2 * len(dil) * k * c * c * t for k in ks)
                peak = [(flops, PEAK_BF16)] if dtype == torch.bfloat16 else \
                    [(3 * flops, PEAK_TF32)]
                nbytes += sum(2 * len(dil) * k * c * c for k in ks) * (
                    2 if dtype == torch.bfloat16 else 4)
                check("mrf_stage", key,
                      lambda: rb.mrf_stage(x, chains, ks, dil, cache=caches[-1]),
                      lambda: rb.mrf_stage_plain(x, chains, dil),
                      lambda: [_library_chain(x, ch, dil) for ch in chains],
                      lambda: rb.mrf_stage_plain(x, chains, dil),
                      2e-2 if dtype == torch.bfloat16 else 1e-4,
                      bound(nbytes, peak), on_path)
            else:  # K2: two conv launches per dilation of each chain
                for k, ch, cache in zip(ks, chains, caches):
                    flops = 2.0 * 2 * len(dil) * k * c * c * t
                    check("resblock_chain", {**key, "K": k},
                          lambda: rb.resblock_chain(x, *ch, dil, cache=cache),
                          lambda: rb.resblock_chain_plain(x, *ch, dil),
                          lambda: _library_chain(x.float(), ch, dil),
                          lambda: rb.resblock_chain_plain(x, *ch, dil),
                          2e-2 if dtype == torch.bfloat16 else 1e-4,
                          bound(nbytes + 4 * 2 * len(dil) * k * c * c,
                                [(3 * flops, PEAK_TF32)]), on_path)
        del chains, x32

    for b, c, t, ks, dil in EXTRA_STAGE_SHAPES:  # K1 off the path
        chains = [_rand_chain(gen, c, k, dev, dil) for k in ks]
        x32 = (torch.randn((b, c, t), generator=gen) * 0.3).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x, cache = x32.to(dtype), rb.WeightCache()
            flops = 2.0 * sum(2 * len(dil) * k * c * c * t * b for k in ks)
            wbytes = sum(2 * len(dil) * k * c * c for k in ks) * x.element_size()
            check("mrf_stage", {"B": b, "C": c, "T": t, "ks": list(ks),
                                "dil": list(dil), "dtype": str(dtype).split(".")[-1]},
                  lambda: rb.mrf_stage(x, chains, ks, dil, cache=cache),
                  lambda: rb.mrf_stage_plain(x, chains, dil),
                  lambda: [_library_chain(x, ch, dil) for ch in chains],
                  lambda: rb.mrf_stage_plain(x, chains, dil),
                  2e-2 if dtype == torch.bfloat16 else 1e-4,
                  bound(2 * x.numel() * x.element_size() + wbytes,
                        [(flops, PEAK_BF16)] if dtype == torch.bfloat16
                        else [(3 * flops, PEAK_TF32)]), False)
        del chains, x32

    dil = (1, 3, 5)
    for c, t, k in EXTRA_CHAIN_SHAPES:  # K2 off the path, f32
        ch = _rand_chain(gen, c, k, dev, dil)
        x = (torch.randn((1, c, t), generator=gen) * 0.3).to(dev)
        cache = rb.WeightCache()
        check("resblock_chain", {"C": c, "T": t, "dtype": "float32", "K": k},
              lambda: rb.resblock_chain(x, *ch, dil, cache=cache),
              lambda: rb.resblock_chain_plain(x, *ch, dil),
              lambda: _library_chain(x, ch, dil),
              lambda: rb.resblock_chain_plain(x, *ch, dil), 1e-4,
              bound(8 * x.numel() + 4 * 2 * len(dil) * k * c * c,
                    [(3 * 2.0 * 2 * len(dil) * k * c * c * t, PEAK_TF32)]), False)
        del ch, x

    knn_shapes = [tuple(s[1:]) for s in shapes if s[0] == "knn"]
    require(knn_shapes, "the main path made no retrieval search")
    for n_q, n_v, d, k in knn_shapes + EXTRA_KNN_SHAPES:
        q = torch.randn((n_q, d), generator=gen).to(dev)
        v = torch.randn((n_v, d), generator=gen).to(dev)
        dist, idx = rt.knn_topk(q, v, k)
        ref_d, ref_i = rt.knn_search_plain(q, v, k + 1)
        gap = (ref_d[:, k] - ref_d[:, k - 1]) / ref_d[:, k].abs().clamp(min=1e-12)
        clear = gap > 1e-3
        same = (torch.sort(idx, dim=1).values
                == torch.sort(ref_i[:, :k], dim=1).values).all(dim=1)
        bad_rows = int((clear & ~same).sum().item())
        key = {"Q": n_q, "N": n_v, "D": d, "k": k,
               "rows_with_clear_gap": int(clear.sum().item()),
               "index_mismatch_rows": bad_rows}
        check("knn_topk", key, lambda: rt.knn_topk(q, v, k)[0],
              lambda: rt.knn_search_plain(q, v, k)[0],
              lambda: torch.topk(torch.cdist(q, v), k, dim=1, largest=False),
              lambda: ref_d[:, :k], 1e-4,
              bound(4 * (n_q * d + n_v * d) + 12 * n_q * k,
                    [(3 * 2.0 * n_q * n_v * d, PEAK_TF32)]),
              (n_q, n_v, d, k) in knn_shapes)
        require(bad_rows == 0, f"knn_topk N={n_v}: {bad_rows} rows with other indices")
        del q, v
    torch.cuda.empty_cache()
    for r in rec.values():
        r["bound_by"] = "operations" if r.pop("ops_ms") >= r.pop("bytes_ms") else "bytes"
    return rec


def _fill_random(module, rng, scale=0.02):
    """Seeded normal weights (numpy default_rng, scale 0.02, as the JAX
    bench's random init); batch-norm running variances are set to 1 so the
    normalization stays finite."""
    import torch

    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not torch.is_floating_point(t):
                continue
            if name.endswith("running_var"):
                t.fill_(1.0)
            else:
                t.copy_(torch.from_numpy(
                    rng.normal(size=tuple(t.shape), scale=scale).astype(np.float32)))


def _build_models(device, tiny: bool, rng):
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.embedders.hubert import Hubert, HubertConfig
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.predictors.rmvpe import RMVPE, E2EModel

    cfg = get_config(48000)
    if tiny:
        synth = Synthesizer.from_config(
            cfg, device=device, inter_channels=8, hidden_channels=8,
            filter_channels=16, n_layers=2, resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 3)), upsample_initial_channel=64,
            spk_embed_dim=4, gin_channels=8, flow_layers=2, zero_noise=True)
        hub = Hubert.build(HubertConfig(
            hidden_size=768, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4), device=device)
        e2e = E2EModel(n_blocks=1, en_de_layers=2, inter_layers=1,
                       en_out_channels=4, gru_hidden=16)
    else:
        synth = Synthesizer.from_config(cfg, device=device)
        hub = Hubert.build(HubertConfig(), device=device)
        e2e = E2EModel()
    rmvpe = RMVPE(e2e, device=device)
    for m in (synth, hub, rmvpe.model):
        _fill_random(m, rng, 0.1 if tiny else 0.02)
    return cfg, synth, hub, rmvpe


def _audio(seconds: float, rng):
    t16 = int(seconds * 16000)
    tt = np.arange(t16) / 16000
    return (0.4 * np.sin(2 * np.pi * 220 * tt)
            + 0.05 * rng.normal(size=t16)).astype(np.float32)


def _reset_counts():
    from rvc_tpu_torch.ops import resblock as rb
    from rvc_tpu_torch.ops import retrieval as rt

    rb.reset_launches()
    rt.reset_launches()


def _counts():
    from rvc_tpu_torch.ops import resblock as rb
    from rvc_tpu_torch.ops import retrieval as rt

    return {**rb.launches, **rt.launches}


def phase_small_reference():
    """A small fp32 model on the card (kernels) against the same model on
    the CPU (plain versions, held against the JAX package by the tests)."""
    import torch

    from rvc_tpu_torch.infer.pipeline import Pipeline, PipelineConfig

    outs = {}
    for device in ("cpu", "cuda"):
        rng = np.random.default_rng(1)
        cfg, synth, hub, rmvpe = _build_models(device, True, rng)
        pipe = Pipeline(48000, synth, hub, PipelineConfig(x_pad=1),
                        upsample_factor=cfg.upsample_factor, precision="fp32",
                        device=device)
        pipe.set_rmvpe(rmvpe)
        index = rng.normal(size=(3000, 768)).astype(np.float32)
        audio = _audio(2.0, np.random.default_rng(2))
        _reset_counts()
        outs[device] = pipe.pipeline(audio, sid=1, pitch_shift=2,
                                     index_vectors=index, index_rate=0.75,
                                     protect=0.33, filter_radius=3,
                                     generator=torch.Generator(device).manual_seed(0))
        counts = _counts()
    err = float(np.abs(outs["cpu"] - outs["cuda"]).max())
    emit({"phase": "small_reference", "samples": len(outs["cuda"]),
          "max_abs_err_vs_cpu_plain": err, "tol": 1e-3, "launches": counts})
    require(outs["cpu"].shape == outs["cuda"].shape, "small model: shapes differ")
    require(err <= 1e-3, f"small model: card vs CPU plain max abs err {err} > 1e-3")
    # an fp32 model: its stage tails keep f32 precision through K2's kernel
    require(counts["resblock_chain"] > 0 and counts["knn_topk"] > 0,
            "small model: kernels not launched")


def _weight_cache_builds(decoder) -> int:
    """How often the decoder's stage tails have folded or packed weights:
    the builds of every weight cache on its ResBlocks and stages."""
    return (sum(blk._folded.builds + blk.packed.builds for blk in decoder.resblocks)
            + sum(c.builds for c in decoder._stage_caches))


def _segment_len(pipe, n16: int) -> int:
    """Output samples of one fused conversion of n16 input samples."""
    return pipe._p_len(n16, pipe._bucket_len(n16)) * pipe.upp


def phase_pipeline(smi: str):
    import torch

    from rvc_tpu_torch.infer.pipeline import Pipeline, PipelineConfig

    rng = np.random.default_rng(0)
    cfg, synth, hub, rmvpe = _build_models("cuda", False, rng)
    pipe = Pipeline(48000, synth, hub, PipelineConfig(),
                    upsample_factor=cfg.upsample_factor, precision="bf16",
                    device="cuda")
    pipe.set_rmvpe(rmvpe)
    index = torch.from_numpy(
        rng.normal(size=(65536, 768)).astype(np.float32)).cuda()
    audio = _audio(10.0, rng)
    kwargs = dict(sid=0, pitch_shift=2, f0_method="rmvpe", index_vectors=index,
                  index_rate=0.75, protect=0.33, filter_radius=3)

    def run():
        out = pipe.pipeline(audio, generator=torch.Generator("cuda").manual_seed(0),
                            **kwargs)
        torch.cuda.synchronize()
        return out

    shapes = record_path_shapes(run)  # warm-up, and the kernels' shapes
    builds = _weight_cache_builds(synth.dec)
    _reset_counts()
    out = run()
    counts = _counts()
    # the second conversion folds, pads and packs no stage-tail weights
    require(builds > 0 and _weight_cache_builds(synth.dec) == builds,
            f"weight caches rebuilt on a second conversion: {builds} -> "
            f"{_weight_cache_builds(synth.dec)}")
    # 10 s padded by 3 s a side: HuBERT gives 799 frames of the 16 s bucket,
    # so 1598 latent frames (not 1600) and 479040 samples, as the JAX
    # pipeline's _p_len gives
    expect = _segment_len(pipe, audio.shape[0] + 2 * pipe.t_pad) - 2 * pipe.t_pad_tgt
    require(out.shape == (expect,), f"pipeline output shape {out.shape} != ({expect},)")
    require(bool(np.isfinite(out).all()), "pipeline output not finite")
    require(float(np.abs(out).max()) <= 1.0, "pipeline output exceeds |x| <= 1")
    for name, n in counts.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    emit({"phase": "pipeline", "gpu": smi, "samples": int(out.shape[0]),
          "peak_abs": float(np.abs(out).max()), "launches": counts,
          "weight_cache_builds": builds,
          "wall_s_per_conversion": wall, "wall_s_all": walls,
          "realtime_factor": 10.0 / wall,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "kernel_shapes": [[str(v) if isinstance(v, torch.dtype) else v for v in sh]
                            for sh in shapes]})
    return pipe, audio, index, counts, run, shapes


def phase_stream(pipe, audio, index, smi: str):
    import torch

    audio_pad = np.pad(pipe._highpass(audio), (pipe.t_pad, pipe.t_pad),
                       mode="reflect")
    segs = [audio_pad] * 4
    kw = dict(sid=0, index_vectors=index, index_rate=0.75, protect=0.33,
              pitch_shift=2, filter_radius=3)
    pipe.voice_conversion_fused_stream(segs[:1], **kw)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    outs = pipe.voice_conversion_fused_stream(segs, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    for name, n in counts.items():
        require(n > 0, f"kernel {name} was not launched on the stream path")
    expect = _segment_len(pipe, audio_pad.shape[0])
    require(len(outs) == 4, f"stream returned {len(outs)} outputs")
    for o in outs:
        require(o.shape == (expect,), f"stream output {o.shape} != ({expect},)")
        require(bool(np.isfinite(o).all()), "stream output not finite")
    emit({"phase": "stream", "gpu": smi, "requests": 4, "launches": counts,
          "ms_per_request": 1e3 * wall / 4, "samples_each": expect})


def phase_stages(pipe, audio, index, smi: str):
    """Device time of each stage of one conversion at the serving shapes
    (CUDA events, median of 3 after a warm-up)."""
    import torch

    from rvc_tpu_torch.ops.retrieval import retrieve_blend
    from rvc_tpu_torch.predictors.rmvpe import rmvpe_mel

    dev, dt = pipe.device, pipe.dtype
    n16 = pipe._bucket_len(audio.shape[0] + 2 * pipe.t_pad)
    f0_frames = n16 // 160 + 1
    wave = torch.from_numpy(_audio(n16 / 16000, np.random.default_rng(3))).to(dev)[None]
    mel = rmvpe_mel(wave)[:, :f0_frames]
    mel = torch.nn.functional.pad(mel.transpose(1, 2), (0, (-f0_frames) % 32),
                                  mode="reflect").transpose(1, 2).to(dt)
    feats = pipe.embedder(wave.to(dt)).float()
    q = feats[0].contiguous()
    frames = 2 * feats.shape[1]
    phone = torch.repeat_interleave(feats, 2, dim=1)
    lengths = torch.tensor([frames], device=dev)
    pitch = torch.full((1, frames), 100, dtype=torch.int64, device=dev)
    pitchf = torch.full((1, frames), 220.0, device=dev)
    sid = torch.tensor([0], device=dev)
    synth = pipe.synthesizer
    z = torch.randn((1, synth.dec.conv_pre.weight.shape[1], frames),
                    generator=torch.Generator(dev).manual_seed(0), device=dev).to(dt)
    g = synth.emb_g(sid)[:, :, None]
    with torch.no_grad():
        stages = {
            "rmvpe_mel": lambda: rmvpe_mel(wave),
            "rmvpe_model": lambda: pipe._rmvpe.model(mel),
            "hubert": lambda: pipe.embedder(wave.to(dt)),
            "retrieval": lambda: retrieve_blend(q, index, 0.75),
            "synth_infer": lambda: synth.infer(phone, lengths, pitch, pitchf, sid),
            "decoder": lambda: synth.dec(z, pitchf, g=g),
        }
        ms = {name: gpu_time_ms(fn, 3) for name, fn in stages.items()}
    emit({"phase": "stages", "gpu": smi, "f0_frames": f0_frames,
          "hubert_frames": int(feats.shape[1]), "ms": ms})


def phase_trace(run, smi: str):
    """One conversion under torch.profiler: device busy time, idle share
    and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(
            e, "self_cuda_time_total", 0)

    # device-side events only: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:25]
    emit({"phase": "trace", "gpu": smi, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "idle_share": 1.0 - busy_ms / wall_ms,
          "top": [{"name": e.key[:90], "ms": dev_us(e) / 1e3, "count": e.count}
                  for e in top]})


KERNEL_META = {
    "mrf_stage": ("rvc_tpu_torch/csrc/resblock.cu", "rvc_tpu/ops/resblock_pallas.py:437"),
    "resblock_chain": ("rvc_tpu_torch/csrc/resblock_chain.cu",
                       "rvc_tpu/ops/resblock_pallas.py:239"),
    "knn_topk": ("rvc_tpu_torch/csrc/knn.cu", "rvc_tpu/ops/retrieval_pallas.py:125"),
}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card only",
              file=sys.stderr)
        return 2
    phases = argv[1].split(",") if len(argv) > 1 else [
        "env", "build", "small", "pipeline", "stream", "kernels", "stages"]
    sys.path.insert(0, REPO)
    import rvc_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase_env()
    if "build" in phases:
        phase_build()
    if "small" in phases:
        phase_small_reference()
    counts, rec = {}, {}
    if "unit" in phases:
        phase_kernels(UNIT_SHAPES)
    if "pipeline" in phases:
        pipe, audio, index, counts, run, shapes = phase_pipeline(smi)
        if "stream" in phases:
            phase_stream(pipe, audio, index, smi)
        if "kernels" in phases:  # at the shapes the main path gave the kernels
            rec = phase_kernels(shapes)
        if "stages" in phases:
            phase_stages(pipe, audio, index, smi)
        if "trace" in phases:
            phase_trace(run, smi)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts.get(name, 0), **rec.get(name, {})}
        for name, (src, rep) in KERNEL_META.items()], "gpu": smi})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
