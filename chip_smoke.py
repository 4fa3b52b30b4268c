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
  files    write the user's files in the reference formats from numpy seed 0
           (a full-width 48 kHz .pth with pitch and one without, a 65536 x 768
           flat faiss .index, models/predictors/rmvpe.pt, an HF-layout
           models/embedders/contentvec) into a temporary directory, and read
           them back through the port's loaders
  windowed ``python -m rvc_tpu_torch.cli infer`` in-process on 150 s read from
           a 44.1 kHz stereo WAV: three windows, host f0, wall, realtime
           factor, device time per window, peak memory
  batch    ``batch_infer`` on four files (3, 5, 8, 11 s): one device batch of
           four rows; against the same files one by one; a small fp32 model's
           batch on the card against the CPU's plain versions
  nof0     ``infer`` with the model without pitch (plain HiFi-GAN decoder)
  train    ``train`` at full width (bf16, batch 8, 3 epochs, a resume to 4),
           per-step losses, K1/K2 launches and gradients, then a conversion
           with the exported model
  prep     the dataset path through the CLI: a 10-minute 44.1 kHz dataset
           (16-bit stereo and float mono takes, one rejected) through
           ``preprocess`` (effects, noise reduction), ``extract`` (rmvpe,
           batch 8), one epoch of ``train`` and its index (in a process
           of its own, with the defaults, then with cuDNN's autotuning
           off), ``index
           --index_algorithm KMeans --export_faiss`` (K3 assigns at k = 1),
           ``infer`` of 10 s with that model and index; ``build_index`` on
           360 000 x 768 features (25 k-means iterations to 10 000
           centroids); ``infer`` with crepe, crepe-tiny, fcpe, yin and
           hybrid[rmvpe+fcpe]; then K3's ms per assignment against its bound
           and cdist + argmin, and each f0 predictor on the card against the
           CPU in float32
  zoo      the rest of the model zoo at full width: 10 s through the CLI's
           ``infer`` with NSF HiFi-GAN at 32 and 40 kHz, MRF HiFi-GAN at
           40 kHz and RefineGAN at 32 kHz (deployable .pth files in the
           reference layout of each), each then warm through one
           ``VoiceConverter`` (wall, decoder time, no weight cache rebuilt);
           small fp32 MRF HiFi-GAN and RefineGAN models on the card against
           the CPU; every discriminator family of the registry in training
           steps with the 48 kHz generator (bf16, batch 8); ``train`` with
           MRF HiFi-GAN at 40 kHz (mpd,mrd; 1 epoch, a resume to 2) and
           RefineGAN at 32 kHz (mpd,mssbcqt; 1 epoch), each trained model
           converting 10 s
  fx       the rest of the user's CLI: ``infer`` of 10 s with formant
           shifting, ``--clean_audio``, all ten effects and FLAC export
           (read back equal to the WAV); ``batch_infer`` of the four
           `batch` files with the chain on (one device batch; each output
           the chain on its row); the chain, formant and the gate on the
           card against the CPU; each effect's ms, the chain's, formant's
           and the gate's on the card and on the host's CPU; the warm
           converter's wall with and without everything on;
           ``model_blender`` with a second full-width seed,
           ``model_information``, a conversion with the blend,
           ``audio_analyzer``, ``check_environment``
  dist     multi-card training and sharded serving on the one card:
           ``parallel.launch`` at world 1 with NCCL (three full-width bf16
           steps, batch 8) against the same steps without a process group;
           two gloo ranks on the card (4 rows each, the ranks' mask sums
           differing) against one process's batch of 8, the ranks' weights
           equal bit for bit (correctness only: two ranks share the card);
           ``enable_batch_sharding(["cuda:0", "cuda:0"])`` on the `batch`
           files, four rows and three, against the unsharded batch
  ui       the web UI (``rvc_tpu_torch.ui.app.build_app("cuda")``, the
           stdlib renderer) on a free port, driven over ``POST
           /api/<eid>``: a 10 s conversion against ``cli infer``, the batch
           event, the blender, model information, the analyzer, the f0
           curve, TTS (offline synthesizer) then conversion, the
           drop-install of a zip, one training epoch on the `prep` filelist
           and the index button (K3 at k = 1); the download server's GET
           and POST
  kernels  hold each kernel against its plain PyTorch version at the shapes
           every path recorded (every stage tail, and every chain run on its
           own, at its leaky slope, RefineGAN's 0.2 too; forward, and at the
           training shapes gradient; bf16 and f32: T up to 3.2 M, batch 4;
           K3 at 360 000 x 10 000 x 768 in three 16 384-row chunks) and at
           shapes off the path
           (K1 in bf16 and f32 at batch 2, T = 1, 77, one tile +- 1, 9001,
           C = 16 and a padded C = 48, two chains with two dilations; K2 at
           C=512 and at a padded C=48; K3 at k=3 and at a compressed index),
           with stated tolerances, and time the kernel, the plain version
           and one library call
  stages   device time of each stage of one conversion (CUDA events)
  trace    (only when asked for) one conversion under torch.profiler:
           device busy time, idle share, the heaviest kernels

    python3 chip_smoke.py env,build,pipeline,kernels   # a subset of the phases
    python3 chip_smoke.py env,build,files,fx,kernels   # the output effects
    python3 chip_smoke.py env,build,files,batch,prep,dist,ui,kernels  # A.13, A.16
    python3 chip_smoke.py env,build,unit   # the kernel checks alone, at the
                                           # serving shapes, without the models
Then a ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
the result line. There is no CPU fallback: without CUDA the script fails.
"""

from __future__ import annotations

import collections
import gc
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# K3 shapes with more [Q, N] distances than this are checked in chunks of
# KNN_CHECK_ROWS queries
KNN_DENSE_ELEMS = 1 << 30
KNN_CHECK_ROWS = 16384


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


def _library_chain(x, chain, dil, slope=0.1):
    """cuDNN conv chain in the input's own dtype (the yardstick)."""
    import torch.nn.functional as F

    y = x
    for d, w1, b1, w2, b2 in zip(dil, *chain):
        k = w1.shape[-1]
        a = F.leaky_relu(y, slope)
        m = F.conv1d(a, w1.to(x.dtype), b1.to(x.dtype), padding=(k * d - d) // 2,
                     dilation=d)
        y = y + F.conv1d(F.leaky_relu(m, slope), w2.to(x.dtype), b2.to(x.dtype),
                         padding=(k - 1) // 2)
    return y


def _err(ref, out):
    ref, out = ref.float(), out.float()
    abs_err = (ref - out).abs().max().item()
    return abs_err, abs_err / max(ref.abs().max().item(), 1e-12)


def record_path_shapes(fn, grad_shapes=None):
    """Run fn() with the decoders' stage tails and the retrieval search
    wrapped to record the shapes the main path gives the kernels:
    [("stage", C, T, dtype, kernel sizes, dilations, batch, slope)] for a
    stage tail (``nsf._resblock_stage``: the NSF, plain and MRF HiFi-GAN
    decoders), [("chain", C, T, dtype, (K,), dilations, batch, slope)] for
    a chain run on its own (``ChainBlock.forward`` outside a stage tail:
    RefineGAN's), and [("knn", Q, N, D, k)]. Shapes met with gradients on
    (a training step's) are also appended to ``grad_shapes`` when given."""
    import torch

    from rvc_tpu_torch.models import commons
    from rvc_tpu_torch.models.generators import nsf
    from rvc_tpu_torch.ops import retrieval as rt

    shapes, in_stage = [], []
    stage, chain, knn = nsf._resblock_stage, commons.ChainBlock.forward, rt.knn_topk

    def record(sh):
        shapes.append(sh)
        if grad_shapes is not None and torch.is_grad_enabled():
            grad_shapes.append(sh)

    def stage_hook(x, blocks, cache=None):
        record(("stage", x.shape[1], x.shape[2], x.dtype,
                tuple(blk.kernel_size for blk in blocks),
                tuple(blocks[0].dilations), x.shape[0], blocks[0].slope))
        in_stage.append(1)
        try:
            return stage(x, blocks, cache)
        finally:
            in_stage.pop()

    def chain_hook(blk, x):
        if not in_stage:
            record(("chain", x.shape[1], x.shape[2], x.dtype, (blk.kernel_size,),
                    tuple(blk.dilations), x.shape[0], blk.slope))
        return chain(blk, x)

    def knn_hook(q, v, k=8):
        shapes.append(("knn", q.shape[0], v.shape[0], q.shape[1], k))
        return knn(q, v, k)

    nsf._resblock_stage, commons.ChainBlock.forward, rt.knn_topk = (
        stage_hook, chain_hook, knn_hook)
    try:
        fn()
    finally:
        nsf._resblock_stage, commons.ChainBlock.forward, rt.knn_topk = stage, chain, knn
    return shapes


def _shape_key(shape):
    """A recorded shape as a hashable key, dtype by name, batch 1 and slope
    0.1 if absent."""
    if shape[0] in ("stage", "chain"):
        kind, c, t, dtype, ks, dil, *rest = shape
        b, slope = (list(rest) + [1, 0.1][len(rest):])[:2]
        return (kind, c, t, str(dtype).split(".")[-1], tuple(ks), tuple(dil), b,
                float(slope))
    return tuple(shape)


def bound(nbytes, flops_by_peak):
    """(bound ms, bytes ms, operations ms): bytes over the memory rate,
    FLOP over the peak of the unit that does them."""
    b_ms = 1e3 * nbytes / PEAK_BYTES
    o_ms = 1e3 * sum(f / p for f, p in flops_by_peak)
    return max(b_ms, o_ms), b_ms, o_ms


def phase_kernels(paths, grad_uses=None):
    """K1/K2/K3 against their plain versions at the shapes each path gave
    them (``paths``: path name -> shapes from record_path_shapes; a shape
    that several paths or launches share is checked once), in the path's
    dtype and in f32, then at the shapes off the path. The wrappers get a
    weight cache, as the modules give them, so the times are the kernels'.
    Returns per-path, per-kernel records summed over each path's launches.
    ``grad_uses`` (shape key -> {training run: calls per step of that
    run}) adds the gradient checks of ``phase_kernel_grads``."""
    import torch

    from rvc_tpu_torch.models.generators.nsf import MRF_MAX_CHANNELS
    from rvc_tpu_torch.ops import resblock as rb
    from rvc_tpu_torch.ops import retrieval as rt

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    uses = {}  # shape key -> launches of that shape per path
    for path, shapes in paths.items():
        for sh in shapes:
            uses.setdefault(_shape_key(sh), collections.Counter())[path] += 1
    rec = {path: {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                      "library_ms": 0.0}
                  for n in ("mrf_stage", "resblock_chain", "knn_topk")}
           for path in paths}

    def check(name, key, fn, plain, lib, ref_out, tol, bnd, on_paths, timed=None,
              extra=None):
        out = fn()
        ref = ref_out()
        torch.cuda.synchronize()
        abs_err, rel = _err(ref, out)
        row = {"kernel": name, **key, "max_abs_err": abs_err, "rel_err": rel,
               "tol": tol, "ms": gpu_time_ms(timed or fn), "plain_ms": gpu_time_ms(plain, 3),
               "library_ms": gpu_time_ms(lib, 3), "bound_ms": bnd[0],
               "bound_by": "operations" if bnd[2] >= bnd[1] else "bytes",
               "on_path": dict(on_paths),
               **{k: gpu_time_ms(f, 3) for k, f in (extra or {}).items()}}
        emit({"phase": "kernel_check", **row})
        require(rel <= tol, f"{name} {key}: rel err {rel} > {tol}")
        for path, n in on_paths.items():  # the paths' launches: sum into them
            r = rec[path][name]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            for f in ("ms", "plain_ms", "library_ms", "cudnn_bf16_ms"):
                if f in row:
                    r[f] = r.get(f, 0.0) + n * row[f]
            for f, v in zip(("bound_ms", "bytes_ms", "ops_ms"), bnd):
                r[f] += n * v

    for key, counts in uses.items():
        if key[0] not in ("stage", "chain"):
            continue
        kind, c, t, path_dtype, ks, dil, b, slope = key
        chains = [_rand_chain(gen, c, k, dev, dil) for k in ks]
        caches = [rb.WeightCache() for _ in range(len(ks) + 1)]
        x32 = (torch.randn((b, c, t), generator=gen) * 0.3).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            nbytes = 2 * x.numel() * x.element_size()
            dname = str(dtype).split(".")[-1]
            key_row = {"B": b, "C": c, "T": t, "dtype": dname, "slope": slope}
            on_paths = counts if dname == path_dtype else {}
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
            if kind == "stage" and c <= MRF_MAX_CHANNELS:  # K1: one launch
                flops = 2.0 * b * sum(2 * len(dil) * k * c * c * t for k in ks)
                peak = [(flops, PEAK_BF16)] if dtype == torch.bfloat16 else \
                    [(3 * flops, PEAK_TF32)]
                nbytes += sum(2 * len(dil) * k * c * c for k in ks) * (
                    2 if dtype == torch.bfloat16 else 4)
                check("mrf_stage", key_row,
                      lambda: rb.mrf_stage(x, chains, ks, dil, slope, cache=caches[-1]),
                      lambda: rb.mrf_stage_plain(x, chains, dil, slope),
                      lambda: [_library_chain(x, ch, dil, slope) for ch in chains],
                      lambda: rb.mrf_stage_plain(x, chains, dil, slope),
                      tol, bound(nbytes, peak), on_paths)
            else:  # K2: two conv launches per dilation of each chain
                for k, ch, cache in zip(ks, chains, caches):
                    flops = 2.0 * 2 * len(dil) * k * c * c * t * b
                    check("resblock_chain", {**key_row, "K": k},
                          lambda: rb.resblock_chain(x, *ch, dil, slope, cache=cache),
                          lambda: rb.resblock_chain_plain(x, *ch, dil, slope),
                          lambda: _library_chain(x.float(), ch, dil, slope),
                          lambda: rb.resblock_chain_plain(x, *ch, dil, slope),
                          tol, bound(nbytes + 4 * 2 * len(dil) * k * c * c,
                                     [(3 * flops, PEAK_TF32)]), on_paths,
                          extra={"cudnn_bf16_ms": lambda: _library_chain(
                              x.to(torch.bfloat16), ch, dil, slope)})
            del x
        del chains, x32
        torch.cuda.empty_cache()

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
                        else [(3 * flops, PEAK_TF32)]), {})
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
                    [(3 * 2.0 * 2 * len(dil) * k * c * c * t, PEAK_TF32)]), {})
        del ch, x

    if grad_uses:
        phase_kernel_grads(grad_uses, gen)

    knn_uses = [(k[1:], n) for k, n in uses.items() if k[0] == "knn"]
    require(knn_uses or "pipeline" not in paths, "the main path made no retrieval search")
    for (n_q, n_v, d, k), on_paths in knn_uses + [(s, {}) for s in EXTRA_KNN_SHAPES]:
        q = torch.randn((n_q, d), generator=gen).to(dev)
        v = torch.randn((n_v, d), generator=gen).to(dev)
        if n_q * n_v > KNN_DENSE_ELEMS:
            _check_knn_chunked(rt, check, q, v, k, on_paths)
            del q, v
            continue
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
              lambda: _library_knn(q, v, k),
              lambda: ref_d[:, :k], 1e-4,
              bound(4 * (n_q * d + n_v * d) + 12 * n_q * k,
                    [(3 * 2.0 * n_q * n_v * d, PEAK_TF32)]), on_paths)
        require(bad_rows == 0, f"knn_topk N={n_v}: {bad_rows} rows with other indices")
        del q, v
    torch.cuda.empty_cache()
    for by_kernel in rec.values():
        for r in by_kernel.values():
            r["bound_by"] = ("operations" if r.pop("ops_ms") >= r.pop("bytes_ms")
                             else "bytes")
    emit({"phase": "kernels_by_path", "paths": rec})
    return rec


def _library_knn(q, v, k):
    """The library yardstick of K3: cdist, then argmin (k = 1) or topk."""
    import torch

    d = torch.cdist(q, v)
    return d.argmin(dim=1) if k == 1 else torch.topk(d, k, dim=1, largest=False)


def _check_knn_chunked(rt, check, q, v, k, on_paths):
    """K3 at a shape whose [Q, N] distance matrix the plain version cannot
    hold (the k-means assignment at a user's scale): the kernel at the full
    shape, the plain version on three KNN_CHECK_ROWS-row chunks of the
    queries (the start, the middle, the end). The indices must be equal
    except where the two candidates' exact (float64) distances lie within
    1e-5 relative of each other. Timed over the full shape: the kernel in
    one launch, the plain version and cdist (+ argmin at k = 1) over
    KNN_CHECK_ROWS-row chunks."""
    import torch

    n_q, d = q.shape
    n_v = v.shape[0]
    starts = (0, (n_q - KNN_CHECK_ROWS) // 2, n_q - KNN_CHECK_ROWS)
    dist, idx = rt.knn_topk(q, v, k)
    refs = [rt.knn_search_plain(q[s:s + KNN_CHECK_ROWS], v, k) for s in starts]
    mismatched = excused = 0
    for s, (_, ref_i) in zip(starts, refs):
        got = idx[s:s + KNN_CHECK_ROWS]
        rows = (torch.sort(got, dim=1).values
                != torch.sort(ref_i, dim=1).values).any(dim=1).nonzero()[:, 0]
        if len(rows):
            qd = q[s + rows].double()[:, None, :]
            dk = ((qd - v[got[rows]].double()) ** 2).sum(-1).sort(dim=1).values
            dp = ((qd - v[ref_i[rows]].double()) ** 2).sum(-1).sort(dim=1).values
            close = ((dk - dp).abs() <= 1e-5 * dp.abs()).all(dim=1)
            excused += int(close.sum().item())
            mismatched += int((~close).sum().item())
    chunks = range(0, n_q, KNN_CHECK_ROWS)
    check("knn_topk", {"Q": n_q, "N": n_v, "D": d, "k": k,
                       "checked_rows": len(starts) * KNN_CHECK_ROWS,
                       "index_ties_within_1e-5": excused,
                       "index_mismatch_rows": mismatched},
          lambda: torch.cat([dist[s:s + KNN_CHECK_ROWS] for s in starts]),
          lambda: [rt.knn_search_plain(q[i:i + KNN_CHECK_ROWS], v, k) for i in chunks],
          lambda: [_library_knn(q[i:i + KNN_CHECK_ROWS], v, k) for i in chunks],
          lambda: torch.cat([r[0] for r in refs]), 1e-4,
          bound(4 * (n_q * d + n_v * d) + 12 * n_q * k,
                [(3 * 2.0 * n_q * n_v * d, PEAK_TF32)]), on_paths,
          timed=lambda: rt.knn_topk(q, v, k))
    require(mismatched == 0, f"knn_topk Q={n_q} N={n_v}: {mismatched} rows with "
            "other indices, their distances apart by more than 1e-5")


def phase_kernel_grads(grad_uses, gen):
    """K1 and K2 at the training step's shapes, through their autograd
    Functions: the forward against the plain version (largest error over
    the largest value) and the gradient with respect to x and every folded
    weight and bias against the plain version's autograd gradient (norm of
    the error over the norm, per tensor), in bf16 and f32. In the path's dtype
    (bf16) it times, per stage and per step, the kernel's forward, the
    Functions' backward (the plain-conv recompute, as the JAX package's
    custom_vjp; no hand-written kernel), the plain version's forward alone
    and with its backward, cuDNN's f32 and bf16 chains forward alone, and
    cuDNN's bf16 chain forward and backward, beside their
    bounds (the backward: recompute + input and weight gradients, 3x the
    forward's products)."""
    import torch

    from rvc_tpu_torch.models.generators.nsf import MRF_MAX_CHANNELS
    from rvc_tpu_torch.ops import resblock as rb

    dev = torch.device("cuda")
    per_step = collections.defaultdict(
        lambda: {n: collections.Counter() for n in ("mrf_stage", "resblock_chain")})
    for key, runs in grad_uses.items():
        kind, c, t, path_dtype, ks, dil, b, slope = key
        chains32 = [_rand_chain(gen, c, k, dev, dil) for k in ks]
        x32 = (torch.randn((b, c, t), generator=gen) * 0.3).to(dev)
        cot32 = torch.randn((b, c, t), generator=gen).to(dev)
        name = ("mrf_stage" if kind == "stage" and c <= MRF_MAX_CHANNELS
                else "resblock_chain")
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            x = x32.to(dtype).requires_grad_()
            chains = [[[w.to(dtype).requires_grad_() for w in part] for part in ch]
                      for ch in chains32]
            flat = [x] + [w for ch in chains for part in ch for w in part]
            cot = cot32.to(dtype)
            caches = [rb.WeightCache() for _ in range(len(ks) + 1)]
            if name == "mrf_stage":
                def kernel():
                    return rb.mrf_stage(x, chains, ks, dil, slope, cache=caches[-1])

                def plain():
                    return rb.mrf_stage_plain(x, chains, dil, slope)
            else:  # a wide stage (each chain through K2, then the mean) or one chain
                def kernel():
                    return sum(rb.resblock_chain(x, *ch, dil, slope, cache=cc)
                               for ch, cc in zip(chains, caches)) / len(chains)

                def plain():
                    return sum(rb.resblock_chain_plain(x, *ch, dil, slope)
                               for ch in chains) / len(chains)

            def library():
                return sum(_library_chain(x, ch, dil, slope)
                           for ch in chains) / len(chains)

            out, ref = kernel(), plain()
            grads = torch.autograd.grad(out, flat, cot, retain_graph=True)
            ref_grads = torch.autograd.grad(ref, flat, cot, retain_graph=True)
            torch.cuda.synchronize()
            fwd_rel = _err(ref, out)[1]
            # per tensor ||g - g_ref|| / ||g_ref||, the worst tensor: in bf16
            # a leaky ReLU whose input rounds across 0 changes that element's
            # gradient tenfold, so the largest element's error is the wrong
            # yardstick (it is reported beside). The bf16 backward rounds the
            # state and every conv output to bf16, as JAX's recompute does,
            # against an f32 plain version: about 4e-2 apart at the training
            # shapes; a cut or wrong gradient is about 1 apart
            grad_rel = max(float(torch.linalg.vector_norm((g - r).float())
                                 / torch.linalg.vector_norm(r.float()).clamp(min=1e-30))
                           for r, g in zip(ref_grads, grads))
            grad_max_rel = max(_err(r, g)[1] for r, g in zip(ref_grads, grads))
            fwd_tol, grad_tol = (2e-2, 1e-1) if dtype == torch.bfloat16 else (1e-4, 1e-4)
            row = {"kernel": name, "B": b, "C": c, "T": t, "dtype": dname,
                   "ks": list(ks), "slope": slope, "fwd_rel_err": fwd_rel, "fwd_tol": fwd_tol,
                   "grad_norm_rel_err": grad_rel, "grad_tol": grad_tol,
                   "grad_max_abs_over_max_ref": grad_max_rel, "calls_per_step": runs}
            if dname == path_dtype:
                flops = 2.0 * b * sum(2 * len(dil) * k * c * c * t for k in ks)
                wbytes = sum(2 * len(dil) * k * c * c for k in ks) * 2
                xbytes = x.numel() * 2
                with torch.no_grad():
                    row["fwd_ms"] = gpu_time_ms(kernel)
                    row["plain_fwd_ms"] = gpu_time_ms(plain, 3)
                    row["cudnn_f32_fwd_ms"] = gpu_time_ms(lambda: sum(
                        _library_chain(x32, ch, dil, slope) for ch in chains32), 3)
                    row["cudnn_bf16_fwd_ms"] = gpu_time_ms(library, 3)
                row["fwd_bound_ms"] = bound(2 * xbytes + wbytes,
                                            [(flops, PEAK_BF16)] if name == "mrf_stage"
                                            else [(3 * flops, PEAK_TF32)])[0]
                row["bwd_recompute_ms"] = gpu_time_ms(
                    lambda: torch.autograd.grad(out, flat, cot, retain_graph=True))
                row["bwd_bound_ms"] = bound(3 * xbytes + 2 * wbytes,
                                            [(3 * flops, PEAK_BF16)])[0]
                row["plain_fwd_bwd_ms"] = gpu_time_ms(
                    lambda: torch.autograd.grad(plain(), flat, cot), 3)
                row["cudnn_fwd_bwd_ms"] = gpu_time_ms(
                    lambda: torch.autograd.grad(library(), flat, cot), 3)
                for run, calls in runs.items():
                    for f in ("fwd_ms", "fwd_bound_ms", "plain_fwd_ms", "cudnn_f32_fwd_ms",
                              "cudnn_bf16_fwd_ms", "bwd_recompute_ms", "bwd_bound_ms",
                              "plain_fwd_bwd_ms", "cudnn_fwd_bwd_ms"):
                        per_step[run][name][f] += calls * row[f]
            emit({"phase": "kernel_grad_check", **row})
            require(fwd_rel <= fwd_tol and grad_rel <= grad_tol,
                    f"{name} B={b} C={c} T={t} {dname}: forward {fwd_rel}, gradient {grad_rel}")
            del out, ref, grads, ref_grads, x, chains, flat
        del chains32, x32, cot32
        torch.cuda.empty_cache()
    emit({"phase": "train_kernels_per_step",
          "per_step": {run: {n: dict(v) for n, v in by_kernel.items()}
                       for run, by_kernel in per_step.items()}})


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


# the small model of phase `small`: narrow widths, two chains of two
# dilations, a two-layer flow, no noise
TINY_MODEL = dict(inter_channels=8, hidden_channels=8, filter_channels=16,
                  n_layers=2, resblock_kernel_sizes=(3, 5),
                  resblock_dilation_sizes=((1, 3), (1, 3)),
                  upsample_initial_channel=64, spk_embed_dim=4, gin_channels=8)


def _config(tiny: bool, use_f0: bool = True):
    from rvc_tpu_torch.configs import get_config

    return get_config(48000, use_f0=use_f0, **(TINY_MODEL if tiny else {}))


def _synth(cfg, tiny: bool, device):
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    extra = dict(flow_layers=2, zero_noise=True) if tiny else {}
    return Synthesizer.from_config(cfg, device=device, **extra)


def _build_models(device, tiny: bool, rng):
    from rvc_tpu_torch.embedders.hubert import Hubert, HubertConfig
    from rvc_tpu_torch.predictors.rmvpe import RMVPE, E2EModel

    cfg = _config(tiny)
    synth = _synth(cfg, tiny, device)
    if tiny:
        hub = Hubert.build(HubertConfig(
            hidden_size=768, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4), device=device)
        e2e = E2EModel(n_blocks=1, en_de_layers=2, inter_layers=1,
                       en_out_channels=4, gru_hidden=16)
    else:
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
    the builds of every weight cache on its modules (each chain's and
    each stage's), whichever the decoder."""
    from rvc_tpu_torch.ops.resblock import WeightCache

    n = 0
    for m in decoder.modules():
        for v in vars(m).values():
            for c in (v if isinstance(v, list) else [v]):
                n += c.builds if isinstance(c, WeightCache) else 0
    return n


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
            "rmvpe_model": lambda: pipe._rmvpe_model(mel),
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


# -- the user's entry points: model files, the CLI, long inputs, folders -------

def _reference_rmvpe(e2e) -> dict:
    """The port's E2EModel in the reference rmvpe.pt layout: ``nn.GRU``
    weights (gates r, z, n stacked; the folded r/z bias kept in b_ih) and
    the batch norms' ``num_batches_tracked``."""
    import torch

    gru = e2e.fc[0].gru
    sd = {}
    for k, v in e2e.state_dict().items():
        if not k.startswith("fc.0.gru."):
            sd[k] = v.detach().cpu().clone()
            if k.endswith("running_mean"):
                sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    for sfx, tag in (("", "fwd"), ("_reverse", "bwd")):
        p = {n: getattr(gru, f"{n}_{tag}").detach().cpu() for n in ("wi", "bi", "wh", "bhn")}
        sd[f"fc.0.gru.weight_ih_l0{sfx}"] = p["wi"].T.contiguous()
        sd[f"fc.0.gru.weight_hh_l0{sfx}"] = p["wh"].T.contiguous()
        sd[f"fc.0.gru.bias_ih_l0{sfx}"] = p["bi"].clone()
        sd[f"fc.0.gru.bias_hh_l0{sfx}"] = torch.cat([torch.zeros(2 * gru.hidden),
                                                     p["bhn"]])
    return sd


def _hf_hubert(hub) -> dict:
    """The port's Hubert in the transformers layout: the positional conv's
    weight norm over dim 2 (g of shape [1, 1, K])."""
    import torch

    from rvc_tpu_torch.models.commons import weight_norm

    sd = {k: v.detach().cpu().clone() for k, v in hub.state_dict().items()}
    base = "encoder.pos_conv_embed.conv"
    w = weight_norm(sd.pop(f"{base}.weight_v"), sd.pop(f"{base}.weight_g"))
    sd[f"{base}.weight_g"] = torch.sqrt(torch.sum(w * w, dim=(0, 1), keepdim=True))
    sd[f"{base}.weight_v"] = w
    return sd


def phase_files(smi: str, root: str) -> dict:
    """Write the fixtures in the reference formats from numpy seed 0 (a
    full-width 48 kHz .pth with and without pitch, a 65536 x 768 flat faiss
    index, rmvpe.pt, an HF-layout contentvec), read them back through the
    port's loaders onto the card, and check they give back what was
    written."""
    import torch

    from rvc_tpu_torch.embedders.hubert import load_embedder
    from rvc_tpu_torch.models.commons import weight_norm
    from rvc_tpu_torch.ops.retrieval import FeatureIndex
    from rvc_tpu_torch.predictors.rmvpe import RMVPE
    from rvc_tpu_torch.utils.checkpoints import build_synthesizer, export_rvc_pth, load_rvc_pth
    from rvc_tpu_torch.utils.faiss_io import write_index_flat

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cfg, synth, hub, rmvpe = _build_models("cpu", False, rng)
    cfg0 = _config(False, use_f0=False)
    synth0 = _synth(cfg0, False, "cpu")
    _fill_random(synth0, rng)
    index = rng.normal(size=(65536, 768)).astype(np.float32)
    paths = {"pth": os.path.join(root, "model.pth"),
             "pth_nof0": os.path.join(root, "model_nof0.pth"),
             "index": os.path.join(root, "added_IVF256_Flat_nprobe_1_model_v2.index"),
             "rmvpe": os.path.join(root, "models", "predictors", "rmvpe.pt"),
             "embedder": os.path.join(root, "models", "embedders", "contentvec",
                                      "pytorch_model.bin")}
    for key in ("rmvpe", "embedder"):
        os.makedirs(os.path.dirname(paths[key]), exist_ok=True)
    export_rvc_pth(synth, paths["pth"], cfg)
    export_rvc_pth(synth0, paths["pth_nof0"], cfg0)
    write_index_flat(paths["index"], index)
    torch.save(_reference_rmvpe(rmvpe.model), paths["rmvpe"])
    torch.save(_hf_hubert(hub), paths["embedder"])
    write_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for key, src, f0 in (("pth", synth, 1), ("pth_nof0", synth0, 0)):
        sd, meta = load_rvc_pth(paths[key])
        model, got_cfg, use_f0 = build_synthesizer(sd, meta)
        require(use_f0 == bool(f0) and got_cfg.model == (cfg if f0 else cfg0).model,
                f"{key}: rebuilt {got_cfg.model} use_f0={use_f0}")
        want = {k: v.half().float() for k, v in src.state_dict().items()}
        got = model.state_dict()
        require(got.keys() == want.keys(), f"{key}: the rebuilt model has other weights")
        bad = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
        require(not bad, f"{key}: rebuilt weights differ from the written: {bad[:4]}")
        del model
    vec = FeatureIndex.load(paths["index"]).vectors
    require(torch.equal(vec.cpu(), torch.from_numpy(index)),
            "the .index read back differs")
    pred = RMVPE.from_torch_checkpoint(paths["rmvpe"])
    got = pred.model.state_dict()
    bad = [k for k, v in rmvpe.model.state_dict().items() if not torch.equal(got[k].cpu(), v)]
    require(not bad, f"rmvpe.pt read back differs: {bad[:4]}")
    emb = load_embedder(paths["embedder"])
    got, want = emb.state_dict(), hub.state_dict()
    pos = "encoder.pos_conv_embed.conv"
    bad = [k for k in want if not k.startswith(pos + ".weight")
           and not torch.equal(got[k].cpu(), want[k])]
    w_got = weight_norm(got[f"{pos}.weight_v"], got[f"{pos}.weight_g"]).cpu()
    w_want = weight_norm(want[f"{pos}.weight_v"], want[f"{pos}.weight_g"])
    pos_err = _err(w_want, w_got)[1]
    require(not bad and pos_err <= 1e-6,
            f"embedder read back differs: {bad[:4]}, positional conv {pos_err}")
    load_s = time.perf_counter() - t0
    emit({"phase": "files", "gpu": smi, "write_s": write_s, "load_s": load_s,
          "bytes": {k: os.path.getsize(p) for k, p in paths.items()},
          "pos_conv_rel_err": pos_err})
    del pred, emb, vec, synth, synth0, hub, rmvpe
    torch.cuda.empty_cache()
    return paths


class _Probe:
    """Patches ``Pipeline`` and ``VoiceConverter`` for one run: host time
    of each ``get_f0`` and of model loading, CUDA-event device time of each
    ``_convert_core`` (one window or batch each; enqueued ahead, so the
    events time the device's work on it), the rows of each
    ``convert_segments_batch``, and the pipeline that ran."""

    def __enter__(self):
        import torch

        from rvc_tpu_torch.infer.converter import VoiceConverter
        from rvc_tpu_torch.infer.pipeline import Pipeline

        self.f0_s, self.load_s, self.events, self.rows, self.pipe = [], [], [], [], None
        self.saved = [(Pipeline, n, getattr(Pipeline, n)) for n in
                      ("get_f0", "_convert_core", "convert_segments_batch")]
        self.saved += [(VoiceConverter, n, getattr(VoiceConverter, n))
                       for n in ("get_vc", "get_predictors")]
        orig = {n: f for _, n, f in self.saved}

        def timed(name, into):
            def hook(obj, *a, **k):
                t0 = time.perf_counter()
                out = orig[name](obj, *a, **k)
                into.append(time.perf_counter() - t0)
                return out
            return hook

        def core(pipe, *a, **k):
            self.pipe = pipe
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig["_convert_core"](pipe, *a, **k)
            end.record()
            self.events.append((start, end))
            return out

        def batch(pipe, segments, *a, **k):
            self.rows.append(len(segments))
            return orig["convert_segments_batch"](pipe, segments, *a, **k)

        Pipeline.get_f0 = timed("get_f0", self.f0_s)
        Pipeline._convert_core = core
        Pipeline.convert_segments_batch = batch
        VoiceConverter.get_vc = timed("get_vc", self.load_s)
        VoiceConverter.get_predictors = timed("get_predictors", self.load_s)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)

    def device_ms(self):
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def _cli(argv, root):
    """``rvc_tpu_torch.cli.main(argv)`` in-process, run from ``root`` (where
    the staged models/ are); returns its wall seconds."""
    import torch

    from rvc_tpu_torch import cli

    cwd = os.getcwd()
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    require(rc == 0, f"cli {argv[0]} returned {rc}")
    return wall


_CHILD_CLI = """import json, sys, time
import torch
sys.path.insert(0, {repo!r})
from rvc_tpu_torch import cli
from rvc_tpu_torch.ops import resblock as rb, retrieval as rt
t0 = time.perf_counter()
rc = cli.main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({{"rc": rc, "wall_s": time.perf_counter() - t0,
                  "launches": {{**rb.launches, **rt.launches}}}}))
"""


def _cli_process(argv, root, timeout_s: float = 600.0):
    """``python -m rvc_tpu_torch.cli`` as a process of its own, run from
    ``root``, as a user runs it; returns its wall seconds (the interpreter's
    start and imports included), the ``main`` call's, and its kernel
    launches."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CHILD_CLI.format(repo=REPO), *argv],
                          cwd=root, capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and lines and lines[-1].startswith("{"),
            f"cli {argv[0]} in a process of its own: rc {proc.returncode}, "
            f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    out = json.loads(lines[-1])
    require(out["rc"] == 0, f"cli {argv[0]} returned {out['rc']}")
    return wall, out["wall_s"], out["launches"]


def _windowed_len(pipe, audio16: np.ndarray) -> int:
    """Output samples of ``Pipeline.pipeline`` on its windowed path: the
    windows cut at the port's own quietest points, each p_len frames of its
    bucket less the pads."""
    audio = pipe._highpass(audio16)
    n_pad = audio.shape[0] + 2 * pipe.t_pad
    lens, s = [], 0
    for t_raw in pipe._find_cut_points(audio):
        t = t_raw // 160 * 160
        lens.append(min(t + pipe.t_pad2 + 160, n_pad) - s)
        s = t
    lens.append(n_pad - s)
    return sum(_segment_len(pipe, n) - 2 * pipe.t_pad_tgt for n in lens)


def _check_wav(path, n_expect: int, what: str, rate: int = 48000) -> np.ndarray:
    from rvc_tpu_torch.utils.audio_io import read_wav

    data, sr = read_wav(path)
    require(sr == rate, f"{what}: output at {sr} Hz, not {rate}")
    require(data.shape == (n_expect,), f"{what}: {data.shape} samples != ({n_expect},)")
    require(bool(np.isfinite(data).all()) and float(np.abs(data).max()) <= 1.0,
            f"{what}: output not finite or beyond |x| <= 1")
    return data


def _flags(paths):
    return ["--index_path", paths["index"], "--f0_method", "rmvpe",
            "--index_rate", "0.75", "--protect", "0.33", "--pitch", "2"]


def phase_windowed(smi: str, paths: dict, root: str, seconds: float = 150.0):
    """The CLI's ``infer`` on a long input read from a 44.1 kHz stereo WAV
    (mono mix, resampling, three windows): a warm-up run that records the
    kernels' shapes, then three timed runs, the first with the launch
    counts."""
    import torch

    from rvc_tpu_torch.utils.audio_io import load_audio, write_wav

    rng = np.random.default_rng(4)
    n = int(seconds * 44100)
    tt = np.arange(n) / 44100
    env = 0.55 + 0.45 * np.sin(2 * np.pi * tt / 7.3)
    left = env * (0.4 * np.sin(2 * np.pi * 220 * tt) + 0.05 * rng.normal(size=n))
    wav = os.path.join(root, "long_44k_stereo.wav")
    write_wav(wav, np.stack([left, 0.8 * left], axis=1).astype(np.float32), 44100)
    out = os.path.join(root, "long_out.wav")
    argv = ["infer", "--input_path", wav, "--output_path", out,
            "--pth_path", paths["pth"], *_flags(paths)]

    shapes = record_path_shapes(lambda: _cli(argv, root))
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        with _Probe() as probe:
            if i == 0:
                _reset_counts()
            walls.append(_cli(argv, root))
            if i == 0:
                counts = _counts()
                first = probe
        if i == 0:
            window_ms = probe.device_ms()
    audio16 = load_audio(wav, 16000)
    audio16 = audio16 / max(np.abs(audio16).max() / 0.95, 1.0)
    data = _check_wav(out, _windowed_len(first.pipe, audio16), "windowed")
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched on the windowed path")
    require(len(window_ms) == 3, f"{len(window_ms)} windows, not 3")
    wall = statistics.median(walls)
    emit({"phase": "windowed", "gpu": smi, "input_s": seconds, "input": "44.1 kHz stereo",
          "samples": int(data.shape[0]), "windows": len(window_ms), "launches": counts,
          "wall_s": wall, "wall_s_all": walls, "realtime_factor": seconds / wall,
          "host_f0_s": first.f0_s, "load_s": first.load_s,
          "device_ms_per_window": window_ms,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "kernel_shapes": [[str(v) if isinstance(v, torch.dtype) else v for v in sh]
                            for sh in shapes]})
    return counts, shapes


def phase_batch(smi: str, paths: dict, root: str):
    """The CLI's ``batch_infer`` on a folder of four files (3, 5, 8, 11 s):
    one ``convert_segments_batch`` of four rows; its wall against the same
    files one by one through ``convert_audio``; and a small fp32 model's
    ``convert_segments_batch`` on the card against the same call on the CPU."""
    import torch

    from rvc_tpu_torch.infer.converter import VoiceConverter
    from rvc_tpu_torch.infer.pipeline import Pipeline, PipelineConfig

    src, lengths = _batch_files(root)

    def argv(out):
        return ["batch_infer", "--input_folder", src, "--output_folder", out,
                "--pth_path", paths["pth"], *_flags(paths)]

    shapes = record_path_shapes(lambda: _cli(argv(os.path.join(root, "b0")), root))
    walls = []
    for i in range(3):
        out = os.path.join(root, f"b{i + 1}")
        with _Probe() as probe:
            if i == 0:
                _reset_counts()
            walls.append(_cli(argv(out), root))
            if i == 0:
                counts, rows, pipe = _counts(), probe.rows, probe.pipe
    require(rows == [4], f"batch_infer made convert_segments_batch calls of {rows} rows")
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched on the batch path")
    t_bucket = pipe._bucket_len(int(max(lengths.values()) * 16000) + 2 * pipe.t_pad)
    for name, sec in lengths.items():
        n16 = int(sec * 16000) + 2 * pipe.t_pad
        _check_wav(os.path.join(root, "b1", f"{name}_output.wav"),
                   pipe._p_len(n16, t_bucket) * pipe.upp - 2 * pipe.t_pad_tgt,
                   f"batch {name}")

    # the same files through one warm converter: packed, then one by one
    kw = dict(model_path=paths["pth"], index_path=paths["index"], f0_method="rmvpe",
              index_rate=0.75, protect=0.33, pitch=2)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        vc = VoiceConverter()
        vc.convert_audio_batch(src, os.path.join(root, "w0"), **kw)
        packed, single = [], []
        for i in range(3):
            t0 = time.perf_counter()
            vc.convert_audio_batch(src, os.path.join(root, f"w{i + 1}"), **kw)
            torch.cuda.synchronize()
            packed.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for name in lengths:
                vc.convert_audio(os.path.join(src, f"{name}.wav"),
                                 os.path.join(root, f"s{i}_{name}.wav"), **kw)
            torch.cuda.synchronize()
            single.append(time.perf_counter() - t0)
    finally:
        os.chdir(cwd)
    del vc

    # a small fp32 model: the card's batch against the CPU's plain versions
    outs, pitch = {}, None
    for device in ("cpu", "cuda"):
        rng = np.random.default_rng(1)
        cfg, synth, hub, rmvpe = _build_models(device, True, rng)
        small = Pipeline(48000, synth, hub, PipelineConfig(x_pad=1),
                         upsample_factor=cfg.upsample_factor, precision="fp32",
                         device=device)
        small.set_rmvpe(rmvpe)
        index = rng.normal(size=(3000, 768)).astype(np.float32)
        segs = [np.pad(small._highpass(_audio(sec, np.random.default_rng(30 + i))),
                       (16000, 16000), mode="reflect")
                for i, sec in enumerate((1.0, 1.5, 2.25, 3.0))]
        if pitch is None:  # one pitch for both: the batch path alone
            pitch = [small.get_f0(s, s.shape[0] // 160, 2) for s in segs]
        _reset_counts()
        outs[device] = small.convert_segments_batch(
            segs, [p[0] for p in pitch], [p[1] for p in pitch], [1] * 4, index,
            0.75, 0.33)
        small_counts = _counts()
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs["cpu"], outs["cuda"]))
    require(all(a.shape == b.shape for a, b in zip(outs["cpu"], outs["cuda"])),
            "small batch: shapes differ")
    require(err <= 1e-3, f"small batch: card vs CPU plain max abs err {err} > 1e-3")
    require(small_counts["resblock_chain"] > 0 and small_counts["knn_topk"] > 0,
            "small batch: kernels not launched")
    audio_s = sum(lengths.values())
    emit({"phase": "batch", "gpu": smi, "files_s": list(lengths.values()),
          "rows": rows, "launches": counts, "cli_wall_s": statistics.median(walls),
          "cli_wall_s_all": walls, "cli_audio_s_per_wall_s": audio_s / statistics.median(walls),
          "packed_wall_s": statistics.median(packed), "packed_wall_s_all": packed,
          "packed_audio_s_per_wall_s": audio_s / statistics.median(packed),
          "one_by_one_wall_s": statistics.median(single), "one_by_one_wall_s_all": single,
          "one_by_one_audio_s_per_wall_s": audio_s / statistics.median(single),
          "small_fp32_max_abs_err_vs_cpu_plain": err, "small_launches": small_counts,
          "kernel_shapes": [[str(v) if isinstance(v, torch.dtype) else v for v in sh]
                            for sh in shapes]})
    return counts, shapes


def phase_nof0(smi: str, paths: dict, root: str):
    """The CLI's ``infer`` with the model without pitch (plain HiFi-GAN
    decoder) on 10 s of audio."""
    from rvc_tpu_torch.utils.audio_io import write_wav

    wav = os.path.join(root, "nof0_in.wav")
    audio = _audio(10.0, np.random.default_rng(5))
    write_wav(wav, audio, 16000)
    out = os.path.join(root, "nof0_out.wav")
    argv = ["infer", "--input_path", wav, "--output_path", out,
            "--pth_path", paths["pth_nof0"], *_flags(paths)]
    shapes = record_path_shapes(lambda: _cli(argv, root))
    with _Probe() as probe:
        _reset_counts()
        wall = _cli(argv, root)
        counts = _counts()
    require(probe.f0_s == [], "the model without pitch ran an f0 predictor")
    require(counts["mrf_stage"] > 0 and counts["resblock_chain"] > 0,
            f"the plain HiFi-GAN decoder did not launch K1 and K2: {counts}")
    audio = audio / max(np.abs(audio).max() / 0.95, 1.0)
    data = _check_wav(out, _windowed_len(probe.pipe, audio), "nof0")
    emit({"phase": "nof0", "gpu": smi, "samples": int(data.shape[0]),
          "peak_abs": float(np.abs(data).max()), "launches": counts, "wall_s": wall})
    return counts, shapes


# -- training: the 48 kHz GAN trainer through the CLI -------------------------

TRAIN_CLIPS = 40
TRAIN_SEGMENT = 17280   # samples of a training slice (36 latent frames)
TRAIN_BATCH = 8


def _write_train_dataset(exp: str, rng, sr: int = 48000) -> None:
    """40 clips of 2-8 s at ``sr`` (float WAV), features [T50, 768], coarse
    f0 in 1..255 and f0 in Hz, and filelist.txt with rows
    wav|feats.npy|f0.npy|f0nsf.npy|sid, in the layout train/data.py reads."""
    from rvc_tpu_torch.utils.audio_io import write_wav

    rows = []
    for i in range(TRAIN_CLIPS):
        frames = int(rng.integers(200, 801))
        tt = np.arange(frames * (sr // 100)) / sr
        f0_hz = 120.0 + 80.0 * rng.random()
        wav = 0.3 * np.sin(2 * np.pi * f0_hz * tt) + 0.02 * rng.normal(size=tt.size)
        base = os.path.join(exp, f"clip{i:02d}")
        write_wav(base + ".wav", wav.astype(np.float32), sr, "FLOAT")
        f0 = np.full(frames, f0_hz, np.float32)
        np.save(base + ".feats.npy", rng.normal(size=(frames // 2 + 1, 768)).astype(np.float32))
        np.save(base + ".f0.npy", rng.integers(1, 256, size=frames).astype(np.int64))
        np.save(base + ".f0nsf.npy", f0)
        rows.append(f"{base}.wav|{base}.feats.npy|{base}.f0.npy|{base}.f0nsf.npy|{i % 2}")
    with open(os.path.join(exp, "filelist.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


class _TrainProbe:
    """Patches the trainer for one CLI run: per step its metrics, its K1/K2
    launches, CUDA events at the step's parts (``TrainStep.mark``), the
    memory held and the peak; the first step's per-module gradient norms
    (``debug_grads``); the parameters right after a resume; the trainer."""

    def __init__(self):
        self.steps, self.resumed, self.trainer = [], None, None

    def __enter__(self):
        import torch

        from rvc_tpu_torch.ops import resblock as rb
        from rvc_tpu_torch.train.step import TrainStep
        from rvc_tpu_torch.train.trainer import Trainer

        self.saved = [(TrainStep, "__call__", TrainStep.__call__),
                      (Trainer, "_resume", Trainer._resume),
                      (Trainer, "init_state", Trainer.init_state)]
        orig_call, orig_resume, orig_init = (f for _, _, f in self.saved)
        probe = self

        def call(step, batch, *a, **k):
            events = []

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((name, ev))

            step.mark = mark
            step.debug_grads = not probe.steps  # the first step of the run
            before = dict(rb.launches)
            torch.cuda.reset_peak_memory_stats()
            out = orig_call(step, batch, *a, **k)
            probe.steps.append({
                "metrics": out, "events": events, "frames": int(batch["phone"].shape[1]),
                "launches": {n: rb.launches[n] - before[n] for n in before},
                "peak": torch.cuda.max_memory_allocated(),
                "held": torch.cuda.memory_allocated()})
            step.debug_grads, step.mark = False, None
            return out

        def resume(trainer, g_path, d_path):
            orig_resume(trainer, g_path, d_path)
            probe.resumed = {"g_path": g_path, "d_path": d_path, "step": trainer.step,
                             "start_epoch": trainer.start_epoch,
                             "spe": trainer.steps_per_epoch,
                             "g": {k: v.detach().cpu().clone()
                                   for k, v in trainer.model_g.state_dict().items()},
                             "d": {k: v.detach().cpu().clone()
                                   for k, v in trainer.model_d.state_dict().items()}}

        def init_state(trainer):
            probe.trainer = trainer
            orig_init(trainer)

        TrainStep.__call__, Trainer._resume, Trainer.init_state = call, resume, init_state
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)


def _step_parts_ms(step):
    """(G forward, D update, G losses + backward + optimizer, whole) device
    ms of one probed step."""
    ev = dict(step["events"])
    parts = [("g_forward", "d_update"), ("d_update", "g_update"), ("g_update", "end")]
    ms = [ev[a].elapsed_time(ev[b]) for a, b in parts]
    return ms + [ev["g_forward"].elapsed_time(ev["end"])]


# the small model of phase `small_train`: hop 64 (two x8 upsamples), stages
# of 32 and 16 channels, two chains of two dilations
SMALL_TRAIN_MODEL = dict(inter_channels=8, hidden_channels=8, filter_channels=16,
                         n_heads=2, n_layers=1, resblock_kernel_sizes=(3, 5),
                         resblock_dilation_sizes=((1, 3), (1, 3)),
                         upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                         upsample_initial_channel=64, spk_embed_dim=4, gin_channels=8)


def _small_train_step(device: str, bf16: bool):
    """One step of a small model (the CPU tests' widths, full MPD) from
    weights of seed 5, a seeded batch and fixed slice starts: (metrics,
    G and D state_dicts on the host)."""
    import dataclasses

    import torch

    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.train.optimizers import module_optimizer
    from rvc_tpu_torch.train.step import TrainStep
    from rvc_tpu_torch.train.trainer import init_parameters

    cfg = get_config(48000)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, filter_length=256, hop_length=64,
                                      win_length=256),
        model=dataclasses.replace(cfg.model, **SMALL_TRAIN_MODEL),
        train=dataclasses.replace(cfg.train, segment_size=64 * 40, bf16_run=bf16))
    g = Synthesizer.from_config(cfg, device=device, train=True, posterior_layers=2,
                                flow_layers=2, zero_noise=True)
    d = MultiPeriodDiscriminator().to(device)
    gen = torch.Generator().manual_seed(5)
    init_parameters(g, gen)
    init_parameters(d, gen)
    step = TrainStep(cfg, g, d, module_optimizer("adamw", g, 1e-4),
                     module_optimizer("adamw", d, 1e-4), debug_grads=True)
    rng = np.random.default_rng(6)
    b, t = 2, 48
    tt = np.arange(t * 64) / 48000
    batch = {"phone": rng.normal(size=(b, t, 768)).astype(np.float32),
             "phone_lengths": np.array([t, t - 4], np.int32),
             "pitch": rng.integers(1, 256, size=(b, t)).astype(np.int64),
             "pitchf": np.full((b, t), 200.0, np.float32),
             "spec": np.abs(rng.normal(size=(b, t, 129))).astype(np.float32),
             "spec_lengths": np.array([t, t - 4], np.int32),
             "wave": (0.3 * np.sin(2 * np.pi * 200 * tt)[None, :, None]
                      + 0.02 * rng.normal(size=(b, t * 64, 1))).astype(np.float32),
             "sid": np.array([0, 1], np.int64)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    _reset_counts()
    metrics = step(batch, ids_slice=torch.tensor([3, 1], dtype=torch.int32, device=device))
    counts = _counts()
    return ({k: float(v) for k, v in metrics.items()}, counts,
            {k: v.detach().cpu() for k, v in g.state_dict().items()},
            {k: v.detach().cpu() for k, v in d.state_dict().items()})


def phase_small_train(smi: str):
    """One training step of a small model on the card (K2 through the stage
    tails in fp32, K1 in bf16) against the same step on the CPU (plain
    versions), from the same weights, batch and slice starts: in fp32 the
    losses and the updated parameters, in bf16 the losses and the gradient
    norm of every module (bf16 rounds in other places on the two devices)."""
    cpu_m, _, cpu_g, cpu_d = _small_train_step("cpu", False)
    gpu_m, counts, gpu_g, gpu_d = _small_train_step("cuda", False)
    cpu_bf, _, _, _ = _small_train_step("cpu", True)
    gpu_bf, bf_counts, _, _ = _small_train_step("cuda", True)

    def rel(ref, got, keys):
        return {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-3) for k in keys}

    losses = [k for k in cpu_m if k.startswith("loss") or k == "mel_similarity_pct"]
    norms = [k for k in cpu_m if k.startswith(("gsub_", "grad_norm"))]
    loss_rel, bf_loss_rel = rel(cpu_m, gpu_m, losses), rel(cpu_bf, gpu_bf, losses)
    bf_norm_rel = rel(cpu_bf, gpu_bf, norms)
    lr = 1e-4
    worst, off, total = 0.0, 0, 0
    for ref, got in ((cpu_g, gpu_g), (cpu_d, gpu_d)):
        for k, v in ref.items():
            diff = (got[k].float() - v.float()).abs()
            worst = max(worst, float(diff.max()))
            off += int((diff > 1e-5).sum())
            total += diff.numel()
    emit({"phase": "small_train", "gpu": smi, "fp32_loss_rel_err_vs_cpu": loss_rel,
          "loss_tol": 1e-3, "fp32_param_max_abs_err_vs_cpu": worst,
          "fp32_param_share_beyond_1e-5": off / total,
          "param_tol": "all <= 2 lr; <= 1% beyond 1e-5",
          "bf16_loss_rel_err_vs_cpu": bf_loss_rel, "bf16_loss_tol": 5e-3,
          "bf16_grad_norm_rel_err_vs_cpu": bf_norm_rel, "bf16_grad_norm_tol": 1e-1,
          "launches_fp32": counts, "launches_bf16": bf_counts})
    require(max(loss_rel.values()) <= 1e-3,
            f"small train step: fp32 card vs CPU losses {loss_rel}")
    require(worst <= 2 * lr + 1e-6 and off <= 0.01 * total,
            f"small train step: params differ by {worst} ({off}/{total} beyond 1e-5)")
    require(max(bf_loss_rel.values()) <= 5e-3 and max(bf_norm_rel.values()) <= 1e-1,
            f"small train step: bf16 card vs CPU losses {bf_loss_rel}, norms {bf_norm_rel}")
    require(counts["resblock_chain"] > 0 and bf_counts["mrf_stage"] > 0,
            f"small train step: kernels not launched ({counts}, {bf_counts})")


def phase_train(smi: str, root: str):
    """The CLI's ``train`` on the card at full width (get_config(48000),
    bf16, batch 8, 17280-sample slices, from the seed's weights): 3 epochs
    saving every epoch, then a second call to 4 that resumes; then the
    exported ``<name>_3e.pth`` converts 10 s through ``VoiceConverter``."""
    import torch

    from rvc_tpu_torch.utils.audio_io import write_wav

    held_before = torch.cuda.memory_allocated()  # earlier phases' models
    rng = np.random.default_rng(0)
    exp = os.path.join(root, "logs", "smoke")
    os.makedirs(exp, exist_ok=True)
    _write_train_dataset(exp, rng)
    argv = ["train", "--model_name", "smoke", "--sample_rate", "48000",
            "--save_every_epoch", "1", "--pretrained", "False",
            "--batch_size", str(TRAIN_BATCH), "--save_only_latest", "True"]
    grad_shapes = []
    _reset_counts()
    with _TrainProbe() as first:
        t0 = time.perf_counter()
        shapes = record_path_shapes(lambda: _cli(argv + ["--total_epoch", "3"], root),
                                    grad_shapes)
        first_wall = time.perf_counter() - t0
    counts = _counts()
    spe = first.trainer.steps_per_epoch
    keep = {k: v.detach().cpu().clone() for k, v in first.trainer.model_g.state_dict().items()}
    first.trainer = None  # free the first call's models before the second
    gc.collect()
    torch.cuda.empty_cache()
    # the checkpoints the first call saved (the second call overwrites them)
    saved_g, saved_d = (torch.load(os.path.join(exp, f"{n}_2333333.pth"), map_location="cpu",
                                   weights_only=True)["model"] for n in ("G", "D"))
    with _TrainProbe() as second:
        _cli(argv + ["--total_epoch", "4"], root)
    steps = first.steps + second.steps
    trainer = second.trainer

    # every step: finite losses, K1 and K2 launched
    for i, st in enumerate(steps):
        m = {k: float(v) for k, v in st["metrics"].items()}
        require(all(np.isfinite(v) for v in m.values()), f"train step {i}: {m}")
        require(st["launches"]["mrf_stage"] > 0 and st["launches"]["resblock_chain"] > 0,
                f"train step {i}: K1/K2 launches {st['launches']}")
    require(len(first.steps) == 3 * spe and len(second.steps) == spe,
            f"{len(first.steps)} + {len(second.steps)} steps, not 4 x {spe}")
    # the first step reached every parameter group of G and D
    gsub = {k: float(v) for k, v in first.steps[0]["metrics"].items() if k.startswith("gsub_")}
    groups = (["gsub_g/" + n for n in ("enc_p", "enc_q", "flow", "emb_g", "dec.conv_pre",
                                       "dec.ups", "dec.noise_convs", "dec.conv_post",
                                       "dec.m_source")]
              + [f"gsub_g/dec.resblocks.stage{i}" for i in range(4)]
              + ["gsub_d/disc_s"] + [f"gsub_d/disc_p{p}" for p in (2, 3, 5, 7, 11, 17, 23, 37)])
    for name in groups:
        v = gsub.get(name, float("nan"))
        require(np.isfinite(v) and v > 0, f"gradient norm of {name} after step 1: {v}")
    # resume: at epoch 4, step 3 x steps per epoch, with the saved parameters
    res = second.resumed
    require(res is not None and res["start_epoch"] == 4 and res["step"] == 3 * spe,
            f"resume: {res and (res['start_epoch'], res['step'])}, spe {spe}")
    for name, got, want in (("G", res["g"], saved_g), ("D", res["d"], saved_d)):
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        require(not bad and got.keys() == want.keys(), f"resumed {name} differs: {bad[:4]}")
    bad = [k for k in keep if not torch.equal(keep[k], saved_g[k])]
    require(not bad, f"the saved G is not the trained one: {bad[:4]}")
    recs = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    val = [r for r in recs if "validation/loss/mel_l1" in r]
    epochs = [r for r in recs if "epoch/epoch_seconds" in r]
    require(len(val) == 4 and all(np.isfinite(v) for r in val for v in r.values()),
            f"validation metrics: {val}")

    # train, then convert 10 s on the card with the exported model
    wav = os.path.join(root, "train_conv_in.wav")
    audio = _audio(10.0, np.random.default_rng(9))
    write_wav(wav, audio, 16000)
    out = os.path.join(root, "train_conv_out.wav")
    with _Probe() as probe:
        _cli(["infer", "--input_path", wav, "--output_path", out, "--pth_path",
              os.path.join(exp, "smoke_3e.pth"), "--f0_method", "rmvpe"], root)
    audio = audio / max(np.abs(audio).max() / 0.95, 1.0)
    data = _check_wav(out, _windowed_len(probe.pipe, audio), "train then convert")

    # numbers: device time of the step's parts over warm steps, memory, rate
    warm = [st for st in first.steps[2:]]
    parts = np.array([_step_parts_ms(st) for st in warm])
    med = np.median(parts, axis=0)
    # memory, per call and bucket: a bucket's first step also holds cuDNN's
    # autotuning workspace; its later steps must hold and peak at the same
    # bytes (nothing of an earlier step's graph survives). The first
    # validation builds the decoder's inference weight caches (about 50 MB,
    # kept from then on), so the steps before and after it are apart.
    by_bucket = collections.defaultdict(list)
    for call, run in enumerate((first.steps, second.steps)):
        for i, st in enumerate(run):
            by_bucket[(call, min(i // spe, 1), st["frames"])].append(st)
    peak_spread = held_spread = 0.0
    for runs in by_bucket.values():
        later = runs[1:]
        if len(later) > 1:
            peaks, held = [st["peak"] for st in later], [st["held"] for st in later]
            peak_spread = max(peak_spread, (max(peaks) - min(peaks)) / max(peaks))
            held_spread = max(held_spread, max(held) - min(held))
    idle = _profile_train_step(trainer)
    audio_per_step = TRAIN_BATCH * TRAIN_SEGMENT / 48000
    rates = [r["epoch/steps_per_sec"] * audio_per_step for r in epochs[:3]]
    emit({"phase": "train", "gpu": smi, "steps_per_epoch": spe, "steps": len(steps),
          "launches": counts, "launches_per_step": steps[-1]["launches"],
          "ms_per_step_median": float(med[3]), "ms_g_forward": float(med[0]),
          "ms_d_update": float(med[1]), "ms_g_backward_and_optimizer": float(med[2]),
          "ms_per_step_all": [float(v) for v in parts[:, 3]],
          "audio_s_per_wall_s_by_epoch": rates,
          "epoch_wall_s": [r["epoch/epoch_seconds"] for r in epochs],
          "first_call_wall_s": first_wall,
          "peak_gb_by_bucket": {f"call{k[0]}_T{k[2]}": max(st["peak"] for st in v) / 2 ** 30
                                for k, v in sorted(by_bucket.items())},
          "peak_gb_by_step": [st["peak"] / 2 ** 30 for st in steps],
          "held_gb_by_step": [st["held"] / 2 ** 30 for st in steps],
          "peak_spread_within_bucket": peak_spread, "held_spread_bytes": held_spread,
          "held_before_train_gb": held_before / 2 ** 30,
          "device_idle_share_one_step": idle["idle_share"], "trace": idle,
          "first_step_grad_norms": gsub,
          "validation": val[-1], "resumed_at": res["start_epoch"],
          "convert_samples": int(data.shape[0]),
          "kernel_shapes": [[str(v) if isinstance(v, torch.dtype) else v for v in sh]
                            for sh in shapes]})
    require(peak_spread <= 0.02, f"peak memory of one bucket varies by {peak_spread}")
    require(held_spread <= 16 << 20, f"memory held after a step grows by {held_spread} B")
    n_steps = len(first.steps)
    del trainer, first, second
    torch.cuda.empty_cache()
    return counts, shapes, grad_shapes, n_steps


# -- the model zoo: every vocoder, every rate, every discriminator ------------

# (tag, vocoder, rate) of the zoo's conversions: every preset rate, every
# vocoder once
ZOO_MODELS = (("nsf32", "HiFi-GAN", 32000), ("nsf40", "HiFi-GAN", 40000),
              ("mrf40", "MRF HiFi-GAN", 40000), ("refinegan32", "RefineGAN", 32000))
ZOO_FAMILIES = ("mpd_v1", "mrd", "msstft", "mssbcqt", "msd", "fregan_mpd", "mmsd")
ZOO_FAMILY_STEPS = 3
# (tag, vocoder, rate, discriminators, epochs of the first call, of the resume)
# one epoch each (and a resume to 2): the whole script stays under 720 s
ZOO_TRAININGS = (("mrf40", "MRF HiFi-GAN", 40000, "mpd,mrd", 1, 2),
                 ("refinegan32", "RefineGAN", 32000, "mpd,mssbcqt", 1, None))


def _zoo_launch_ok(vocoder: str, counts: dict) -> bool:
    """K2 runs every decoder's stage tails; K1 all but RefineGAN's."""
    return counts["resblock_chain"] > 0 and (vocoder == "RefineGAN"
                                             or counts["mrf_stage"] > 0)


def _decoder_timer(decoder):
    """CUDA events around each call of ``decoder``: (events, remove)."""
    import torch

    events = []

    def pre(mod, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append([ev])

    def post(mod, args, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1].append(ev)

    handles = [decoder.register_forward_pre_hook(pre), decoder.register_forward_hook(post)]
    return events, lambda: [h.remove() for h in handles]


def _zoo_conversions(smi: str, files: dict, root: str, rng):
    """Four 10 s conversions through the CLI's ``infer``, each with a
    full-width deployable .pth in the reference layout of its vocoder
    (random weights, numpy seed 0, scale 0.02) and the 65536 x 768 index;
    then the same file through one warm ``VoiceConverter``: wall (median of
    3), decoder device time, and no weight cache rebuilt."""
    import torch

    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.infer.converter import VoiceConverter
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.utils.audio_io import write_wav
    from rvc_tpu_torch.utils.checkpoints import export_rvc_pth

    wav = os.path.join(root, "zoo_in.wav")
    audio = _audio(10.0, np.random.default_rng(7))
    write_wav(wav, audio, 16000)
    audio = audio / max(np.abs(audio).max() / 0.95, 1.0)
    launches, shapes, rows = {}, {}, {}
    for tag, vocoder, sr in ZOO_MODELS:
        cfg = get_config(sr, vocoder=vocoder)
        synth = Synthesizer.from_config(cfg, device="cpu")
        _fill_random(synth, rng)
        pth = os.path.join(root, f"zoo_{tag}.pth")
        export_rvc_pth(synth, pth, cfg)
        del synth
        out = os.path.join(root, f"zoo_{tag}_out.wav")
        argv = ["infer", "--input_path", wav, "--output_path", out, "--pth_path", pth,
                *_flags(files)]
        path = f"zoo_{tag}"
        shapes[path] = record_path_shapes(lambda: _cli(argv, root))
        with _Probe() as probe:
            _reset_counts()
            cli_wall = _cli(argv, root)
            launches[path] = _counts()
        require(_zoo_launch_ok(vocoder, launches[path]) and launches[path]["knn_topk"] > 0,
                f"{tag}: kernels not launched: {launches[path]}")
        data = _check_wav(out, _windowed_len(probe.pipe, audio), f"zoo {tag}", sr)

        kw = dict(model_path=pth, index_path=files["index"], f0_method="rmvpe",
                  index_rate=0.75, protect=0.33, pitch=2)
        cwd = os.getcwd()
        os.chdir(root)
        try:
            vc = VoiceConverter()
            vc.convert_audio(wav, out, **kw)
            dec = vc.pipeline.synthesizer.dec
            builds = _weight_cache_builds(dec)
            events, remove = _decoder_timer(dec)
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                vc.convert_audio(wav, out, **kw)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            remove()
            rebuilt = _weight_cache_builds(dec) - builds
        finally:
            os.chdir(cwd)
        require(builds > 0 and rebuilt == 0,
                f"{tag}: weight caches built {builds}, rebuilt {rebuilt} by warm conversions")
        dec_ms = [a.elapsed_time(b) for a, b in events]
        rows[tag] = {"vocoder": vocoder, "sample_rate": sr, "samples": int(data.shape[0]),
                     "peak_abs": float(np.abs(data).max()), "launches": launches[path],
                     "cli_wall_s": cli_wall, "wall_s": statistics.median(walls),
                     "wall_s_all": walls, "decoder_ms": statistics.median(dec_ms),
                     "decoder_ms_all": dec_ms, "weight_cache_builds": builds}
        emit({"phase": "zoo_conversion", "gpu": smi, "model": tag, **rows[tag],
              "kernel_shapes": [[str(v) if isinstance(v, torch.dtype) else v for v in sh]
                                for sh in shapes[path]]})
        del vc
        gc.collect()
        torch.cuda.empty_cache()
    return launches, shapes, rows


def _zoo_small():
    """A small fp32 MRF HiFi-GAN and RefineGAN synthesizer on the card
    (kernels) against the same on the CPU (plain versions), within 1e-3."""
    import torch

    from rvc_tpu_torch.configs import get_config

    errs = {}
    for vocoder in ("MRF HiFi-GAN", "RefineGAN"):
        cfg = get_config(48000, vocoder=vocoder, **TINY_MODEL)
        rng = np.random.default_rng(3)
        t = 40
        inputs = [rng.normal(size=(2, t, 768)).astype(np.float32), np.array([t, t - 9]),
                  rng.integers(1, 256, size=(2, t)), 150 + 100 * rng.random((2, t)),
                  np.array([1, 2])]
        outs = {}
        for device in ("cpu", "cuda"):
            synth = _synth(cfg, True, device)
            _fill_random(synth, np.random.default_rng(4), 0.1)
            args = [torch.from_numpy(np.asarray(a)).to(device) for a in inputs]
            args[3] = args[3].float()
            _reset_counts()
            outs[device] = synth.infer(*args)[0].float().cpu()
            counts = _counts()
        err = float((outs["cpu"] - outs["cuda"]).abs().max())
        errs[vocoder] = {"max_abs_err_vs_cpu_plain": err, "launches": counts,
                         "samples": int(outs["cuda"].shape[1])}
        require(err <= 1e-3, f"small {vocoder}: card vs CPU plain {err} > 1e-3")
        require(counts["resblock_chain"] > 0, f"small {vocoder}: K2 not launched: {counts}")
    return errs


def _zoo_batch(b: int, frames: int, device):
    """A seeded full-width 48 kHz training batch (numpy seed 8)."""
    import torch

    rng = np.random.default_rng(8)
    tt = np.arange(frames * 480) / 48000
    batch = {"phone": rng.normal(size=(b, frames, 768)).astype(np.float32),
             "phone_lengths": np.full(b, frames, np.int32),
             "pitch": rng.integers(1, 256, size=(b, frames)).astype(np.int64),
             "pitchf": np.full((b, frames), 180.0, np.float32),
             "spec": np.abs(rng.normal(size=(b, frames, 1025))).astype(np.float32),
             "spec_lengths": np.full(b, frames, np.int32),
             "wave": (0.3 * np.sin(2 * np.pi * 180 * tt)[None, :, None]
                      + 0.02 * rng.normal(size=(b, frames * 480, 1))).astype(np.float32),
             "sid": np.arange(b, dtype=np.int64) % 2}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _zoo_families(smi: str):
    """Each discriminator family of the JAX registry, at full width, in
    ``ZOO_FAMILY_STEPS`` training steps with the 48 kHz NSF generator
    (bf16, batch 8, 17 280-sample slices, cuDNN autotuning off): finite
    losses at every step; after step 1 every D parameter's gradient finite
    and none all zero; ms per warm step, D forward + backward ms, peak
    memory."""
    import dataclasses

    import torch

    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.custom_discriminators import build_discriminator
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.train import losses as L
    from rvc_tpu_torch.train.optimizers import module_optimizer
    from rvc_tpu_torch.train.step import TrainStep
    from rvc_tpu_torch.train.trainer import init_parameters

    cfg = get_config(48000)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=TRAIN_BATCH, segment_size=TRAIN_SEGMENT, bf16_run=True))
    gen = torch.Generator().manual_seed(11)
    g = Synthesizer.from_config(cfg, device="cuda", train=True)
    init_parameters(g, gen)
    batch = _zoo_batch(TRAIN_BATCH, 40, "cuda")
    rows = {}
    for name in ZOO_FAMILIES:
        d = build_discriminator([name], 48000).cuda()
        init_parameters(d, gen)
        step = TrainStep(cfg, g, d, module_optimizer("adamw", g, 1e-4),
                         module_optimizer("adamw", d, 1e-4))
        first_grads, orig_step = [], step.opt_d.step

        def opt_d_step(grads, _orig=orig_step):
            if not first_grads:
                first_grads.append([gr.detach().float().clone() for gr in grads])
            return _orig(grads)

        step.opt_d.step = opt_d_step
        events, losses = [], []
        torch.cuda.reset_peak_memory_stats()
        sgen = torch.Generator().manual_seed(12)
        for _ in range(ZOO_FAMILY_STEPS):
            evs = {}

            def mark(part, evs=evs):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                evs[part] = ev

            step.mark = mark
            m = step(batch, sgen)
            events.append(evs)
            losses.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        for i, ls in enumerate(losses):
            require(all(np.isfinite(v) for v in ls.values()), f"{name} step {i}: {ls}")
        names = [n for n, _ in d.named_parameters()]
        bad = [n for n, gr in zip(names, first_grads[0])
               if not bool(torch.isfinite(gr).all()) or float(gr.abs().max()) == 0.0]
        require(not bad, f"{name}: D gradients not finite or all zero after step 1: {bad[:6]}")
        step_ms = [e["g_forward"].elapsed_time(e["end"]) for e in events[1:]]
        wave = batch["wave"][:, :TRAIN_SEGMENT]
        fake = torch.tanh(wave * 1.3)

        def d_fwd_bwd():
            r, f, _, _ = step.d_apply(wave, fake)
            return torch.autograd.grad(L.discriminator_loss(r, f), step.d_params)

        rows[name] = {"ms_per_warm_step": statistics.median(step_ms),
                      "ms_per_warm_step_all": step_ms,
                      "d_fwd_bwd_ms": gpu_time_ms(d_fwd_bwd, 3),
                      "peak_gb": peak / 2 ** 30, "d_params": sum(p.numel() for p in d.parameters()),
                      "losses_last": losses[-1]}
        emit({"phase": "zoo_family", "gpu": smi, "family": name, **rows[name]})
        del d, step, first_grads
        gc.collect()
        torch.cuda.empty_cache()
    del g
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _zoo_trainings(smi: str, files: dict, root: str, rng):
    """``train`` through the CLI at full width with MRF HiFi-GAN at 40 kHz
    (mpd + mrd, 1 epoch, then a resume to 2) and RefineGAN at 32 kHz (mpd
    + mssbcqt, 1 epoch), each on 40 clips at its rate: per step finite
    losses and the decoder's K1/K2 launches, every G and D group's gradient
    after step 1, the resume, and the exported deployable .pth converting
    10 s to finite audio of the right length."""
    import torch

    from rvc_tpu_torch.train.step import grad_group
    from rvc_tpu_torch.utils.audio_io import write_wav

    wav = os.path.join(root, "zoo_train_in.wav")
    audio = _audio(10.0, np.random.default_rng(13))
    write_wav(wav, audio, 16000)
    audio = audio / max(np.abs(audio).max() / 0.95, 1.0)
    launches, shapes, rows = {}, {}, {}
    grad_uses = {}  # stage or chain shape -> {path: calls per step}
    for tag, vocoder, sr, discs, epochs, resume_to in ZOO_TRAININGS:
        name = f"zoo_{tag}"
        exp = os.path.join(root, "logs", name)
        os.makedirs(exp, exist_ok=True)
        _write_train_dataset(exp, rng, sr)
        argv = ["train", "--model_name", name, "--sample_rate", str(sr), "--vocoder",
                vocoder, "--discriminators", discs, "--save_every_epoch", "1",
                "--pretrained", "False", "--batch_size", str(TRAIN_BATCH),
                "--save_only_latest", "True", "--use_benchmark", "False"]
        path = f"zoo_train_{tag}"
        _reset_counts()
        t0 = time.perf_counter()
        grad_shapes = []
        with _TrainProbe() as first:
            shapes[path] = record_path_shapes(
                lambda: _cli(argv + ["--total_epoch", str(epochs)], root), grad_shapes)
        wall = time.perf_counter() - t0
        for k, n in collections.Counter(map(_shape_key, grad_shapes)).items():
            grad_uses.setdefault(k, {})[path] = n / len(first.steps)
        launches[path] = _counts()
        spe = first.trainer.steps_per_epoch
        g_names = [n for n, _ in first.trainer.model_g.named_parameters()]
        nk = getattr(first.trainer.model_g.dec, "num_kernels", 1)
        d_groups = {first.trainer.model_d.group_of(n)
                    for n, _ in first.trainer.model_d.named_parameters()}
        first.trainer = None
        gc.collect()
        torch.cuda.empty_cache()
        steps = list(first.steps)
        resumed = None
        if resume_to:
            with _TrainProbe() as second:
                _cli(argv + ["--total_epoch", str(resume_to)], root)
            steps += second.steps
            resumed = second.resumed
            require(resumed is not None and resumed["start_epoch"] == epochs + 1
                    and resumed["step"] == epochs * spe,
                    f"{tag} resume: {resumed and (resumed['start_epoch'], resumed['step'])}")
            second.trainer = None
            gc.collect()
            torch.cuda.empty_cache()
        for i, st in enumerate(steps):
            m = {k: float(v) for k, v in st["metrics"].items()}
            require(all(np.isfinite(v) for v in m.values()), f"{tag} step {i}: {m}")
            require(_zoo_launch_ok(vocoder, st["launches"]),
                    f"{tag} step {i}: K1/K2 launches {st['launches']}")
        gsub = {k: float(v) for k, v in first.steps[0]["metrics"].items()
                if k.startswith("gsub_")}
        groups = sorted({f"gsub_g/{grp}" for n in g_names for grp in grad_group(n, nk)}
                        | {f"gsub_d/{grp}" for grp in d_groups})
        dead = [k for k in groups if not (np.isfinite(gsub.get(k, np.nan))
                                          and gsub.get(k, 0.0) > 0)]
        require(not dead, f"{tag}: no gradient after step 1 in {dead}")
        last = resume_to or epochs
        out = os.path.join(root, f"{name}_conv.wav")
        with _Probe() as probe:
            _cli(["infer", "--input_path", wav, "--output_path", out, "--pth_path",
                  os.path.join(exp, f"{name}_{last}e.pth"), "--f0_method", "rmvpe",
                  "--index_path", files["index"], "--index_rate", "0.75"], root)
        data = _check_wav(out, _windowed_len(probe.pipe, audio), f"{tag} trained", sr)
        parts = np.array([_step_parts_ms(st) for st in first.steps[2:]] or [[np.nan] * 4])
        recs = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
        rows[tag] = {"vocoder": vocoder, "sample_rate": sr, "discriminators": discs,
                     "steps_per_epoch": spe, "steps": len(steps), "first_call_wall_s": wall,
                     "epoch_wall_s": [r["epoch/epoch_seconds"] for r in recs
                                      if "epoch/epoch_seconds" in r],
                     "ms_per_step_median": float(np.median(parts[:, 3])),
                     "launches": launches[path], "launches_per_step": steps[-1]["launches"],
                     "grad_groups_checked": len(groups),
                     "resumed_at": resumed and resumed["start_epoch"],
                     "convert_samples": int(data.shape[0]),
                     "peak_gb": max(st["peak"] for st in steps) / 2 ** 30}
        emit({"phase": "zoo_train", "gpu": smi, "model": tag, **rows[tag]})
    return launches, shapes, grad_uses, rows


def phase_zoo(smi: str, files: dict, root: str):
    """The rest of the model zoo at full width, bf16, random weights from
    numpy seed 0 (scale 0.02), through ``rvc_tpu_torch.cli.main`` on the
    files of phase ``files``: (a) four 10 s conversions, NSF HiFi-GAN at 32
    and 40 kHz, MRF HiFi-GAN at 40 kHz, RefineGAN at 32 kHz; (b) small fp32
    MRF HiFi-GAN and RefineGAN models on the card against the CPU; (c) each
    discriminator family in training steps; (d) two ``train`` runs. Returns
    (launches and shapes by path, stage or chain shape -> {training path:
    calls per step})."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    launches, shapes, conv = _zoo_conversions(smi, files, root, rng)
    small = _zoo_small()
    emit({"phase": "zoo_small", "gpu": smi, "tol": 1e-3, **small})
    switches = _cuda_switches()
    _cuda_switches([False, False, False, False])
    try:
        families = _zoo_families(smi)
        t_launches, t_shapes, grad_uses, trains = _zoo_trainings(smi, files, root, rng)
    finally:
        _cuda_switches(switches)
    launches.update(t_launches)
    shapes.update(t_shapes)
    emit({"phase": "zoo", "gpu": smi, "seconds": time.perf_counter() - t0,
          "conversions": {k: {f: v[f] for f in ("wall_s", "decoder_ms", "samples")}
                          for k, v in conv.items()},
          "families": {k: {f: v[f] for f in ("ms_per_warm_step", "d_fwd_bwd_ms", "peak_gb")}
                       for k, v in families.items()},
          "trainings": {k: {f: v[f] for f in ("ms_per_step_median", "epoch_wall_s", "steps")}
                        for k, v in trains.items()}})
    return launches, shapes, grad_uses


# -- the dataset path: preprocess, extract, train, index, every f0 method ------

# phase `fx`: the output effects, formant shifting, clean_audio and export
FX_FLAGS = ["--post_process", "True", "--reverb", "True", "--pitch_shift", "True",
            "--limiter", "True", "--gain", "True", "--distortion", "True",
            "--chorus", "True", "--bitcrush", "True", "--clipping", "True",
            "--compressor", "True", "--delay", "True",
            "--pitch_shift_semitones", "2", "--compressor_ratio", "4"]
FX_ALL = ["--formant_shifting", "True", "--formant_timbre", "1.2",
          "--clean_audio", "True", *FX_FLAGS]
# card against the CPU on 2 s of a tone over noise: the effects' steps are
# float64 where numpy's are, and float32 where numpy's are (the STFTs of a
# float32 signal); a gate bin at its threshold may fall on the other side
# (the mask moves by one kernel weight, 1/90 at 48 kHz); in the chain,
# distortion's drive (x17.8) carries the pitch shift's float32 STFT
# rounding into bitcrush, which may then move a sample one step (1/128)
FX_TOL = {"effect": 1e-5, "chain": 1e-5, "formant": 1e-4, "gate": 1e-3}
LSB = 1.0 / 32768  # one step of a 16-bit file


def _voice48(seconds: float, rng) -> np.ndarray:
    """48 kHz test audio: a 220 Hz tone and its third harmonic under a slow
    tremolo with gaps, over a little noise."""
    t = np.arange(int(seconds * 48000)) / 48000
    tone = np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 660 * t)
    env = (0.6 + 0.4 * np.sin(2 * np.pi * 2 * t)) * ((t % 0.4) < 0.3)
    return (0.5 * env * tone + 0.03 * rng.normal(size=t.size)).astype(np.float32)


def _batch_files(root: str) -> tuple:
    """The `batch` phase's four files (3, 5, 8, 11 s), written once."""
    from rvc_tpu_torch.utils.audio_io import write_wav

    src = os.path.join(root, "batch_in")
    lengths = {"a": 3.0, "b": 5.0, "c": 8.0, "d": 11.0}
    if not os.path.isdir(src):
        os.makedirs(src)
        for i, (name, sec) in enumerate(lengths.items()):
            write_wav(os.path.join(src, f"{name}.wav"),
                      _audio(sec, np.random.default_rng(20 + i)), 16000)
    return src, lengths


def _fx_kwargs(argv) -> dict:
    """``convert_audio``'s keyword arguments for a list of CLI flags."""
    from rvc_tpu_torch.cli import build_parser, collect_infer_kwargs

    args = build_parser().parse_args(["infer", "--input_path", "-", "--output_path",
                                      "-", "--pth_path", "-", *argv])
    kw = collect_infer_kwargs(args)
    return {flag[2:]: kw[flag[2:]] for flag in argv[::2]}


def _cpu_time_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of a CPU call, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_fx(smi: str, files: dict, root: str):
    """The rest of the user's offline CLI on the card. ``infer`` on 10 s
    with everything on (formant shifting at timbre 1.2, ``--clean_audio``,
    all ten effects with a 2-semitone shift and a 4:1 compressor, FLAC
    export): the kernels' launches, the FLAC read back equal to the WAV
    beside it, finite samples of ``_p_len``'s length. ``batch_infer`` of
    the `batch` phase's four files with the chain on, in one device batch:
    each file's chain output held to the chain run again on that file's
    packed conversion (the rows draw their flow noise from one generator, so
    a packed file is not its one-by-one conversion). Each effect, the
    chain, formant shifting and the gate on 2 s of a tone over noise on the
    card against the CPU (the chain on the converted output reported too);
    each effect's, the chain's, formant's and the gate's ms on 10 s (CUDA
    events, median of 3 warm runs) and on the card host's CPU (host clock);
    the warm ``VoiceConverter`` wall of 10 s with and without everything on,
    in turns. Then
    the tools: ``model_blender`` of the files' model with a second seed,
    ``model_information`` of the blend, a 10 s conversion with it,
    ``audio_analyzer`` of that, and ``check_environment``'s report."""
    import torch

    from rvc_tpu_torch.infer import converter as conv
    from rvc_tpu_torch.infer import postprocess as fx
    from rvc_tpu_torch.infer.formant import formant_shift
    from rvc_tpu_torch.ops.sps_stft import stft
    from rvc_tpu_torch.utils.audio_io import write_wav
    from rvc_tpu_torch.utils.checkpoints import export_rvc_pth
    from rvc_tpu_torch.utils.env_check import check_environment
    from rvc_tpu_torch.utils.native import flac_read

    t_phase = time.perf_counter()
    emit({"phase": "fx_env", "report": check_environment(verbose=False)})
    rng = np.random.default_rng(40)
    wav = os.path.join(root, "fx_in.wav")
    write_wav(wav, _audio(10.0, rng), 16000)
    out = os.path.join(root, "fx_out.wav")
    argv = ["infer", "--input_path", wav, "--output_path", out,
            "--pth_path", files["pth"], *_flags(files), *FX_ALL, "--export_format", "FLAC"]
    shapes = record_path_shapes(lambda: _cli(argv, root))
    with _Probe() as probe:
        _reset_counts()
        cli_wall = _cli(argv, root)
        counts = _counts()
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched on the fx path")
    pipe = probe.pipe
    n_out = _segment_len(pipe, 160000 + 2 * pipe.t_pad) - 2 * pipe.t_pad_tgt
    data = _check_wav(out, n_out, "fx infer")
    flac, flac_sr = flac_read(os.path.splitext(out)[0] + ".flac")
    require(flac_sr == 48000 and flac.shape == data.shape
            and float(np.abs(flac - data).max()) <= LSB,
            f"fx: the FLAC does not read back as the WAV ({flac.shape}, {flac_sr} Hz)")

    # batch_infer with the chain on: each file's output is the chain on its row
    src, lengths = _batch_files(root)
    seen = []
    effects = conv.VoiceConverter._output_effects

    def record(vc, audio, *a):
        got = effects(vc, audio, *a)
        seen.append((audio, got, vc.tgt_sr))
        return got

    conv.VoiceConverter._output_effects = record
    try:
        with _Probe() as probe:
            _reset_counts()
            batch_wall = _cli(["batch_infer", "--input_folder", src, "--output_folder",
                               os.path.join(root, "fx_batch"), "--pth_path", files["pth"],
                               *_flags(files), *FX_FLAGS], root)
            batch_counts, rows, bpipe = _counts(), probe.rows, probe.pipe
    finally:
        conv.VoiceConverter._output_effects = effects
    require(rows == [4] and len(seen) == 4, f"fx batch: rows {rows}, {len(seen)} outputs")
    for name, c in batch_counts.items():
        require(c > 0, f"kernel {name} was not launched on the fx batch path")
    chain_kw = _fx_kwargs(FX_FLAGS)
    batch_err = 0.0
    t_bucket = bpipe._bucket_len(int(max(lengths.values()) * 16000) + 2 * bpipe.t_pad)
    for name, (before, after, sr) in zip(sorted(lengths), seen):
        again = fx.apply_post_process(torch.from_numpy(before).cuda(), sr, **chain_kw)
        n16 = int(lengths[name] * 16000) + 2 * bpipe.t_pad
        written = _check_wav(os.path.join(root, "fx_batch", f"{name}_output.wav"),
                             bpipe._p_len(n16, t_bucket) * bpipe.upp - 2 * bpipe.t_pad_tgt,
                             f"fx batch {name}")
        require(written.shape == after.shape == before.shape, f"fx batch {name}: length")
        batch_err = max(batch_err, float(np.abs(again.cpu().numpy() - after).max()))
        require(float(np.abs(written - after).max()) <= LSB,
                f"fx batch {name}: the file is not the chain's output")
    require(batch_err <= 1e-6, f"fx batch: the chain again differs by {batch_err}")

    # the card against the CPU on 2 s of a tone over noise, each effect
    # alone and in the chain; on the converted output too, reported only:
    # the phase vocoder carries a bin's phase from frame to frame, and where
    # a bin is at rounding level (a constant or silent frame of the clipped,
    # bitcrushed output) two FFT libraries give it different phases
    y48 = torch.from_numpy(_voice48(2.0, np.random.default_rng(41)))
    x16 = torch.from_numpy(_audio(2.0, np.random.default_rng(41)))
    effect_kw = {"pitch_shift": {"semitones": 2.0}, "compressor": {"ratio": 4.0}}
    funcs = {name: (lambda a, n=name: getattr(fx, n)(a, 48000, **effect_kw.get(n, {})),
                    y48, "effect") for name in fx.EFFECT_ORDER}
    funcs.update({
        "chain": (lambda a: fx.apply_post_process(a, 48000, **chain_kw), y48, "chain"),
        "formant": (lambda a: formant_shift(a, 16000, 1.0, 1.2), x16, "formant"),
        "gate": (lambda a: fx.spectral_gate(a, 48000, 0.7), y48, "gate")})
    vs_cpu = {}
    for name, (f, a, kind) in funcs.items():
        diff = np.abs(f(a.cuda()).cpu().numpy() - f(a).numpy())
        over = diff > FX_TOL[kind]
        vs_cpu[name] = {"max_abs_diff": float(diff.max()), "tol": FX_TOL[kind],
                        "samples_over_tol": int(over.sum())}
        ok = (not over.any() if name != "chain"
              else over.sum() <= diff.size // 1000 and diff.max() <= 1 / 128 + FX_TOL[kind])
        require(ok, f"fx {name}: card vs CPU {vs_cpu[name]}")
    out2s = torch.from_numpy(data[:96000].copy())
    chain_f = funcs["chain"][0]
    diff = np.abs(chain_f(out2s.cuda()).cpu().numpy() - chain_f(out2s).numpy())
    stages, cur = {}, out2s  # each effect on the CPU chain's input to it
    for name in fx.EFFECT_ORDER:
        ref = funcs[name][0](cur)
        stages[name] = float((funcs[name][0](cur.cuda()).cpu() - ref).abs().max())
        cur = ref
    bins = stft(out2s, 2048, 512).abs()
    vs_cpu["chain_on_output"] = {
        "max_abs_diff": float(diff.max()), "samples_over_1e-5": int((diff > 1e-5).sum()),
        "each_effect_max_abs_diff": stages, "distinct_values": int(out2s.unique().numel()),
        "stft_bins_under_1e-6_of_max": float((bins < 1e-6 * bins.max()).double().mean())}

    # times on 10 s: each effect, the chain, formant (16 kHz in) and the gate
    y = torch.from_numpy(data)
    x = torch.from_numpy(_audio(10.0, np.random.default_rng(42)))
    ms, cpu_ms = {}, {}
    for name, (f, a, _) in funcs.items():
        a = x if name == "formant" else y
        a_dev = a.cuda()
        ms[name] = gpu_time_ms(lambda: f(a_dev), 3)
        cpu_ms[name] = _cpu_time_ms(lambda: f(a))

    # the warm converter's wall on 10 s, without and with everything on
    base_kw = dict(model_path=files["pth"], index_path=files["index"], f0_method="rmvpe",
                   index_rate=0.75, protect=0.33, pitch=2)
    all_kw = {**base_kw, **_fx_kwargs(FX_ALL), "export_format": "FLAC"}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        vc = conv.VoiceConverter()
        walls = {"plain": [], "everything_on": []}
        kws = {"plain": base_kw, "everything_on": all_kw}
        for label, kw in kws.items():  # warm-up
            vc.convert_audio(wav, os.path.join(root, f"fx_w_{label}.wav"), **kw)
        # in turns, each side first as often: plain, on, on, plain, plain, on
        for label in ("plain", "everything_on", "everything_on", "plain", "plain",
                      "everything_on"):
            t0 = time.perf_counter()
            vc.convert_audio(wav, os.path.join(root, f"fx_w_{label}.wav"), **kws[label])
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
        del vc

        # the tools: blend with a second full-width seed, inspect, convert, analyze
        cfg = _config(False)
        second = _synth(cfg, False, "cpu")
        _fill_random(second, np.random.default_rng(1))
        other = os.path.join(root, "model_b.pth")
        export_rvc_pth(second, other, cfg)
        del second
        t0 = time.perf_counter()
        _cli(["model_blender", "--model_name", "fx_blend", "--pth_path_1", files["pth"],
              "--pth_path_2", other, "--ratio", "0.5"], root)
        blend_s = time.perf_counter() - t0
        blend = os.path.join(root, "logs", "fx_blend.pth")
        _cli(["model_information", "--pth_path", blend], root)
        blend_out = os.path.join(root, "fx_blend_out.wav")
        _cli(["infer", "--input_path", wav, "--output_path", blend_out,
              "--pth_path", blend, *_flags(files)], root)
        _check_wav(blend_out, n_out, "fx blend infer")
        from rvc_tpu_torch.utils.analyzer import analyze_audio

        stats, _ = analyze_audio(blend_out, device="cuda")
        require(all(np.isfinite(v) for v in stats.values()), f"analyzer: {stats}")
        _cli(["audio_analyzer", "--input_path", out, "--device", "cuda"], root)
    finally:
        os.chdir(cwd)
    torch.cuda.empty_cache()
    emit({"phase": "fx", "gpu": smi, "launches": counts, "batch_launches": batch_counts,
          "samples": int(data.shape[0]), "cli_wall_s": cli_wall, "batch_cli_wall_s": batch_wall,
          "batch_rows": rows, "batch_chain_again_max_abs_diff": batch_err,
          "card_vs_cpu": vs_cpu, "ms_10s": ms, "cpu_ms_10s": cpu_ms,
          "converter_wall_s": {k: statistics.median(v) for k, v in walls.items()},
          "converter_wall_s_all": walls, "blend_s": blend_s,
          "blend_analyzer": stats, "phase_s": time.perf_counter() - t_phase,
          "kernel_shapes": [[str(v) if isinstance(v, torch.dtype) else v for v in sh]
                            for sh in shapes]})
    return counts, shapes


PREP_SR = 44100
PREP_FILES = 20            # 10 16-bit stereo, 10 float mono
PREP_FILE_S = 30           # 20 x 30 s = 10 minutes
PREP_REJECTED = 19         # the take that peaks at 3.0
BIG_ROWS = 360_000         # 2 h of one speaker at 50 frames/s
BIG_FILE_ROWS = 10_000
PREP_F0_METHODS = ("crepe", "crepe-tiny", "fcpe", "yin", "hybrid[rmvpe+fcpe]")


def _prep_take(rng, leading: float) -> np.ndarray:
    """30 s at 44.1 kHz: tones with vibrato and noise, 1.5-4 s each, between
    silences of 0.2, 0.5, 0.8 and 1.5 s (the Slicer's kept, short, medium
    and long cases), after a leading silence."""
    sr = PREP_SR
    parts = [0.003 * rng.normal(size=int(leading * sr))]
    i = 0
    while sum(map(len, parts)) < PREP_FILE_S * sr:
        n = int(rng.uniform(1.5, 4.0) * sr)
        t = np.arange(n) / sr
        f = rng.uniform(110.0, 330.0) * (1 + 0.03 * np.sin(2 * np.pi * 5.5 * t))
        ramp = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.05)
        phase = 2 * np.pi * np.cumsum(f) / sr
        parts.append(ramp * (0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase))
                     + 0.01 * rng.normal(size=n))
        parts.append(0.003 * rng.normal(size=int((0.2, 0.5, 0.8, 1.5)[i % 4] * sr)))
        i += 1
    return np.concatenate(parts)[:PREP_FILE_S * sr].astype(np.float32)


def _write_prep_dataset(data_dir: str, rng) -> None:
    """Speaker 0's ten 16-bit stereo takes in the dataset's root, speaker
    1's ten float mono takes in ``speaker_1/``; the last peaks at 3.0."""
    from rvc_tpu_torch.utils.audio_io import write_wav

    for i in range(PREP_FILES):
        x = _prep_take(rng, leading=(0.0, 0.8, 1.5)[i % 3])
        if i < PREP_FILES // 2:
            stereo = np.stack([x, 0.8 * x + 0.002 * rng.normal(size=x.size)], axis=1)
            write_wav(os.path.join(data_dir, f"take{i:02d}.wav"), stereo, PREP_SR)
        else:
            if i == PREP_REJECTED:
                x = x * (3.0 / np.abs(x).max())
            write_wav(os.path.join(data_dir, "speaker_1", f"take{i:02d}.wav"), x,
                      PREP_SR, "FLOAT")


def _write_big_features(exp: str, rng) -> None:
    """360 000 x 768 float32 features around 2000 centres, as ``extracted``
    files of 10 000 rows."""
    centres = rng.normal(size=(2000, 768)).astype(np.float32)
    os.makedirs(os.path.join(exp, "extracted"), exist_ok=True)
    for i in range(BIG_ROWS // BIG_FILE_ROWS):
        x = centres[rng.integers(0, len(centres), BIG_FILE_ROWS)]
        x += 0.5 * rng.standard_normal((BIG_FILE_ROWS, 768), dtype=np.float32)
        np.save(os.path.join(exp, "extracted", f"0_{i}_0.npy"), x)


def _write_f0_checkpoints(pred_dir: str, rng) -> dict:
    """Seeded crepe.pt (full and tiny) and fcpe.pt in the torchcrepe and
    torchfcpe layouts; returns their paths."""
    import torch

    from rvc_tpu_torch.predictors.crepe import CrepeModel
    from rvc_tpu_torch.predictors.fcpe import CFNaiveMelPE

    out = {}
    for cap in ("full", "tiny"):
        m = CrepeModel(cap)
        _fill_random(m, rng, 0.1)
        out[f"crepe_{cap}"] = os.path.join(pred_dir, f"crepe_{cap}.pt")
        torch.save(m.state_dict(), out[f"crepe_{cap}"])
    m = CFNaiveMelPE()
    _fill_random(m, rng, 0.1)
    sd = m.state_dict()
    w = sd.pop("output_proj.weight")  # weight-normed, as torchfcpe saves it
    sd["output_proj.weight_g"] = torch.linalg.norm(w, dim=1, keepdim=True)
    sd["output_proj.weight_v"] = w
    out["fcpe"] = os.path.join(pred_dir, "fcpe.pt")
    torch.save({"model": sd, "config_dict": {"model": {"n_heads": 8}}}, out["fcpe"])
    return out


def _f0_and_voicing(method: str, fn, audio: np.ndarray):
    """A predictor's f0 of ``audio``, and its raw voicing decision per 10 ms
    frame with the confidence it compares and the threshold."""
    import torch

    from rvc_tpu_torch.predictors.bucketing import bucket_samples, reflect_to
    from rvc_tpu_torch.predictors.cents import CENTS_MAPPING

    f0 = np.asarray(fn(audio), np.float64)
    obj = getattr(fn, "__self__", None)
    if method.startswith("crepe"):
        x = torch.from_numpy(np.pad(audio, (512, 512))).to(obj.device).unfold(0, 1024, 160)
        keep = ((CENTS_MAPPING >= 1200 * np.log2(50.0 / 10.0))
                & (CENTS_MAPPING <= 1200 * np.log2(1100.0 / 10.0)))
        conf, thr = obj.salience(x).float().cpu().numpy()[:, keep].max(axis=1), 1e-3
        return f0, conf >= thr, conf, thr
    if method == "fcpe":
        padded = reflect_to(audio, bucket_samples(len(audio)))[None]
        lat = obj.latent(torch.from_numpy(padded).to(obj.device), padded.shape[1] // 160)
        conf = lat[0].max(dim=-1).values.float().cpu().numpy()[:len(audio) // 160]
        return f0, conf > 0.05, conf, 0.05
    if method == "rmvpe":
        sal = obj.salience_batch([audio])[0].cpu().numpy()[:len(audio) // 160 + 1]
        conf = sal.max(axis=1)
        return f0, conf > 0.03, conf, 0.03
    return f0, f0 > 0, None, None  # yin: its voicing is its f0


def _f0_card_vs_cpu(paths: dict, audio: np.ndarray) -> dict:
    """Each predictor from the same checkpoint on the card and on the CPU,
    both in float32: f0 within 1e-3 relative on the frames both voice, and
    the voicing equal except on frames whose confidence is within 1e-4 of
    the threshold."""
    from rvc_tpu_torch.predictors.f0_extractor import build_predictors

    out = {}
    for method, crepe in (("rmvpe", None), ("crepe", "crepe_full"),
                          ("crepe-tiny", "crepe_tiny"), ("fcpe", None), ("yin", None)):
        kw = dict(rmvpe_ckpt=paths["rmvpe"], fcpe_ckpt=paths["fcpe"],
                  crepe_ckpt=paths[crepe] if crepe else None)
        res = {dev: _f0_and_voicing(method, build_predictors((method,), device=dev,
                                                             **kw)[method], audio)
               for dev in ("cuda", "cpu")}
        (f_gpu, v_gpu, c_gpu, thr), (f_cpu, v_cpu, c_cpu, _) = res["cuda"], res["cpu"]
        require(f_gpu.shape == f_cpu.shape, f"{method}: f0 {f_gpu.shape} vs {f_cpu.shape}")
        both = (f_gpu > 0) & (f_cpu > 0)
        rel = float((np.abs(f_gpu - f_cpu)[both] / f_cpu[both]).max()) if both.any() else 0.0
        flips = v_gpu != v_cpu
        near = (np.abs(c_cpu - thr) <= 1e-4) if c_cpu is not None else np.zeros_like(flips)
        conf_rel = (float(np.abs(c_gpu - c_cpu).max() / np.abs(c_cpu).max())
                    if c_cpu is not None else None)
        out[method] = {"frames": int(f_cpu.size), "voiced_frames": int(v_cpu.sum()),
                       "f0_max_rel_err": rel, "confidence_max_rel_err": conf_rel,
                       "voicing_flips": int(flips.sum()),
                       "voicing_flips_near_threshold": int((flips & near).sum())}
        require(both.sum() > 0, f"{method}: no voiced frame on both devices")
        require(rel <= 1e-3, f"{method}: f0 on the card vs the CPU: rel err {rel}")
        require(not (flips & ~near).any(),
                f"{method}: voicing differs away from the threshold: {out[method]}")
    return out


def phase_prep(smi: str, root: str, files: dict):
    """The dataset path through ``rvc_tpu_torch.cli.main`` on the card, from
    numpy seed 0: a 10-minute dataset at 44.1 kHz (``preprocess`` with
    effects and noise reduction), ``extract`` (rmvpe, batch 8, two mute rows
    per speaker), one full-width epoch of ``train`` and the index it builds
    (each in a process of its own: with the defaults, then with cuDNN's
    autotuning off),
    ``index --index_algorithm KMeans --export_faiss`` (10 000 centroids,
    K3 at k = 1), ``infer`` of 10 s with the trained model and that index;
    ``build_index`` at a user's scale (360 000 x 768 -> 10 000 centroids);
    ``infer`` with every other f0 method. Then, outside the counted run,
    K3's ms per assignment at 360 000 x 10 000 x 768 against its bound and
    cdist + argmin, and each predictor on the card against the CPU."""
    import torch

    from rvc_tpu_torch.ops import retrieval as rt
    from rvc_tpu_torch.ops.retrieval import FeatureIndex
    from rvc_tpu_torch.train.index_builder import build_index
    from rvc_tpu_torch.utils.audio_io import load_audio, wav_frames, write_wav
    from rvc_tpu_torch.utils.faiss_io import read_index_vectors

    rng = np.random.default_rng(0)
    t_start = time.perf_counter()
    data_dir = os.path.join(root, "prep_dataset")
    os.makedirs(os.path.join(data_dir, "speaker_1"), exist_ok=True)
    _write_prep_dataset(data_dir, rng)
    exp = os.path.join(root, "logs", "prep")
    big = os.path.join(root, "logs", "big")
    _write_big_features(big, rng)
    f0_paths = _write_f0_checkpoints(os.path.dirname(files["rmvpe"]), rng)
    f0_paths["rmvpe"] = files["rmvpe"]
    crepe_pt = os.path.join(os.path.dirname(files["rmvpe"]), "crepe.pt")
    wav10 = os.path.join(root, "prep_in.wav")
    audio10 = _audio(10.0, np.random.default_rng(9))
    write_wav(wav10, audio10, 16000)
    setup_s = time.perf_counter() - t_start
    res, walls = {}, {}

    def cli(step, argv):
        walls[step] = _cli(argv, root)
        emit({"phase": "prep_step", "step": step, "wall_s": walls[step]})

    def run():
        # preprocess
        cli("preprocess", ["preprocess", "--model_name", "prep", "--dataset_path", data_dir,
                           "--sample_rate", "48000", "--cut_preprocess", "Automatic",
                           "--process_effects", "True", "--noise_reduction", "True"])
        with open(os.path.join(exp, "model_info.json")) as f:
            res["total_dataset_duration"] = json.load(f)["total_dataset_duration"]
        seg = sorted(os.listdir(os.path.join(exp, "sliced_audios_16k")))
        res["segments"] = len(seg)
        # extract
        cli("extract", ["extract", "--model_name", "prep", "--sample_rate", "48000",
                        "--f0_method", "rmvpe", "--include_mutes", "2", "--batch_size", "8"])
        n16 = {n[:-4]: wav_frames(os.path.join(exp, "sliced_audios_16k", n)) for n in seg}
        res["extract_audio_s"] = sum(n16.values()) / 16000
        rows = 0
        for name, n in n16.items():
            f0 = np.load(os.path.join(exp, "f0_voiced", f"{name}.wav.npy"))
            f0c = np.load(os.path.join(exp, "f0", f"{name}.wav.npy"))
            emb = np.load(os.path.join(exp, "extracted", f"{name}.npy"))
            require(f0.shape == f0c.shape == (n // 160 + 1,)
                    and emb.shape == ((n - 400) // 320 + 1, 768),
                    f"extract {name}: f0 {f0.shape}, features {emb.shape} for {n} samples")
            require(bool(np.isfinite(f0).all() and np.isfinite(emb).all()),
                    f"extract {name}: not finite")
            rows += emb.shape[0]
        res["feature_rows"] = rows
        with open(os.path.join(exp, "filelist.txt")) as f:
            res["filelist_rows"] = len(f.read().strip().split("\n"))
        # one epoch on that filelist twice, each in a process of its own as
        # a user runs ``train``, from scratch and with no spectrogram cached:
        # with the defaults (the reference's: cuDNN's autotuning on), then
        # with the autotuning off in a second experiment that reads the
        # first's files; each ends in its index build
        alt = os.path.join(root, "logs", "prep_no_autotune")
        os.makedirs(alt)
        shutil.copy(os.path.join(exp, "filelist.txt"), alt)
        os.symlink(os.path.join(exp, "extracted"), os.path.join(alt, "extracted"))
        for step, model, flags in (("train", "prep", []), ("train_no_autotune",
                                   "prep_no_autotune", ["--use_benchmark", "False"])):
            for f in glob.glob(os.path.join(exp, "**", "*.spec.npy"), recursive=True):
                os.remove(f)
            walls[step], walls[f"{step}_cli"], child = _cli_process(
                ["train", "--model_name", model, "--sample_rate", "48000",
                 "--total_epoch", "1", "--batch_size", "8", "--pretrained", "False",
                 *flags], root)
            emit({"phase": "prep_step", "step": step, "wall_s": walls[step],
                  "cli_wall_s": walls[f"{step}_cli"]})
            for name, c in child.items():
                child_counts[name] = child_counts.get(name, 0) + c
            with open(os.path.join(root, "logs", model, "metrics.jsonl")) as f:
                (epoch,) = [r for r in map(json.loads, f) if "epoch/epoch_seconds" in r]
            res[f"{step}_steps"] = epoch["step"]
            res[f"{step}_mean_losses"] = {k: v for k, v in epoch.items()
                                          if k.startswith("epoch/avg/loss")}
            require(epoch["step"] > 0 and all(np.isfinite(v) for v in epoch.values()),
                    f"prep {step}: {epoch}")
        res["train_index_rows"] = FeatureIndex.load(
            os.path.join(exp, "prep.index.npz")).ntotal
        # the KMeans index, with its faiss export
        cli("index", ["index", "--model_name", "prep", "--index_algorithm", "KMeans",
                      "--export_faiss"])
        # infer 10 s with the trained model and that index
        out = os.path.join(root, "prep_out.wav")
        cli("infer", ["infer", "--input_path", wav10, "--output_path", out,
                      "--pth_path", os.path.join(exp, "prep_1e.pth"),
                      "--index_path", os.path.join(exp, "prep.index.npz"),
                      "--f0_method", "rmvpe", "--index_rate", "0.75"])
        res["infer_samples"] = int(_check_wav(out, 479040, "prep infer").shape[0])
        # the index at a user's scale
        before = rt.launches["knn_topk"]
        t0 = time.perf_counter()
        build_index(big, algorithm="Auto")
        torch.cuda.synchronize()
        walls["big_build"] = time.perf_counter() - t0
        emit({"phase": "prep_step", "step": "big_build", "wall_s": walls["big_build"]})
        res["big_build_knn_launches"] = rt.launches["knn_topk"] - before
        # every other f0 method, 10 s each
        for method in PREP_F0_METHODS:
            shutil.copy(f0_paths["crepe_tiny" if method == "crepe-tiny" else "crepe_full"],
                        crepe_pt)
            out = os.path.join(root, f"prep_out_{method}.wav")
            cli(f"infer_{method}", ["infer", "--input_path", wav10, "--output_path", out,
                                    "--pth_path", os.path.join(exp, "prep_1e.pth"),
                                    "--f0_method", method])
            _check_wav(out, 479040, f"infer --f0_method {method}")

    child_counts = {}
    _reset_counts()
    shapes = record_path_shapes(run)
    counts = {k: c + child_counts.get(k, 0) for k, c in _counts().items()}
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched on the dataset path")
    # every take but the rejected one, as many 48 kHz samples as the
    # resampler gives it
    takes = sorted(glob.glob(os.path.join(data_dir, "**", "take*.wav"), recursive=True))
    expect = sum(len(load_audio(t, 48000)) for t in takes
                 if not t.endswith(f"take{PREP_REJECTED:02d}.wav"))
    require(len(takes) == PREP_FILES
            and round(res["total_dataset_duration"] * 48000) == expect,
            f"total_dataset_duration {res['total_dataset_duration']} s != {expect} "
            "samples at 48 kHz (the rejected take left out)")
    require(res["filelist_rows"] == res["segments"] + 2 * 2,
            f"filelist: {res['filelist_rows']} rows for {res['segments']} segments")
    require(res["train_index_rows"] == res["feature_rows"],
            f"train's index: {res['train_index_rows']} rows of {res['feature_rows']}")
    require(res["big_build_knn_launches"] == 25,
            f"the 360 000-row build launched K3 {res['big_build_knn_launches']} times")

    # the KMeans index: 10 000 centroids; the faiss file holds the same
    # vectors; a second build from the same seed writes the same bytes
    idx_path = os.path.join(exp, "prep.index.npz")
    vec = FeatureIndex.load(idx_path).vectors.cpu().numpy()
    (faiss_name,) = [f for f in os.listdir(exp) if f.endswith("_v2.index")]
    require(vec.shape == (10_000, 768) and np.isfinite(vec).all(),
            f"KMeans index {vec.shape}")
    require(np.array_equal(read_index_vectors(os.path.join(exp, faiss_name)), vec),
            "the exported faiss index holds other vectors")
    again = build_index(exp, output_path=os.path.join(root, "again.index.npz"),
                        algorithm="KMeans")
    with open(idx_path, "rb") as f, open(again, "rb") as g:
        require(f.read() == g.read(), "two KMeans builds from one seed differ")

    # K3 at the user's scale: one launch and 16384-row chunks, against
    # cdist + argmin over the same chunks and the bound
    feats = torch.from_numpy(np.concatenate([
        np.load(os.path.join(big, "extracted", f)) for f in
        sorted(os.listdir(os.path.join(big, "extracted")))])).cuda()
    cents = FeatureIndex.load(os.path.join(big, "big.index.npz")).vectors
    q, n, d = feats.shape[0], cents.shape[0], feats.shape[1]
    chunks = range(0, q, KNN_CHECK_ROWS)
    knn = {"Q": q, "N": n, "D": d,
           "ms_per_assignment": gpu_time_ms(lambda: rt.knn_topk(feats, cents, 1)),
           "ms_per_assignment_chunked": gpu_time_ms(
               lambda: [rt.knn_topk(feats[i:i + KNN_CHECK_ROWS], cents, 1) for i in chunks], 3),
           "cdist_argmin_ms": gpu_time_ms(
               lambda: [torch.cdist(feats[i:i + KNN_CHECK_ROWS], cents).argmin(dim=1)
                        for i in chunks], 3)}
    knn["bound_ms"], knn["bytes_ms"], knn["ops_ms"] = bound(
        4 * (q * d + n * d) + 12 * q, [(3 * 2.0 * q * n * d, PEAK_TF32)])
    del feats, cents
    torch.cuda.empty_cache()

    # what the user waits for, takes to a voice that has converted 10 s
    user_wall = sum(walls[k] for k in ("preprocess", "extract", "train", "index", "infer"))
    f0_check = _f0_card_vs_cpu({**f0_paths, "rmvpe": files["rmvpe"]}, audio10[:32000])
    emit({"phase": "prep", "gpu": smi, "setup_s": setup_s, "wall_s": walls,
          "input_s": PREP_FILES * PREP_FILE_S, **res,
          "extract_audio_s_per_wall_s": res["extract_audio_s"] / walls["extract"],
          "dataset_wall_s": user_wall, "dataset_wall_s_no_autotune":
              user_wall - walls["train"] + walls["train_no_autotune"],
          "launches": counts, "knn_kmeans": knn, "f0_card_vs_cpu": f0_check,
          "kernel_shapes": [[str(v) if isinstance(v, torch.dtype) else v for v in sh]
                            for sh in shapes if sh[0] == "knn"]})
    return counts, shapes


DIST_STEPS = 3
# the global batch's lengths in frames: the last four rows (rank 1's at
# world 2) are shorter, so the ranks' mask sums differ
DIST_LENGTHS = (40, 40, 38, 36, 32, 30, 28, 26)
DIST_LR = 1e-4
LSB16 = 1.0 / 32767  # one step of a 16-bit sample, as the WAVs hold them
# a sharded fp32 row's largest distance from its unsharded row, as a share
# of the smallest largest distance between two neighbouring unsharded rows
SHARD_ROWS_SHARE = 0.1


def _dist_steps(rank: int, world: int, n_steps: int, save_dir=None, ref_dir=None):
    """Full-width 48 kHz bf16 training steps (the NSF generator from seed 11,
    the full MPD, AdamW at ``DIST_LR``, cuDNN's autotuning off and its
    algorithms deterministic) on this rank's rows of a global batch of 8
    (``_zoo_batch`` with ``DIST_LENGTHS``), slice starts and noise from
    seed 12. Per step: ms, metrics (the first step's also with the norm of
    each group of summed gradients, ``gsub_*``), the weights' bit fingerprint
    and, with ``ref_dir``, the largest difference to the weights saved there
    by a run with ``save_dir``; the launch counts and the shapes the kernels
    saw."""
    import dataclasses

    import torch

    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.parallel import shard_rows
    from rvc_tpu_torch.train.optimizers import module_optimizer
    from rvc_tpu_torch.train.step import TrainStep
    from rvc_tpu_torch.train.trainer import init_parameters

    switches = _cuda_switches()
    _cuda_switches([False, False, False, True])
    cfg = get_config(48000)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=TRAIN_BATCH, segment_size=TRAIN_SEGMENT, bf16_run=True))
    gen = torch.Generator().manual_seed(11)
    g = Synthesizer.from_config(cfg, device="cuda", train=True)
    d = MultiPeriodDiscriminator(use_spectral_norm=cfg.model.use_spectral_norm).cuda()
    init_parameters(g, gen)
    init_parameters(d, gen)
    step = TrainStep(cfg, g, d, module_optimizer("adamw", g, DIST_LR),
                     module_optimizer("adamw", d, DIST_LR))
    batch = _zoo_batch(TRAIN_BATCH, 40, "cuda")
    batch["phone_lengths"] = batch["spec_lengths"] = torch.tensor(
        DIST_LENGTHS, dtype=torch.int32, device="cuda")
    batch = shard_rows(batch, rank, world)
    params = [p for m in (g, d) for p in m.parameters()]
    sgen = torch.Generator().manual_seed(12)
    out = {"rank": rank, "world": world, "rows": int(batch["phone"].shape[0]),
           "mask_frames": int(batch["spec_lengths"].sum()), "ms": [], "metrics": [],
           "fingerprint": [], "max_abs_diff": []}

    def run():
        for i in range(n_steps):
            torch.cuda.synchronize()
            step.debug_grads = i == 0
            t0 = time.perf_counter()
            m = step(batch, sgen)
            torch.cuda.synchronize()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["metrics"].append({k: float(v) for k, v in m.items()})
            flat = torch.cat([p.detach().reshape(-1) for p in params])
            out["fingerprint"].append(int(flat.view(torch.int32).to(torch.int64).sum()))
            if save_dir is not None:
                torch.save(flat.cpu(), os.path.join(save_dir, f"step{i}.pt"))
            if ref_dir is not None:
                ref = torch.load(os.path.join(ref_dir, f"step{i}.pt")).cuda()
                out["max_abs_diff"].append(float((flat - ref).abs().max()))
                del ref
            del flat

    _reset_counts()
    grad_shapes = []
    shapes = record_path_shapes(run, grad_shapes)
    out["launches"] = _counts()
    out["shapes"], out["grad_shapes"] = (
        [[str(v).split(".")[-1] if isinstance(v, torch.dtype) else v for v in sh]
         for sh in s] for s in (shapes, grad_shapes))
    _cuda_switches(switches)
    del step, g, d, batch, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dist_rank(rank: int, device: str, world: int, n_steps: int, ref_dir: str,
               out_prefix: str) -> None:
    """One rank of ``parallel.launch``: ``_dist_steps`` against the plain
    run's weights, its record in ``<out_prefix>_<rank>.json``."""
    import torch.distributed as dist

    rec = _dist_steps(rank, world, n_steps, ref_dir=ref_dir)
    rec["backend"] = dist.get_backend()
    with open(f"{out_prefix}_{rank}.json", "w") as f:
        json.dump(rec, f)


def _dist_check(name: str, ref: dict, got: dict, steps: int) -> dict:
    """A distributed run's steps against the plain run's: losses within 5e-3
    and gradient norms (the global ones of every step, each group's of the
    first) within 1e-1 of them, the bf16 tolerances of the `small_train`
    phase."""
    worst = {"loss_rel": 0.0, "norm_rel": 0.0}
    for i in range(steps):
        r, m = ref["metrics"][i], got["metrics"][i]
        require(m.keys() == r.keys(), f"dist {name} step {i}: metrics {sorted(m)}")
        for k, v in r.items():
            rel = abs(m[k] - v) / max(abs(v), 1e-3)
            kind = "norm_rel" if k.startswith(("grad_norm", "gsub_")) else "loss_rel"
            worst[kind] = max(worst[kind], rel)
    require(worst["loss_rel"] <= 5e-3 and worst["norm_rel"] <= 1e-1,
            f"dist {name}: {worst} from the plain run")
    return worst


def phase_dist(smi: str, files: dict, root: str):
    """A.13 on one card. (a) ``parallel.launch`` at world 1 with NCCL on
    cuda:0: ``DIST_STEPS`` full-width training steps against the same
    steps in this process without a process group (an all-reduce over one
    rank is the identity): ms per step of both. (b) two gloo ranks on the
    one card, 4 rows each (rank 1's rows shorter, so the mask sums differ):
    two steps against the plain run's first two, the ranks' weights equal
    bit for bit. NCCL refuses two ranks on one device, and the two ranks
    share the card, so (b) checks the sums and says nothing of scaling.
    (c) ``enable_batch_sharding(["cuda:0", "cuda:0"])``: the `batch`
    files through ``convert_audio_batch`` (four rows, then three: one pad
    row) against the unsharded batch: in fp32 (TF32 off) within one 16-bit
    step, in bf16 too; the warm walls of both."""
    import torch

    from rvc_tpu_torch.infer.converter import VoiceConverter
    from rvc_tpu_torch.parallel import launch
    from rvc_tpu_torch.utils.audio_io import read_wav

    t_start = time.perf_counter()
    ref_dir = os.path.join(root, "dist_ref")
    os.makedirs(ref_dir)
    plain = _dist_steps(0, 1, DIST_STEPS, save_dir=ref_dir)
    res, launches, shapes, grad_uses = {}, collections.Counter(), [], {}

    def add(rec, steps):
        launches.update(rec["launches"])
        shapes.extend(tuple(s) for s in rec["shapes"])
        for k, n in collections.Counter(_shape_key(s) for s in rec["grad_shapes"]).items():
            grad_uses[k] = max(grad_uses.get(k, 0.0), n / steps)

    for tag, devices, backend, steps in (("nccl_world1", ["cuda:0"], "nccl", DIST_STEPS),
                                         ("gloo_two_ranks", ["cuda:0", "cuda:0"], "gloo", 2)):
        prefix = os.path.join(root, f"dist_{tag}")
        t0 = time.perf_counter()
        rc = launch(_dist_rank, devices, backend,
                    (len(devices), steps, ref_dir, prefix))
        wall = time.perf_counter() - t0
        require(rc == 0, f"dist {tag}: launch returned {rc}")
        ranks = []
        for r in range(len(devices)):
            with open(f"{prefix}_{r}.json") as f:
                ranks.append(json.load(f))
        for rec in ranks:
            require(rec["launches"]["mrf_stage"] > 0 and rec["launches"]["resblock_chain"] > 0,
                    f"dist {tag} rank {rec['rank']}: K1/K2 not launched {rec['launches']}")
            add(rec, steps)
        require(all(rec["fingerprint"] == ranks[0]["fingerprint"] for rec in ranks),
                f"dist {tag}: the ranks' weights differ")
        require(all(rec["metrics"] == ranks[0]["metrics"] for rec in ranks),
                f"dist {tag}: the ranks' metrics differ")
        worst = _dist_check(tag, plain, ranks[0], steps)
        if tag == "nccl_world1":  # a sum over one rank is the identity
            require(not any(ranks[0]["max_abs_diff"]),
                    f"dist {tag}: weights {ranks[0]['max_abs_diff']} from the plain run")
        res[tag] = {"backend": ranks[0]["backend"], "ranks": len(devices),
                    "rows_per_rank": ranks[0]["rows"],
                    "mask_frames_by_rank": [rec["mask_frames"] for rec in ranks],
                    "ms_per_step_by_rank": [rec["ms"] for rec in ranks],
                    "max_abs_diff_vs_plain": ranks[0]["max_abs_diff"],
                    "bitwise_equal_to_plain": [fp == p for fp, p in zip(
                        ranks[0]["fingerprint"], plain["fingerprint"])],
                    "worst_rel_vs_plain": worst, "launch_wall_s": wall,
                    "launches": [rec["launches"] for rec in ranks]}
    res["gloo_two_ranks"]["note"] = (
        "two ranks on one card: correctness of the gradient sums only, not scaling")
    add(plain, DIST_STEPS)

    # (c) sharded batch serving, two replicas on the one card, against the
    # unsharded batch within one 16-bit step in fp32 (TF32 off) and in bf16,
    # the serving precision; the files' lengths differ, so a row out of
    # order fails the shape check
    src, _ = _batch_files(root)
    src3 = os.path.join(root, "dist_in3")
    os.makedirs(src3)
    for name in ("a", "b", "c"):
        shutil.copy(os.path.join(src, f"{name}.wav"), src3)
    kw = dict(model_path=files["pth"], index_path=files["index"], f0_method="rmvpe",
              index_rate=0.75, protect=0.33, pitch=2)
    cwd = os.getcwd()
    os.chdir(root)
    walls, diffs, counts, shard_shapes = {}, {}, {}, []
    rows, current = {}, [None]  # the model's rows of each batch, before the files
    switches = _cuda_switches()
    try:
        for precision in ("fp32", "bf16"):
            _cuda_switches([False, False] + switches[2:])
            vc = VoiceConverter(precision=precision)

            def batch(folder, out):
                current[0] = f"{precision}/{out}"
                t0 = time.perf_counter()
                vc.convert_audio_batch(folder, os.path.join(root, f"{out}_{precision}"), **kw)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            batch(src, "dist_warm")
            seg_batch = vc.pipeline.convert_segments_batch

            def captured(*a, seg_batch=seg_batch, **k):
                outs = seg_batch(*a, **k)
                rows.setdefault(current[0], []).extend(np.array(o, np.float64) for o in outs)
                return outs

            vc.pipeline.convert_segments_batch = captured
            reps = (0, 1) if precision == "bf16" else (0,)  # bf16: the serving walls
            walls[precision] = {"unsharded_4": [batch(src, f"dist_plain4_{i}") for i in reps],
                                "unsharded_3": batch(src3, "dist_plain3")}
            vc.pipeline.enable_batch_sharding(["cuda:0", "cuda:0"])
            require(len(vc.pipeline._replicas) == 2, "enable_batch_sharding made no replicas")
            _reset_counts()
            shard_shapes += record_path_shapes(lambda: batch(src, "dist_shard4_0"))
            shard_shapes += record_path_shapes(lambda: batch(src3, "dist_shard3"))
            for k, c in _counts().items():
                counts[k] = counts.get(k, 0) + c
            if precision == "bf16":
                walls[precision]["sharded_4"] = [batch(src, f"dist_shard4_{i}")
                                                 for i in (1, 2)]
            del vc
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        _cuda_switches(switches)
        os.chdir(cwd)
    peaks, rows_apart, float_diff, float_apart = {}, {}, {}, {}
    for precision in ("fp32", "bf16"):
        for plain_dir, shard_dir, names in (("dist_plain4_0", "dist_shard4_0", "abcd"),
                                            ("dist_plain3", "dist_shard3", "abc")):
            outs = {}
            for n in names:
                a, _ = read_wav(os.path.join(root, f"{plain_dir}_{precision}", f"{n}_output.wav"))
                b, _ = read_wav(os.path.join(root, f"{shard_dir}_{precision}", f"{n}_output.wav"))
                require(a.shape == b.shape, f"sharded {n}: {b.shape} != {a.shape}")
                key = f"{precision}/{shard_dir}/{n}"
                diffs[key] = float(np.abs(a - b).max()) / LSB16
                peaks[key] = float(np.abs(a).max()) / LSB16
                outs[n] = a
            for x, y in zip(names, names[1:]):
                t = min(len(outs[x]), len(outs[y]))
                rows_apart[f"{precision}/{shard_dir}/{x}{y}"] = float(
                    np.abs(outs[x][:t] - outs[y][:t]).max()) / LSB16
    # fp32's rows as the model gives them, before the 16-bit files: each
    # sharded row against its unsharded row, and neighbouring unsharded rows
    # against each other (this random-weight model's rows differ by about
    # one 16-bit step, so the files alone cannot tell a row from another)
    for plain_dir, shard_dir, names in (("dist_plain4_0", "dist_shard4_0", "abcd"),
                                        ("dist_plain3", "dist_shard3", "abc")):
        p, q = rows.get(f"fp32/{plain_dir}", []), rows.get(f"fp32/{shard_dir}", [])
        require(len(p) == len(q) == len(names),
                f"sharded {shard_dir}: {len(q)} rows against {len(p)}, not {len(names)}")
        for n, a, b in zip(names, p, q):
            require(a.shape == b.shape, f"sharded {n}: rows {b.shape} != {a.shape}")
            float_diff[f"{shard_dir}/{n}"] = float(np.abs(a - b).max())
        for x, a, b in zip(names, p, p[1:]):
            t = min(len(a), len(b))
            float_apart[f"{shard_dir}/{x}"] = float(np.abs(a[:t] - b[:t]).max())
    res["sharded_batch"] = {"replicas": ["cuda:0", "cuda:0"], "walls_s": walls,
                            "max_diff_16bit_steps": diffs, "limit_16bit_steps": 1.0,
                            "unsharded_peak_16bit_steps": peaks,
                            "neighbour_rows_max_diff_16bit_steps": rows_apart,
                            "fp32_rows_max_abs_diff": float_diff,
                            "fp32_neighbour_rows_max_abs_diff": float_apart,
                            "fp32_rows_limit": f"{SHARD_ROWS_SHARE} of the closest neighbours",
                            "launches": counts}
    launches.update(counts)
    shapes += shard_shapes
    emit({"phase": "dist", "gpu": smi, "plain_ms_per_step": plain["ms"],
          "plain_metrics_last": plain["metrics"][-1], "wall_s": time.perf_counter() - t_start,
          **res})
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched by the sharded batch")
    for precision in ("fp32", "bf16"):
        worst = max(v for k, v in diffs.items() if k.startswith(precision))
        require(worst <= 1.0 + 1e-3,
                f"sharded batch ({precision}): {worst} 16-bit steps from the unsharded")
        # the one-step limit holds something only where the output is not
        # silent: every row peaks well above it
        quiet = min(v for k, v in peaks.items() if k.startswith(precision))
        require(quiet >= 8.0, f"sharded batch ({precision}): a row peaks at {quiet} steps")
    require(max(float_diff.values()) <= SHARD_ROWS_SHARE * min(float_apart.values()),
            f"sharded batch (fp32): rows {float_diff} from the unsharded, "
            f"neighbours {float_apart} apart")
    return dict(launches), shapes, grad_uses


def _ui_event(app, button: str, nth: int = 0):
    """The ``nth`` click event of the button that reads ``button``: (its
    id, its input components)."""
    from rvc_tpu_torch.ui import gradio_lite

    hits = [ev for ev in app.event_list if ev.trigger == "click"
            and getattr(gradio_lite._ev_src(app, ev), "value", None) == button]
    require(len(hits) > nth, f"ui: no click event of {button!r} #{nth}")
    return hits[nth].eid, hits[nth].inputs


def _ui_post(base: str, eid: int, data: list, timeout_s: float = 900.0):
    """``POST /api/<eid>`` with the inputs' values: (the output patches,
    the wall seconds)."""
    import urllib.request

    req = urllib.request.Request(f"{base}/api/{eid}", data=json.dumps({"data": data}).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        out = json.loads(r.read())
    return out["data"], time.perf_counter() - t0


UI_TRAIN_ROWS = 40  # the `prep` filelist's first rows: the UI's epoch cut to ~5 steps


def _ui_values(inputs, over: dict) -> list:
    """The inputs' current values, those at the positions of ``over``
    replaced by its values."""
    return [over.get(i, c.value) for i, c in enumerate(inputs)]


def phase_ui(smi: str, files: dict, root: str):
    """A.16 on the card: the app of ``rvc_tpu_torch.ui.app.build_app("cuda")``
    with the stdlib ``gradio_lite`` renderer, launched on a free port, and
    driven as a browser drives it, over ``POST /api/<eid>``: the inference
    tab's conversion of 10 s with the `files` model and index (against
    ``cli infer`` with the same settings, within one 16-bit step; cold and
    warm walls beside the CLI's), its batch event on the `batch` files, the
    blender, the model information, the analyzer and the f0 extractor, TTS
    through the offline synthesizer then conversion, the drop-install of a
    zip of the .pth and .index, the training tab for one epoch on the first
    ``UI_TRAIN_ROWS`` rows of the `prep` phase's filelist (its features and
    the `prep` phase's 360 000 rows under ``extracted/``: the index
    compresses, K3 at k = 1) and its index button. Then the download server: ``GET /download/file://<zip>`` and
    ``POST /shutdown``."""
    import importlib.util
    import urllib.request
    import zipfile

    import torch

    from rvc_tpu_torch.parallel.mesh import free_port
    from rvc_tpu_torch.ui import app as ui_app
    from rvc_tpu_torch.ui import gradio_lite
    from rvc_tpu_torch.ui import tabs as ui_tabs
    from rvc_tpu_torch.utils.audio_io import read_wav, write_wav
    from rvc_tpu_torch.utils.http_server import start_download_server

    require(shutil.which("edge-tts") is None and importlib.util.find_spec("edge_tts") is None,
            "edge-tts is installed: the TTS event would reach for the network")
    t_start = time.perf_counter()
    wav10 = os.path.join(root, "ui_in.wav")
    write_wav(wav10, _audio(10.0, np.random.default_rng(31)), 16000)
    src, lengths = _batch_files(root)
    exp = os.path.join(root, "logs", "ui_train")
    os.makedirs(os.path.join(exp, "extracted"))
    with open(os.path.join(root, "logs", "prep", "filelist.txt")) as f:
        rows = f.read().strip().split("\n")
    with open(os.path.join(exp, "filelist.txt"), "w") as f:  # one epoch of a few steps
        f.write("\n".join(rows[:UI_TRAIN_ROWS]) + "\n")
    for model in ("prep", "big"):
        feat_dir = os.path.join(root, "logs", model, "extracted")
        for f in os.listdir(feat_dir):
            os.symlink(os.path.join(feat_dir, f), os.path.join(exp, "extracted", f"{model}_{f}"))
    bundle = os.path.join(root, "ui_voice.zip")
    with zipfile.ZipFile(bundle, "w") as z:
        z.write(files["pth"], "ui_voice.pth")
        z.write(files["index"], "ui_voice.index")
    other = os.path.join(root, "model_b.pth")
    other = other if os.path.exists(other) else files["pth"]
    with open(os.path.join(root, "logs", "ui_config.json"), "w") as f:
        json.dump({"language": "en_US", "precision": "bf16"}, f)  # the buttons' words
    res, walls = {}, {}
    cwd = os.getcwd()
    os.chdir(root)
    real_gradio, ui_app._require_gradio = ui_app._require_gradio, lambda: gradio_lite
    app = None
    try:
        t0 = time.perf_counter()
        app = ui_app.build_app("cuda")
        walls["build_app"] = time.perf_counter() - t0
        app.launch(server_name="127.0.0.1", server_port=0, prevent_thread_lock=True)
        base = f"http://127.0.0.1:{app.server.server_address[1]}"
        with urllib.request.urlopen(f"{base}/config", timeout=30) as r:
            cfg = json.loads(r.read())
        res["components"], res["events"] = len(cfg["components"]), len(cfg["events"])

        def drive():
            eid, ins = _ui_event(app, "Convert", 0)
            data = _ui_values(ins, {0: wav10, 1: files["pth"], 2: files["index"], 3: 0,
                                    4: "", 5: ""})
            outs = []
            for i in range(2):  # cold (the models load), then warm
                patch, walls[f"convert_{i}"] = _ui_post(base, eid, data)
                outs.append(patch[0]["value"])
            res["convert_out"] = outs
            eid, ins = _ui_event(app, "Convert", 1)
            patch, walls["batch"] = _ui_post(base, eid, _ui_values(
                ins, {0: src, 1: os.path.join(root, "ui_batch"), 2: files["pth"],
                      3: files["index"], 4: 0, 5: ""}))
            res["batch"] = patch[0]["value"]
            eid, ins = _ui_event(app, "Fusion")
            patch, walls["blend"] = _ui_post(base, eid, ["ui_blend", files["pth"], other, 0.5])
            res["blend"] = patch[0]["value"]
            eid, ins = _ui_event(app, "Get model information")
            patch, walls["model_information"] = _ui_post(base, eid, [res["blend"]])
            res["model_information"] = patch[0]["value"]
            eid, ins = _ui_event(app, "Get information about the audio")
            patch, walls["analyzer"] = _ui_post(base, eid, [outs[0]])
            res["analyzer"] = json.loads(patch[0]["value"])
            eid, ins = _ui_event(app, "Extract F0 Curve")
            patch, walls["f0_curve"] = _ui_post(base, eid, [wav10, "rmvpe", False])
            res["f0_plot"] = patch[0]["value"]
            eid, ins = _ui_event(app, "Convert", 2)
            patch, walls["tts"] = _ui_post(base, eid, _ui_values(
                ins, {0: "a short sentence for the voice", 1: "en-US-AriaNeural", 2: 0,
                      3: files["pth"]}))
            res["tts_out"] = patch[0]["value"]
            (drop,) = [ev for ev in app.event_list if ev.trigger == "upload"]
            patch, walls["drop_install"] = _ui_post(base, drop.eid, [bundle])
            res["drop_install"] = patch[0]["value"]
            eid, ins = _ui_event(app, "Start Training")
            patch, _ = _ui_post(base, eid, _ui_values(ins, {0: "ui_train", 3: 1}))
            res["train_started"] = patch[0]["value"]
            t0 = time.perf_counter()
            thread = ui_tabs._TRAIN_THREAD["thread"]
            thread.join(900)
            walls["train"] = time.perf_counter() - t0
            require(not thread.is_alive() and ui_tabs._TRAIN_THREAD["error"] is None,
                    f"ui training: {ui_tabs._TRAIN_THREAD['error']}")
            eid, ins = _ui_event(app, "Generate Index")
            before = _counts()["knn_topk"]
            patch, walls["index"] = _ui_post(base, eid, ["ui_train"])
            res["index"], res["index_knn_launches"] = patch[0]["value"], \
                _counts()["knn_topk"] - before

        _reset_counts()
        shapes = record_path_shapes(drive)
        counts = _counts()
        torch.cuda.synchronize()
    finally:
        ui_app._require_gradio = real_gradio
        if app is not None and getattr(app, "server", None) is not None:
            app.close()
        os.chdir(cwd)
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched by the UI")

    # the inference event against the CLI with the same settings
    cli_out = os.path.join(root, "ui_cli.wav")
    walls["cli_infer"] = _cli(["infer", "--input_path", wav10, "--output_path", cli_out,
                               "--pth_path", files["pth"], "--index_path", files["index"]],
                              root)
    want, sr = read_wav(cli_out)
    res["convert_vs_cli_16bit_steps"] = []
    for out in res["convert_out"]:
        got, sr_ui = read_wav(os.path.join(root, out))
        require(sr_ui == sr == 48000 and got.shape == want.shape,
                f"ui convert {got.shape} at {sr_ui} Hz, cli {want.shape} at {sr} Hz")
        res["convert_vs_cli_16bit_steps"].append(float(np.abs(got - want).max()) / LSB16)
    require(max(res["convert_vs_cli_16bit_steps"]) <= 1.0 + 1e-3,
            f"ui convert vs cli: {res['convert_vs_cli_16bit_steps']} 16-bit steps")
    for name in lengths:  # as long as the `batch` phase's outputs of the files
        got, _ = read_wav(os.path.join(root, "ui_batch", f"{name}_output.wav"))
        want_n = read_wav(os.path.join(root, "b1", f"{name}_output.wav"))[0].shape
        require(got.shape == want_n and np.isfinite(got).all(), f"ui batch {name}: {got.shape}")
    tts, _ = read_wav(os.path.join(root, res["tts_out"]))
    require(tts.size > 48000 and np.isfinite(tts).all(), f"ui tts output {tts.shape}")
    require(os.path.exists(os.path.join(root, "logs", "ui_blend.pth")), "ui blend not written")
    require("parameters: " in res["model_information"],
            f"ui model information: {res['model_information'][-300:]}")
    res["model_information"] = res["model_information"][-200:]
    require(all(np.isfinite(v) for v in res["analyzer"].values()
                if isinstance(v, (int, float))), f"ui analyzer: {res['analyzer']}")
    require(os.path.exists(os.path.join(root, "logs", "ui_voice", "ui_voice.pth")),
            f"ui drop install: {res['drop_install']}")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        (epoch,) = [r for r in map(json.loads, f) if "epoch/epoch_seconds" in r]
    require(epoch["step"] > 0 and os.path.exists(os.path.join(exp, "G_1.pth")),
            f"ui training: {epoch}")
    require(res["index_knn_launches"] == 25, f"ui index: K3 {res['index_knn_launches']} times")

    # the download server
    port = free_port()
    srv = start_download_server(port=port)
    os.chdir(root)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/download/file://{bundle}",
                                    timeout=60) as r:
            res["download_server"] = r.read().decode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/shutdown", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            require(r.status == 200, "download server: /shutdown")
    finally:
        os.chdir(cwd)
        srv.shutdown()
        srv.server_close()
    require(res["download_server"].startswith("downloaded to"), res["download_server"])
    emit({"phase": "ui", "gpu": smi, "walls_s": walls, "launches": counts,
          "train_epoch": {k: v for k, v in epoch.items() if not k.startswith("epoch/avg/")},
          "wall_s": time.perf_counter() - t_start, **res})
    return counts, shapes


def _cuda_switches(values=None):
    """The CUDA switches the ``train`` CLI sets as the reference does (TF32,
    cuDNN autotuning and determinism): their values, or set them back."""
    import torch

    names = [(torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cudnn, "benchmark"), (torch.backends.cudnn, "deterministic")]
    if values is None:
        return [getattr(mod, n) for mod, n in names]
    for (mod, n), v in zip(names, values):
        setattr(mod, n, v)
    return values


def _profile_train_step(trainer) -> dict:
    """One warm training step under torch.profiler: device busy time and
    idle share over the step's wall time, and the heaviest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = {k: torch.from_numpy(v).cuda() for k, v in next(trainer.batcher(epoch=1)).items()}
    gen = torch.Generator().manual_seed(0)
    trainer.step_fn(batch, gen)  # warm at this shape
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_fn(batch, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(
            e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:12]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    require(busy_ms > 0, "the profiled training step shows no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "frames": int(batch["phone"].shape[1]),
            "device_kernels": sum(e.count for e in events),
            "top": [{"name": e.key[:90], "ms": dev_us(e) / 1e3, "count": e.count}
                    for e in top],
            "host_top": [{"name": e.key[:60], "self_ms": e.self_cpu_time_total / 1e3,
                          "count": e.count} for e in host]}


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
        "env", "build", "small", "pipeline", "stream", "files", "windowed", "batch",
        "nof0", "train", "prep", "zoo", "fx", "dist", "ui", "kernels", "stages"]
    sys.path.insert(0, REPO)
    import rvc_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase_env()
    if "build" in phases:
        phase_build()
    if "small" in phases:
        phase_small_reference()
    counts, rec, launches, path_shapes = {}, {}, {}, {}
    if "unit" in phases:
        phase_kernels({"unit": UNIT_SHAPES})
    user_paths = [p for p in ("windowed", "batch", "nof0", "prep", "zoo", "fx", "dist",
                              "ui") if p in phases]
    require("ui" not in phases or {"batch", "prep"} <= set(phases),
            "phase ui needs the batch and prep phases' files")
    root = tempfile.mkdtemp(prefix="rvc_chip_smoke_")
    try:
        if "pipeline" in phases:
            pipe, audio, index, counts, run, shapes = phase_pipeline(smi)
            launches["pipeline"], path_shapes["pipeline"] = counts, shapes
            if "stream" in phases:
                phase_stream(pipe, audio, index, smi)
        if "files" in phases or user_paths:
            files = phase_files(smi, root)
            for name in (p for p in user_paths
                         if p not in ("prep", "zoo", "fx", "dist", "ui")):
                phase = {"windowed": phase_windowed, "batch": phase_batch,
                         "nof0": phase_nof0}[name]
                launches[name], path_shapes[name] = phase(smi, files, root)
        grad_uses = {}  # stage or chain shape -> {training path: calls per step}
        if "train" in phases:
            phase_small_train(smi)
            switches = _cuda_switches()
            launches["train"], path_shapes["train"], grad_shapes, n_steps = phase_train(
                smi, root)
            _cuda_switches(switches)  # later phases time cuDNN as earlier PRs did
            for k, n in collections.Counter(map(_shape_key, grad_shapes)).items():
                grad_uses.setdefault(k, {})["train"] = n / n_steps
        if "prep" in phases:
            launches["prep"], path_shapes["prep"] = phase_prep(smi, root, files)
        if "zoo" in phases:
            z_launches, z_shapes, z_uses = phase_zoo(smi, files, root)
            launches.update(z_launches)
            path_shapes.update(z_shapes)
            for k, runs in z_uses.items():
                grad_uses.setdefault(k, {}).update(runs)
        if "fx" in phases:
            launches["fx"], path_shapes["fx"] = phase_fx(smi, files, root)
        if "dist" in phases:
            launches["dist"], path_shapes["dist"], d_uses = phase_dist(smi, files, root)
            for k, n in d_uses.items():
                grad_uses.setdefault(k, {})["dist"] = n
        if "ui" in phases:
            switches = _cuda_switches()
            launches["ui"], path_shapes["ui"] = phase_ui(smi, files, root)
            _cuda_switches(switches)  # the UI's training sets the CLI's switches
        if "kernels" in phases and path_shapes:  # at the shapes the paths gave
            rec = phase_kernels(path_shapes, grad_uses or None).get("pipeline", {})
        if "pipeline" in phases and "stages" in phases:
            phase_stages(pipe, audio, index, smi)
        if "pipeline" in phases and "trace" in phases:
            phase_trace(run, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts.get(name, 0), **rec.get(name, {}),
         "launches_by_path": {p: c.get(name, 0) for p, c in launches.items()}}
        for name, (src, rep) in KERNEL_META.items()], "gpu": smi})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
