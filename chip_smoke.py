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
  kernels  hold each kernel against its plain PyTorch version at the shapes
           every path recorded (bf16 and f32: T up to 3.2 M, batch 4) and at
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
    python3 chip_smoke.py env,build,unit   # the kernel checks alone, at the
                                           # serving shapes, without the models
Then a ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
the result line. There is no CPU fallback: without CUDA the script fails.
"""

from __future__ import annotations

import collections
import gc
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


def record_path_shapes(fn, grad_shapes=None):
    """Run fn() with the decoder's stage tails and the retrieval search
    wrapped to record the shapes the main path gives the kernels:
    [("stage", C, T, dtype, kernel sizes, dilations, batch)] and
    [("knn", Q, N, D, k)]. Stage shapes met with gradients on (a training
    step's) are also appended to ``grad_shapes`` when given."""
    import torch

    from rvc_tpu_torch.models.generators import nsf
    from rvc_tpu_torch.ops import retrieval as rt

    shapes = []
    stage, knn = nsf._resblock_stage, rt.knn_topk

    def stage_hook(x, blocks, cache=None):
        shapes.append(("stage", x.shape[1], x.shape[2], x.dtype,
                       tuple(blk.kernel_size for blk in blocks),
                       tuple(blocks[0].dilations), x.shape[0]))
        if grad_shapes is not None and torch.is_grad_enabled():
            grad_shapes.append(shapes[-1])
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


def _shape_key(shape):
    """A recorded shape as a hashable key, dtype by name, batch 1 if absent."""
    if shape[0] == "stage":
        _, c, t, dtype, ks, dil, *b = shape
        return ("stage", c, t, str(dtype).split(".")[-1], tuple(ks), tuple(dil),
                b[0] if b else 1)
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
    ``grad_uses`` (stage shape key -> calls per training step) adds the
    gradient checks of ``phase_kernel_grads``."""
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

    def check(name, key, fn, plain, lib, ref_out, tol, bnd, on_paths):
        out = fn()
        ref = ref_out()
        torch.cuda.synchronize()
        abs_err, rel = _err(ref, out)
        row = {"kernel": name, **key, "max_abs_err": abs_err, "rel_err": rel,
               "tol": tol, "ms": gpu_time_ms(fn), "plain_ms": gpu_time_ms(plain, 3),
               "library_ms": gpu_time_ms(lib, 3), "bound_ms": bnd[0],
               "bound_by": "operations" if bnd[2] >= bnd[1] else "bytes",
               "on_path": dict(on_paths)}
        emit({"phase": "kernel_check", **row})
        require(rel <= tol, f"{name} {key}: rel err {rel} > {tol}")
        for path, n in on_paths.items():  # the paths' launches: sum into them
            r = rec[path][name]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            for f in ("ms", "plain_ms", "library_ms"):
                r[f] += n * row[f]
            for f, v in zip(("bound_ms", "bytes_ms", "ops_ms"), bnd):
                r[f] += n * v

    for key, counts in uses.items():
        if key[0] != "stage":
            continue
        _, c, t, path_dtype, ks, dil, b = key
        chains = [_rand_chain(gen, c, k, dev, dil) for k in ks]
        caches = [rb.WeightCache() for _ in range(len(ks) + 1)]
        x32 = (torch.randn((b, c, t), generator=gen) * 0.3).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            nbytes = 2 * x.numel() * x.element_size()
            dname = str(dtype).split(".")[-1]
            key_row = {"B": b, "C": c, "T": t, "dtype": dname}
            on_paths = counts if dname == path_dtype else {}
            if c <= MRF_MAX_CHANNELS:  # K1: all chains in one launch
                flops = 2.0 * b * sum(2 * len(dil) * k * c * c * t for k in ks)
                peak = [(flops, PEAK_BF16)] if dtype == torch.bfloat16 else \
                    [(3 * flops, PEAK_TF32)]
                nbytes += sum(2 * len(dil) * k * c * c for k in ks) * (
                    2 if dtype == torch.bfloat16 else 4)
                check("mrf_stage", key_row,
                      lambda: rb.mrf_stage(x, chains, ks, dil, cache=caches[-1]),
                      lambda: rb.mrf_stage_plain(x, chains, dil),
                      lambda: [_library_chain(x, ch, dil) for ch in chains],
                      lambda: rb.mrf_stage_plain(x, chains, dil),
                      2e-2 if dtype == torch.bfloat16 else 1e-4,
                      bound(nbytes, peak), on_paths)
            else:  # K2: two conv launches per dilation of each chain
                for k, ch, cache in zip(ks, chains, caches):
                    flops = 2.0 * 2 * len(dil) * k * c * c * t * b
                    check("resblock_chain", {**key_row, "K": k},
                          lambda: rb.resblock_chain(x, *ch, dil, cache=cache),
                          lambda: rb.resblock_chain_plain(x, *ch, dil),
                          lambda: _library_chain(x.float(), ch, dil),
                          lambda: rb.resblock_chain_plain(x, *ch, dil),
                          2e-2 if dtype == torch.bfloat16 else 1e-4,
                          bound(nbytes + 4 * 2 * len(dil) * k * c * c,
                                [(3 * flops, PEAK_TF32)]), on_paths)
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


def phase_kernel_grads(grad_uses, gen):
    """K1 and K2 at the training step's shapes, through their autograd
    Functions: the forward against the plain version (largest error over
    the largest value) and the gradient with respect to x and every folded
    weight and bias against the plain version's autograd gradient (norm of
    the error over the norm, per tensor), in bf16 and f32. In the path's dtype
    (bf16) it times, per stage and per step, the kernel's forward, the
    Functions' backward (the plain-conv recompute, as the JAX package's
    custom_vjp; no hand-written kernel), the plain version's forward and
    backward, and cuDNN's bf16 chain forward and backward, beside their
    bounds (the backward: recompute + input and weight gradients, 3x the
    forward's products)."""
    import torch

    from rvc_tpu_torch.models.generators.nsf import MRF_MAX_CHANNELS
    from rvc_tpu_torch.ops import resblock as rb

    dev = torch.device("cuda")
    per_step = {n: collections.Counter() for n in ("mrf_stage", "resblock_chain")}
    for key, calls in grad_uses.items():
        _, c, t, path_dtype, ks, dil, b = key
        chains32 = [_rand_chain(gen, c, k, dev, dil) for k in ks]
        x32 = (torch.randn((b, c, t), generator=gen) * 0.3).to(dev)
        cot32 = torch.randn((b, c, t), generator=gen).to(dev)
        name = "mrf_stage" if c <= MRF_MAX_CHANNELS else "resblock_chain"
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
                    return rb.mrf_stage(x, chains, ks, dil, cache=caches[-1])

                def plain():
                    return rb.mrf_stage_plain(x, chains, dil)
            else:  # the wide stage: each chain through K2, then the mean
                def kernel():
                    return sum(rb.resblock_chain(x, *ch, dil, cache=cc)
                               for ch, cc in zip(chains, caches)) / len(chains)

                def plain():
                    return sum(rb.resblock_chain_plain(x, *ch, dil)
                               for ch in chains) / len(chains)

            def library():
                return sum(_library_chain(x, ch, dil) for ch in chains) / len(chains)

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
                   "fwd_rel_err": fwd_rel, "fwd_tol": fwd_tol,
                   "grad_norm_rel_err": grad_rel, "grad_tol": grad_tol,
                   "grad_max_abs_over_max_ref": grad_max_rel, "calls_per_step": calls}
            if dname == path_dtype:
                flops = 2.0 * b * sum(2 * len(dil) * k * c * c * t for k in ks)
                wbytes = sum(2 * len(dil) * k * c * c for k in ks) * 2
                xbytes = x.numel() * 2
                with torch.no_grad():
                    row["fwd_ms"] = gpu_time_ms(kernel)
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
                for f in ("fwd_ms", "fwd_bound_ms", "bwd_recompute_ms", "bwd_bound_ms",
                          "plain_fwd_bwd_ms", "cudnn_fwd_bwd_ms"):
                    per_step[name][f] += calls * row[f]
            emit({"phase": "kernel_grad_check", **row})
            require(fwd_rel <= fwd_tol and grad_rel <= grad_tol,
                    f"{name} B={b} C={c} T={t} {dname}: forward {fwd_rel}, gradient {grad_rel}")
            del out, ref, grads, ref_grads, x, chains, flat
        del chains32, x32, cot32
        torch.cuda.empty_cache()
    emit({"phase": "train_kernels_per_step",
          "per_step": {n: dict(v) for n, v in per_step.items()}})


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


def _check_wav(path, n_expect: int, what: str) -> np.ndarray:
    from rvc_tpu_torch.utils.audio_io import read_wav

    data, sr = read_wav(path)
    require(sr == 48000, f"{what}: output at {sr} Hz, not 48000")
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
    from rvc_tpu_torch.utils.audio_io import write_wav

    src = os.path.join(root, "batch_in")
    os.makedirs(src, exist_ok=True)
    lengths = {"a": 3.0, "b": 5.0, "c": 8.0, "d": 11.0}
    for i, (name, sec) in enumerate(lengths.items()):
        write_wav(os.path.join(src, f"{name}.wav"),
                  _audio(sec, np.random.default_rng(20 + i)), 16000)

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


def _write_train_dataset(exp: str, rng) -> None:
    """40 clips of 2-8 s at 48 kHz (float WAV), features [T50, 768], coarse
    f0 in 1..255 and f0 in Hz, and filelist.txt with rows
    wav|feats.npy|f0.npy|f0nsf.npy|sid, in the layout train/data.py reads."""
    from rvc_tpu_torch.utils.audio_io import write_wav

    rows = []
    for i in range(TRAIN_CLIPS):
        frames = int(rng.integers(200, 801))
        tt = np.arange(frames * 480) / 48000
        f0_hz = 120.0 + 80.0 * rng.random()
        wav = 0.3 * np.sin(2 * np.pi * f0_hz * tt) + 0.02 * rng.normal(size=tt.size)
        base = os.path.join(exp, f"clip{i:02d}")
        write_wav(base + ".wav", wav.astype(np.float32), 48000, "FLOAT")
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
        "nof0", "train", "kernels", "stages"]
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
    user_paths = [p for p in ("windowed", "batch", "nof0") if p in phases]
    root = tempfile.mkdtemp(prefix="rvc_chip_smoke_")
    try:
        if "pipeline" in phases:
            pipe, audio, index, counts, run, shapes = phase_pipeline(smi)
            launches["pipeline"], path_shapes["pipeline"] = counts, shapes
            if "stream" in phases:
                phase_stream(pipe, audio, index, smi)
        if "files" in phases or user_paths:
            files = phase_files(smi, root)
            for name in user_paths:
                phase = {"windowed": phase_windowed, "batch": phase_batch,
                         "nof0": phase_nof0}[name]
                launches[name], path_shapes[name] = phase(smi, files, root)
        grad_uses = None
        if "train" in phases:
            phase_small_train(smi)
            switches = _cuda_switches()
            launches["train"], path_shapes["train"], grad_shapes, n_steps = phase_train(
                smi, root)
            _cuda_switches(switches)  # later phases time cuDNN as earlier PRs did
            grad_uses = {k: n / n_steps for k, n in
                         collections.Counter(map(_shape_key, grad_shapes)).items()}
        if "kernels" in phases and path_shapes:  # at the shapes the paths gave
            rec = phase_kernels(path_shapes, grad_uses).get("pipeline", {})
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
