#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``rvc_tpu_torch``).

    python3 benchmark/run.py --workload nsf48.clips --seed 7 --seconds 10 --trace 0

runs one cell of ``BENCHMARK.json`` on the card it is started on and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown`` and ``audio_s_per_s`` (the main and the profiled window's
rates), and last ``checks``, each compared number beside its limit
(also the last lines of standard error). It exits non-zero with no result
line without a CUDA card, when the JAX package or JAX was loaded, or when
the port is not beside it. Kernel libraries build into ``build/kernels/``,
Triton's and PyTorch's extension caches into ``build/triton/`` and
``build/torch_extensions/`` of the checkout."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "rvc_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(args, device_name: str = "cuda", root: str = ROOT):
    """The cell of ``root``'s ``BENCHMARK.json`` on ``device_name`` (the CPU
    only for rehearsals at tiny sizes), run by its mix's kind: the result
    line's object."""
    import torch

    from benchmark import spec

    cell = spec.load(root, args.workload)
    kind = spec.kind(cell)
    device = torch.device(device_name)
    res = kind.run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                "memory_peak_bytes": res["memory_peak_bytes"]}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return kind.result(cell, res, bool(args.trace), info)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    # one process with few threads: the host's share of a conversion is
    # serial, and idle pool threads only add jitter on a shared host
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)

    from benchmark import spec

    cell = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(args)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, g in out["checks"].items():
        print(f"check {name} {g['value']!r} limit {g['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
