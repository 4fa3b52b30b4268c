"""The narrow chain kernel N of this tree against the same kernel of another
checkout of the repo (an earlier design), at the shapes its paths give it.

    python3 -m rvc_tpu_torch.tools.narrow_ab OTHER_ROOT [--out OUT.jsonl]
        [--shapes CHIP_SMOKE.log] [--pairs N]

OTHER_ROOT holds another checkout (``git archive <commit> | tar -x -C
OTHER_ROOT``); its ``rvc_tpu_torch`` is imported under another name and
builds its own kernels under ``OTHER_ROOT/build``. For each shape (a
chain through ``resblock_chain``, or an f32 stage tail through
``mrf_stage``) both outputs are held against the plain version, and the two
are timed with CUDA events, on the same inputs in the same process, in N
rounds (default 10) of other, this, this, other; each timing is the median
of 5 launches after a warm-up. A row gives both medians, the median over
rounds of this tree's time over the other's (``ratio``), the other kernel's
own spread (the median over rounds of the gap between its two timings,
relative) and this tree's, the rounds in which this tree was the slower,
and ``slower``: the ratio exceeds 1 by more than the other kernel's own
spread. This tree's kernel is also timed with the cluster size its planner
did not choose (``cluster1_ms`` / ``cluster2_ms``). Prints the card's name
and power limit, ``ptxas``'s account of this tree's narrow kernel, and one
JSON line per shape (also written to OUT.jsonl). ``--shapes`` takes,
instead of the built-in list, every shape at which a ``chip_smoke.py``
log's ``kernel_check`` rows show the narrow kernel on a path. Needs one
H100 and ``nvcc``; the port's own tests and ``chip_smoke.py`` do not use
it.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import resblock as rb
from ..utils.weight_cache import WeightCache

# (kind, B, C, T, I/O dtype, kernel sizes, dilations, slope): the 10 s
# RefineGAN 32 kHz conversion's chains, a RefineGAN training step's (B = 8),
# the f32 stage tails of an fp32 48 kHz conversion and of 150 s, and shapes
# off the paths
SHAPES = [
    *[("chain", 1, c, t, torch.bfloat16, (k,), (1, 3, 5), 0.2)
      for c, t in ((64, 255680), (32, 511360)) for k in (3, 7, 11)],
    *[("chain", 8, c, t, torch.bfloat16, (k,), (1, 3, 5), 0.2)
      for c, t in ((64, 6400), (32, 12800)) for k in (3, 7, 11)],
    ("stage", 1, 64, 383520, torch.float32, (3, 7, 11), (1, 3, 5), 0.1),
    ("stage", 1, 32, 767040, torch.float32, (3, 7, 11), (1, 3, 5), 0.1),
    ("stage", 1, 32, 3743040, torch.float32, (3, 7, 11), (1, 3, 5), 0.1),
    ("chain", 2, 32, 1, torch.bfloat16, (11,), (1, 3, 5), 0.2),
    ("chain", 1, 16, 9001, torch.float32, (11,), (1, 3, 5), 0.1),
    ("stage", 2, 48, 9001, torch.float32, (3, 7), (1, 3), 0.1),
    # configs the earlier planner refused (ROADMAP C1)
    ("stage", 1, 64, 383520, torch.float32, (3, 7, 15), (1, 3, 5), 0.1),
    ("stage", 1, 32, 767040, torch.float32, (3, 7, 11), (1, 3, 9), 0.1),
    ("chain", 1, 64, 255680, torch.bfloat16, (11,), (1, 3, 5, 7), 0.1),
]
_narrow_plan = rb.narrow_plan


def _time_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _rounds(that, this, pairs: int):
    """``pairs`` rounds of (that, this, this, that), timed: both medians,
    the median ratio this / that over rounds, each kernel's own spread
    between its two timings of a round, and the verdict."""
    quads = [[_time_ms(f) for f in (that, this, this, that)] for _ in range(pairs)]
    ratios = [(b1 + b2) / (a1 + a2) for a1, b1, b2, a2 in quads]
    own = statistics.median(abs(a1 - a2) / (a1 + a2) * 2 for a1, _, _, a2 in quads)
    ratio = statistics.median(ratios)
    return {"other_ms": statistics.median(q[i] for q in quads for i in (0, 3)),
            "ms": statistics.median(q[i] for q in quads for i in (1, 2)),
            "ratio": ratio, "other_spread": own,
            "this_spread": statistics.median(abs(b1 - b2) / (b1 + b2) * 2
                                             for _, b1, b2, _ in quads),
            "slower_rounds": sum(r > 1 for r in ratios), "rounds": pairs,
            "slower": ratio - 1 > own, "quads_ms": quads}


def _path_shapes(log: str):
    """The shapes of the narrow kernel's ``kernel_check`` rows on a path in
    a ``chip_smoke.py`` log, each once, as SHAPES lists them."""
    shapes = []
    with open(log, encoding="utf-8", errors="replace") as f:
        for ln in f:
            if not ln.startswith("{"):
                continue
            r = json.loads(ln)
            if (r.get("phase") != "kernel_check" or r.get("kernel") != "narrow_chain"
                    or not r.get("on_path")):
                continue
            sh = ("stage" if "ks" in r else "chain", r["B"], r["C"], r["T"],
                  getattr(torch, r["dtype"]), tuple(r.get("ks") or [r["K"]]),
                  tuple(r["dil"]), r["slope"])
            if sh not in shapes:
                shapes.append(sh)
    return shapes


def _other_resblock(root: str):
    """The other checkout's ``rvc_tpu_torch.ops.resblock``, imported as
    ``other_rvc_tpu_torch``."""
    name, pkg = "other_rvc_tpu_torch", os.path.join(root, "rvc_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.resblock")


@contextlib.contextmanager
def _patched(name, value):
    old = getattr(rb, name)
    setattr(rb, name, value)
    try:
        yield
    finally:
        setattr(rb, name, old)


def _alternatives(c, ks, dil, t, b):
    """This tree's kernel with the cluster size its planner did not choose,
    where that fits."""
    plan = rb.narrow_plan(c, ks, dil, t, b)
    other = 3 - plan.cluster
    if other * plan.rows - 2 * plan.halo < 1:
        return {}
    return {f"cluster{other}": lambda: _patched(
        "narrow_plan", functools.partial(_narrow_plan, cluster=other))}


def _chains(gen, c, ks, dil):
    def w(k):
        return (torch.randn((c, c, k), generator=gen) * (0.5 / (c * k) ** 0.5)).cuda()

    def b():
        return (torch.randn((c,), generator=gen) * 0.05).cuda()

    return [([w(k) for _ in dil], [b() for _ in dil], [w(k) for _ in dil],
             [b() for _ in dil]) for k in ks]


def _rel(ref, out):
    return float((ref.float() - out.float()).abs().max() / ref.float().abs().max().clamp(min=1e-12))


def _run(mod, kind, x, chains, ks, dil, slope, cache):
    if kind == "stage":
        return lambda: mod.mrf_stage(x, chains, ks, dil, slope, cache=cache)
    return lambda: mod.resblock_chain(x, *chains[0], dil, slope, cache=cache)


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="narrow_ab")
    ap.add_argument("other_root")
    ap.add_argument("--out")
    ap.add_argument("--shapes")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args(argv[1:])
    if not torch.cuda.is_available():
        print("narrow_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    other = _other_resblock(args.other_root)
    out_path = args.out
    shapes = _path_shapes(args.shapes) if args.shapes else SHAPES
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    log = _build.build_log("resblock_narrow")
    print(json.dumps({"ptxas": {
        "registers": [int(n) for n in re.findall(r"Used (\d+) registers", log)],
        "spill_store_bytes": [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)],
        "notes": sorted(set(re.findall(r"C75\d\d", log)))}}), flush=True)
    rows, ok = [], True
    gen = torch.Generator().manual_seed(0)
    for kind, b, c, t, dtype, ks, dil, slope in shapes:
        chains = _chains(gen, c, ks, dil)
        x = (torch.randn((b, c, t), generator=gen) * 0.3).cuda().to(dtype)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        ref = (rb.mrf_stage_plain(x, chains, dil, slope) if kind == "stage"
               else rb.resblock_chain_plain(x, *chains[0], dil, slope))
        this = _run(rb, kind, x, chains, ks, dil, slope, WeightCache())
        rb.reset_launches()
        err, bad = _rel(ref, this()), False
        row = {"cluster": rb.narrow_plan(c, ks, dil, t, b).cluster if c <= 64 else None,
               "kind": kind, "B": b, "C": c, "T": t, "dtype": str(dtype)[6:],
               "ks": list(ks), "dil": list(dil), "slope": slope, "rel_err": err,
               "tol": tol, "launches": dict(rb.launches)}
        try:
            that = _run(other, kind, x, chains, ks, dil, slope, other.WeightCache())
            row["other_rel_err"] = _rel(ref, that())
        except ValueError as e:  # the other planner refuses the shape
            that, row["other"] = None, str(e)
        if that is not None:
            row.update(_rounds(that, this, args.pairs))
        else:
            row["ms"] = _time_ms(this)
        if rb.launches["narrow_chain"]:
            for name, fn in _alternatives(c, ks, dil, t, b).items():
                with fn():
                    alt = _run(rb, kind, x, chains, ks, dil, slope, WeightCache())
                    row[f"{name}_rel_err"] = _rel(ref, alt())
                    row[f"{name}_ms"] = _time_ms(alt)
                    bad |= row[f"{name}_rel_err"] > tol
        ok &= err <= tol and not bad
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, chains, ref
        torch.cuda.empty_cache()
    if out_path:
        with open(out_path, "w") as f:
            for row in rows:
                f.write(json.dumps({"gpu": smi, **row}) + "\n")
    print(json.dumps({"ok": ok, "gpu": smi}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
