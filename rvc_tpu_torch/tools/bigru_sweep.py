"""Kernel G (``ops/bigru.py``) on the card: its build, its error against
the plain step loop, and its time per geometry.

    python3 -m rvc_tpu_torch.tools.bigru_sweep [--shapes B,T,H,dtype ...] [--reps 5]

Builds ``csrc/bigru.cu`` and prints ``ptxas -v``'s registers and spills of
every instantiation. Then for each shape (default: the serving paths' and
the small ``unit`` widths) and each cluster size the planner can take
there (its own choice first, then the others forced), one JSON line: the
plan, G's median ms (CUDA events, after a warm-up), the exchange-only
floor's ms and ns a step (the same geometry running only the loads and
the exchange), and, for the planner's own choice, the largest
error against ``bigru_plain`` on the same inputs and the plain version's
ms. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import bigru as bg

DEFAULT_SHAPES = ["1,1632,256,bfloat16", "1,1632,256,float32", "1,15100,256,float32",
                  "8,801,256,float32", "3,40,16,float32", "1,1632,384,bfloat16",
                  "3,1632,512,float32"]


def inputs(b, t, h, dtype, seed=0):
    """Seeded inputs on the card: xi_f, xi_b [B, T, 3H] ~ N(0, 1), wh [2, H,
    3H] ~ N(0, 1.5 / sqrt(H)), bn [2, H] ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def t_(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)

    return (t_(rng.normal(size=(b, t, 3 * h))), t_(rng.normal(size=(b, t, 3 * h))),
            t_(1.5 * h ** -0.5 * rng.normal(size=(2, h, 3 * h))),
            t_(0.1 * rng.normal(size=(2, h))))


def event_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_summary() -> list:
    """(entry, registers, spill store bytes) of every instantiation."""
    log = _build.build_log("bigru")
    rows, entry = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and entry:
            rows.append([entry, None, int(m.group(1))])
        m = re.search(r"Used (\d+) registers", ln)
        if m and rows and rows[-1][0] == entry:
            rows[-1][1] = int(m.group(1))
    return rows


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="*", default=DEFAULT_SHAPES)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.build(["bigru"])
    print(json.dumps({"gpu": smi, "ptxas": ptxas_summary()}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for spec in args.shapes:
        b, t, h, dname = spec.split(",")
        b, t, h, dtype = int(b), int(t), int(h), getattr(torch, dname)
        xi_f, xi_b, wh, bn = inputs(b, t, h, dtype)
        own = bg.plan(h, b, dtype)
        plans = [own] + [bg.plan(h, b, dtype, cluster=c) for c in bg.CLUSTERS
                         if c != own.cluster and (c - 1) * -(-h // c) < h]
        for p in plans:
            row = {"B": b, "T": t, "H": h, "dtype": dname, "planner": p is own,
                   "cluster": p.cluster, "kpt": p.kpt, "ks": p.ks, "units": p.units,
                   "threads": p.threads, "rows": p.rows, "blocks": p.blocks}
            try:
                out = bg.bigru(xi_f, xi_b, wh, bn, plan_=p)
                torch.cuda.synchronize()
            except RuntimeError as e:  # a geometry the card cannot schedule
                print(json.dumps({**row, "error": str(e)[:200]}), flush=True)
                continue
            row["ms"] = event_ms(lambda: bg.bigru(xi_f, xi_b, wh, bn, plan_=p), args.reps)
            row["floor_ms"] = event_ms(lambda: bg.bigru(xi_f, xi_b, wh, bn, plan_=p,
                                                        exchange_only=True), args.reps)
            row["floor_ns_per_step"] = 1e6 * row["floor_ms"] / t
            row["ns_per_step"] = 1e6 * row["ms"] / t
            if p is own:
                ref = bg.bigru_plain(xi_f, xi_b, wh, bn)
                row["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
                if dtype == torch.bfloat16:
                    ref32 = bg.bigru_plain(xi_f.float(), xi_b.float(), wh.float(), bn.float())
                    row["max_abs_err_vs_f32_plain"] = (out.float() - ref32).abs().max().item()
                row["plain_ms"] = event_ms(lambda: bg.bigru_plain(xi_f, xi_b, wh, bn), 1)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
