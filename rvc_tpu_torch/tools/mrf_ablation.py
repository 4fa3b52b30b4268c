"""What holds kernel K1 ``mrf_stage`` of the PyTorch port: its time with
parts compiled out, at the three stage widths of the 48 kHz serving path.

    python3 -m rvc_tpu_torch.tools.mrf_ablation [variant,variant,...]

Builds ``rvc_tpu_torch/csrc/resblock.cu`` once per variant (``whole`` and
the ``-DMRF_ABLATE_*`` switches the source documents) and times one bf16
launch per width with CUDA events (median of 5 after a warm-up). A
variant's output is wrong by design; only ``whole`` is held against the
plain version. Prints the card's name and power limit and one JSON line
per variant. Needs one H100 and ``nvcc``.
"""

from __future__ import annotations

import collections
import json
import re
import statistics
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import resblock as rb

SHAPES = [(128, 191760), (64, 383520), (32, 767040)]
KS, DIL = (3, 7, 11), (1, 3, 5)
VARIANTS = {
    "whole": (),
    "no_products": ("PRODUCTS",),
    "no_copies": ("COPIES",),
    "no_epilogue": ("EPILOGUE",),
    "no_io": ("IO",),
    "no_load": ("LOAD",),
    "no_reload": ("RELOAD",),
    "no_scratch": ("SCRATCH",),
    "no_store": ("STORE",),
}


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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_mrf_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    names = argv[1].split(",") if len(argv) > 1 else list(VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(0)
    cases = []
    for c, t in SHAPES:
        def w(k):
            return (torch.randn((c, c, k), generator=gen) * (0.5 / (c * k) ** 0.5)).cuda()

        def b():
            return (torch.randn((c,), generator=gen) * 0.05).cuda()

        chains = [([w(k) for _ in DIL], [b() for _ in DIL],
                   [w(k) for _ in DIL], [b() for _ in DIL]) for k in KS]
        x = (torch.randn((1, c, t), generator=gen) * 0.3).cuda().to(torch.bfloat16)
        plan = rb.stage_plan(c, KS, DIL)
        cases.append((c, x, chains, plan, rb.pack_stage(chains, plan.cp)))
    for name in names:
        flags = tuple(f"-DMRF_ABLATE_{s}" for s in VARIANTS[name])
        log = _build.build_log("resblock", flags)
        fn = rb._stage_fn(flags)
        # a variant that ptxas serialised (C7518, C7520) says nothing of the rest
        row = {"variant": name,
               "ptxas_notes": dict(collections.Counter(re.findall(r"C75\d\d", log))),
               "spill_store_bytes": [int(n) for n in
                                     re.findall(r"(\d+) bytes spill stores", log)]}
        for c, x, chains, plan, packed in cases:
            def run():
                return rb._launch_stage(fn, x, plan, packed, KS, DIL, 0.1)

            row[f"C{c}_ms"] = _time_ms(run)
            if name == "whole":
                ref = rb.mrf_stage_plain(x, chains, DIL).float()
                row[f"C{c}_rel_err"] = ((ref - run().float()).abs().max()
                                        / ref.abs().max()).item()
        row["sum_ms"] = sum(v for k, v in row.items() if k.endswith("_ms"))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
