#!/usr/bin/env python3
"""The control of a serving cell's comparison: the plain reference put in
the program's place with every product's operands in float8 e4m3 (the
precision below the configuration's bf16), on the requests a run compares
(the seed's sample and the mix's longest member), judged by the same
comparison. Each limit in a configuration file lies below what this
reads. The benchmark's own runs never run it.

    python3 benchmark/control.py --workload nsf48.clips --seeds 5 6 7

prints one JSON line a seed: the worst of each gap over its requests."""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_gaps(cell, seed: int, device, precision: str = "fp8") -> dict:
    """The worst gaps of ``precision``'s reference standing in for the
    program, over the requests a run of ``seed`` compares."""
    import torch

    from benchmark import check, weights
    from benchmark.serve import build_shapes
    from benchmark.traffic import Traffic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, mix = cell.config, cell.traffic
    sd = weights.model_states(config, build_shapes(config), seed, device)
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
            record = check.reference_conversion(sd, index, config, mix, req, device, precision)
            g = check.gaps(sd, index, config, mix, record, device)
            worst = {n: max(worst[n], g[n]) for n in worst}
    return {"seed": seed, "precision": precision, "compared": len(reqs), "gaps": worst}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import spec

    cell = spec.load(ROOT, args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        print(json.dumps(control_gaps(cell, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
