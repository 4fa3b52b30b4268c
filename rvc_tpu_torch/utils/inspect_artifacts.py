"""Artifact shape inspector (port of ``rvc_tpu/utils/inspect_artifacts.py``):
print the shapes and dtypes inside ``.npy`` / ``.npz`` / ``.pth`` training
artifacts.

    python -m rvc_tpu_torch.utils.inspect_artifacts <files...>
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch


def inspect(path: str) -> None:
    if path.endswith(".npy"):
        a = np.load(path, mmap_mode="r")
        print(f"{path}: {a.shape} {a.dtype}")
    elif path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            for k in data.files:
                if k == "__meta__":
                    meta = json.loads(bytes(data[k]).decode())
                    print(f"{path}::__meta__: {meta}")
                else:
                    print(f"{path}::{k}: {data[k].shape} {data[k].dtype}")
    elif path.endswith((".pth", ".pt")):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj.get("model", obj) if isinstance(obj, dict) else obj
        if isinstance(sd, dict):
            for k, v in sd.items():
                shape = tuple(v.shape) if hasattr(v, "shape") else type(v).__name__
                print(f"{path}::{k}: {shape}")
    else:
        print(f"{path}: unsupported extension")


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: python -m rvc_tpu_torch.utils.inspect_artifacts <files...>")
        return 1
    for p in args:
        if os.path.exists(p):
            inspect(p)
        else:
            print(f"{p}: not found")
    return 0


if __name__ == "__main__":
    sys.exit(main())
