"""Environment check of the port (port of ``rvc_tpu/utils/env_check.py``):
Python and torch, CUDA and ``nvcc``, Triton, the card (name, memory, power
limit), whether the kernels are built, the repo's native audio engine, and
the wheels the port uses.

    python -m rvc_tpu_torch.utils.env_check
"""

from __future__ import annotations

import glob
import importlib
import os
import shutil
import subprocess
import sys
from typing import Any, Dict

WHEELS = ("torch", "numpy", "scipy", "triton", "matplotlib", "tensorboard")


def _version(name: str):
    try:
        return getattr(importlib.import_module(name), "__version__", "present")
    except ImportError:
        return None


def _nvcc_release():
    from ..ops._build import nvcc_path

    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, check=True).stdout
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[-1] if lines else None


def _nvidia_smi():
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def check_environment(verbose: bool = True) -> Dict[str, Any]:
    import torch

    from ..ops._build import BUILD_DIR
    from . import native

    report: Dict[str, Any] = {"python": sys.version.split()[0],
                              "torch": torch.__version__,
                              "cuda": torch.version.cuda,
                              "nvcc": _nvcc_release(),
                              "triton": _version("triton")}
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        report["device"] = props.name
        report["device_count"] = torch.cuda.device_count()
        report["device_memory_gb"] = round(props.total_memory / 2 ** 30, 1)
        report["nvidia_smi"] = _nvidia_smi()
    else:
        report["device"] = None
    report["kernels_built"] = sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(BUILD_DIR, "*.so")))
    report["native_audio_engine"] = native.get_lib() is not None
    report["wheels"] = {name: _version(name) for name in WHEELS}

    if verbose:
        for k, v in report.items():
            if k == "wheels":
                print(f"wheels present: {', '.join(n for n, ver in v.items() if ver)}")
                missing = [n for n, ver in v.items() if not ver]
                if missing:
                    print(f"wheels missing: {', '.join(missing)}")
            else:
                print(f"{k}: {v}")
    return report


if __name__ == "__main__":
    check_environment()
