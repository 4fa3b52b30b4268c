"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. The
build runs at first use, into ``build/kernels/`` next to the package, with
one ``nvcc`` process per source, all started together. A library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("resblock", "resblock_chain", "knn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-ldl")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256()
    for path in sorted([src] + [os.path.join(CSRC_DIR, f)
                                for f in os.listdir(CSRC_DIR)
                                if f.endswith(".cuh")]):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load the named kernel libraries."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return _libs
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name in todo:
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for name in todo:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs


def load(name: str) -> ctypes.CDLL:
    return build([name])[name]
