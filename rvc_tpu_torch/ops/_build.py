"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. The
build runs at first use, into ``build/kernels/`` next to the package, with
one ``nvcc`` process per source, all started together. A library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is reused. ``ptxas -v``'s account of each kernel
(registers, spills, and the C75xx notes that say it serialised ``wgmma``
products) is kept beside the library and returned by ``build_log``.
``extra_flags`` (``-D`` switches of a source, for a timing variant) build
and load a library of their own beside the port's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("resblock", "resblock_chain", "resblock_narrow", "knn", "bigru", "crepe_conv",
           "viterbi")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-ldl",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str, extra_flags: Tuple[str, ...] = ()) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256()
    for path in sorted([src] + [os.path.join(CSRC_DIR, f)
                                for f in os.listdir(CSRC_DIR)
                                if f.endswith(".cuh")]):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES,
          extra_flags: Tuple[str, ...] = ()) -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load the named kernel libraries; returns
    them by name."""
    extra_flags = tuple(extra_flags)
    names = list(names)
    with _lock:
        todo = [n for n in names if (n, extra_flags) not in _libs]
        if not todo:  # the path of every launch: no file system call
            return {n: _libs[n, extra_flags] for n in names}
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name in todo:
            out = lib_path(name, extra_flags)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
                   os.path.join(CSRC_DIR, f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            else:
                with open(f"{out}.log", "wb") as f:
                    f.write(log)
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for name in todo:
            _libs[name, extra_flags] = ctypes.CDLL(lib_path(name, extra_flags))
        return {n: _libs[n, extra_flags] for n in names}


def load(name: str, extra_flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    return build([name], extra_flags)[name]


def build_log(name: str, extra_flags: Tuple[str, ...] = ()) -> str:
    """What nvcc and ``ptxas -v`` printed when the named library was built."""
    build([name], extra_flags)
    with open(f"{lib_path(name, extra_flags)}.log", encoding="utf-8",
              errors="replace") as f:
        return f.read()
