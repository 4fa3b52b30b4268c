"""ctypes binding of the repo's C++ audio engine (``native/audio_engine.cpp``:
Kaiser-windowed polyphase resampler; ``native/flac_codec.cpp``: FLAC).

The sources are compiled at first use with the flags of ``native/Makefile``
into the gitignored ``build/native/`` beside the package (a library's name
carries a hash of its sources, its flags and the host's target, and a
finished build is renamed into place, so concurrent builds never load a
half-written file). Each
wrapper returns None when no library can be built; callers then take
scipy's path, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "native")
SOURCES = ("audio_engine.cpp", "flac_codec.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_state = {"lib": None, "tried": False}


def _lib_path() -> str:
    """The library's path: a hash of the sources, the flags and what
    ``-march=native`` means on this host (its target options), so that a
    build directory carried to another machine is not loaded there."""
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                            capture_output=True, timeout=60, check=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + target)
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libaudio_engine_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp,
                        *(os.path.join(NATIVE_DIR, n) for n in SOURCES)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The engine's library, built on first use; None when it cannot be
    built or loaded."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        try:
            path = _lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"native audio engine unavailable ({e}); using scipy")
            return None
        f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
        i32p, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.c_int64
        lib.resample_poly.restype = i64
        lib.resample_poly.argtypes = [f32p, i64, ctypes.c_double,
                                      ctypes.c_double, f32p]
        lib.flac_probe.restype = ctypes.c_int32
        lib.flac_probe.argtypes = [u8p, i64, i32p, i32p, i32p,
                                   ctypes.POINTER(ctypes.c_int64)]
        lib.flac_decode.restype = i64
        lib.flac_decode.argtypes = [u8p, i64, f32p, i64]
        lib.flac_encode.restype = i64
        lib.flac_encode.argtypes = [f32p, i64, ctypes.c_int32, ctypes.c_int32,
                                    u8p, i64]
        _state["lib"] = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resample(data: np.ndarray, orig_sr: int, target_sr: int) -> Optional[np.ndarray]:
    """Polyphase resample of [T] audio; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(data, np.float32)
    n_out = lib.resample_poly(_fptr(x), len(x), float(orig_sr),
                              float(target_sr), None)
    out = np.empty(n_out, np.float32)
    lib.resample_poly(_fptr(x), len(x), float(orig_sr), float(target_sr),
                      _fptr(out))
    return out


def flac_read(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Decode a FLAC file -> (float32 [T] or [T, C], sample rate); None
    without the library. A corrupt or truncated stream raises ValueError."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    sr, ch, bps = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    total = ctypes.c_int64()
    if lib.flac_probe(_u8ptr(raw), len(raw), ctypes.byref(sr), ctypes.byref(ch),
                      ctypes.byref(bps), ctypes.byref(total)) != 0:
        raise ValueError(f"not a decodable FLAC file: {path}")
    # the sample count may be unknown (0): grow the buffer until it is not
    # filled exactly
    cap = total.value if total.value > 0 else max(
        4096, (len(raw) * 8 // max(bps.value, 1)) * 2)
    while True:
        out = np.empty(cap * ch.value, np.float32)
        n = lib.flac_decode(_u8ptr(raw), len(raw), _fptr(out), cap)
        if n < 0:
            raise ValueError(f"FLAC decode failed: {path}")
        if n < cap or total.value > 0:
            break
        cap *= 2
    if total.value > 0 and n < total.value:
        raise ValueError(f"FLAC stream truncated/corrupt: decoded {n} of "
                         f"{total.value} samples in {path}")
    data = out[:n * ch.value].reshape(n, ch.value)
    return (data[:, 0] if ch.value == 1 else data), int(sr.value)


def flac_write(path: str, data: np.ndarray, sr: int) -> bool:
    """Encode float32 [-1, 1] [T] or [T, C] audio as 16-bit FLAC; False
    without the library or for empty input."""
    lib = get_lib()
    if lib is None:
        return False
    x = np.asarray(data, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    inter = np.ascontiguousarray(x.reshape(-1))
    bound = lib.flac_encode(_fptr(inter), x.shape[0], x.shape[1], sr, None, 0)
    if bound <= 0:
        return False
    buf = np.empty(bound, np.uint8)
    written = lib.flac_encode(_fptr(inter), x.shape[0], x.shape[1], sr,
                              _u8ptr(buf), bound)
    if written < 0:
        raise ValueError("FLAC encode failed")
    with open(path, "wb") as f:
        f.write(buf[:written].tobytes())
    return True
