"""Host-side audio I/O (port of ``rvc_tpu/utils/audio_io.py``).

WAV through ``scipy.io.wavfile`` (PCM 8/16/32-bit and float32), FLAC
through the repo's C++ codec, other containers through an ``ffmpeg`` on
PATH. Resampling runs the C++ polyphase engine (``utils/native.py``) and
falls back to ``scipy.signal.resample_poly``, as the JAX package does, so
both packages give the same samples on the same machine.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from . import native


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """A WAV file -> (float32 samples in [-1, 1] shaped [T] or [T, C], sr)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, int(sr)


def write_wav(path: str, data: np.ndarray, sr: int, subtype: str = "PCM_16") -> None:
    """Write float32 [-1, 1] samples as WAV (PCM_16, PCM_32 or FLOAT); a
    [C, T] array with C <= 8 is taken as channels first."""
    data = np.asarray(data)
    if data.ndim == 2 and data.shape[0] < data.shape[-1] and data.shape[0] <= 8:
        data = data.T
    if subtype == "PCM_16":
        out = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    elif subtype == "PCM_32":
        # in float64: float32(2147483647) rounds up to 2^31 and would wrap
        out = (np.clip(data.astype(np.float64), -1.0, 1.0)
               * 2147483647.0).astype(np.int32)
    elif subtype == "FLOAT":
        out = data.astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV subtype {subtype!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wavfile.write(path, sr, out)


def wav_frames(path: str) -> Optional[int]:
    """Frame count of a RIFF WAV from its header alone: the ``data`` chunk's
    bytes over the ``fmt `` chunk's block align (any sample format); None
    when the file is not a parseable RIFF WAV."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
                return None
            block_align = data_size = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid, size = hdr[:4], int.from_bytes(hdr[4:8], "little")
                if cid == b"fmt " and size >= 16:
                    fmt = f.read(size + (size & 1))
                    block_align = int.from_bytes(fmt[12:14], "little")
                elif cid == b"data":
                    data_size = size
                    break
                else:
                    f.seek(size + (size & 1), os.SEEK_CUR)
            if not block_align or data_size is None:
                return None
            return data_size // block_align
    except OSError:
        return None


def to_mono(data: np.ndarray) -> np.ndarray:
    return data.mean(axis=-1) if data.ndim == 2 else data


def resample(data: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling: the C++ engine for [T] audio, else scipy."""
    if orig_sr == target_sr:
        return data.astype(np.float32)
    if data.ndim == 1:
        out = native.resample(data, orig_sr, target_sr)
        if out is not None:
            return out
    ratio = Fraction(target_sr, orig_sr)
    return resample_poly(data, ratio.numerator, ratio.denominator,
                         axis=0).astype(np.float32)


def _read_via_ffmpeg(path: str) -> Optional[Tuple[np.ndarray, int]]:
    if shutil.which("ffmpeg") is None:
        return None
    proc = subprocess.run(["ffmpeg", "-v", "error", "-i", path, "-f", "f32le",
                           "-ac", "1", "-ar", "48000", "-"], capture_output=True)
    if proc.returncode != 0:
        raise ValueError(f"ffmpeg failed on {path}: {proc.stderr.decode()[:200]}")
    return np.frombuffer(proc.stdout, np.float32).copy(), 48000


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Any supported container -> (float32 [T] or [T, C], sr)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"RIFF":
        return read_wav(path)
    if magic == b"fLaC":
        out = native.flac_read(path)
        if out is not None:
            return out
    via = _read_via_ffmpeg(path)
    if via is not None:
        return via
    raise ValueError(f"cannot decode {path!r}: WAV and FLAC are read natively; "
                     "mp3/ogg/m4a need an ffmpeg binary on PATH")


def load_audio(path: str, target_sr: Optional[int] = None) -> np.ndarray:
    """Read, mix to mono and resample to ``target_sr``: float32 [T]."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"audio file not found: {path}")
    data, sr = read_audio(path)
    data = to_mono(data)
    if target_sr is not None and sr != target_sr:
        data = resample(data, sr, target_sr)
    return data.astype(np.float32)


def save_audio(path: str, data: np.ndarray, sr: int, fmt: Optional[str] = None) -> None:
    """Save audio as FLAC when ``fmt`` or the extension says so (and the
    codec is there), else as 16-bit WAV."""
    ext = (fmt or os.path.splitext(path)[1].lstrip(".")).lower()
    if ext == "flac" and native.flac_write(path, np.asarray(data), sr):
        return
    write_wav(path, data, sr)
