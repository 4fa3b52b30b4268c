"""Text-to-speech front end of the TTS -> conversion chain (port of
``rvc_tpu/utils/tts.py``).

The reference runs edge-tts (rvc/lib/tools/tts.py:1-29) and feeds its WAV to
``convert_audio`` (core.py:352-410). edge-tts needs the network; without
it a deterministic offline synthesizer, sample for sample the JAX
package's, stands in, so that the chain runs end to end (it is not speech).
The voice list is the repo's ``assets/tts_voices.json`` catalog.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess

import numpy as np

from .audio_io import write_wav

DEFAULT_VOICE = "en-US-AriaNeural"


def _fallback_tts(text: str, output_path: str, sr: int = 16000) -> None:
    """Deterministic phrase-shaped babble: a gliding voiced tone under a
    slow formant envelope keyed off the text's hash, gated into word-like
    bursts, 60 ms per character (at least 0.5 s)."""
    # a process-stable seed (hash() is salted per process)
    seed = int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    total = max(0.5, len(text) * 0.06)
    t = np.arange(int(total * sr)) / sr
    f0 = 140.0 + 20.0 * np.sin(2 * np.pi * 0.8 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.25 * np.sin(3 * phase)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * (1.5 + rng.random()) * t + rng.random())
    audio = (voiced * env * 0.25).astype(np.float32)
    gate = (np.sin(2 * np.pi * 2.5 * t) > -0.7).astype(np.float32)
    write_wav(output_path, audio * gate, sr, subtype="FLOAT")


def _rate(rate: int) -> str:
    return f"+{rate}%" if rate >= 0 else f"{rate}%"


def run_tts(text: str, voice: str, rate: int, output_path: str) -> str:
    """Synthesize ``text`` into ``output_path``: the ``edge-tts`` program,
    else the ``edge_tts`` package, else (no edge-tts, or no network) the
    offline synthesizer."""
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    if shutil.which("edge-tts"):
        subprocess.run(["edge-tts", "--text", text, "--voice", voice, "--rate",
                        _rate(rate), "--write-media", output_path], check=True)
        return output_path
    try:
        import asyncio

        import edge_tts

        asyncio.run(edge_tts.Communicate(text, voice, rate=_rate(rate)).save(output_path))
    except Exception:  # no package or no network: the chain still runs
        print("edge-tts unavailable (no network?); using the offline fallback TTS")
        _fallback_tts(text, output_path)
    return output_path


def _catalog_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets", "tts_voices.json")


def load_voice_catalog() -> list:
    """The edge-tts neural voices (ShortName, Gender, Locale,
    FriendlyName) of the repo's catalog; the default voice alone where the
    catalog is not installed."""
    try:
        with open(_catalog_path(), encoding="utf-8") as f:
            return json.load(f)
    except OSError:
        return [{"ShortName": DEFAULT_VOICE, "Gender": "Female", "Locale": "en-US",
                 "FriendlyName": DEFAULT_VOICE}]


def list_voices() -> list:
    """Every voice: the live list where edge-tts reaches the network, else
    the catalog's."""
    try:
        import asyncio

        import edge_tts

        return sorted(v["ShortName"] for v in asyncio.run(edge_tts.list_voices()))
    except Exception:  # no package or no network
        return [v["ShortName"] for v in load_voice_catalog()]
