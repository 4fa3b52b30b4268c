"""Inference presets: named parameter bundles with JSON import/export
(port of ``rvc_tpu/utils/presets.py``, the same keys and files). A preset
stores any subset of ``VoiceConverter.convert_audio``'s keyword arguments
under ``assets/presets/<name>.json``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

PRESET_DIR = os.path.join("assets", "presets")

# knobs a preset may carry (the CLI/convert_audio surface)
PRESET_KEYS = {
    "pitch", "index_rate", "volume_envelope", "protect", "f0_method",
    "filter_radius",
    "split_audio", "f0_autotune", "f0_autotune_strength", "clean_audio",
    "clean_strength", "export_format", "embedder_model",
    "formant_shifting", "formant_qfrency", "formant_timbre",
    "post_process", "reverb", "pitch_shift", "limiter", "gain", "distortion",
    "chorus", "bitcrush", "clipping", "compressor", "delay",
    "reverb_room_size", "reverb_damping", "reverb_wet_gain", "reverb_dry_gain",
    "reverb_width", "reverb_freeze_mode", "pitch_shift_semitones",
    "limiter_threshold", "limiter_release_time", "gain_db", "distortion_gain",
    "chorus_rate", "chorus_depth", "chorus_center_delay", "chorus_feedback",
    "chorus_mix", "bitcrush_bit_depth", "clipping_threshold",
    "compressor_threshold", "compressor_ratio", "compressor_attack",
    "compressor_release", "delay_seconds", "delay_feedback", "delay_mix",
}


def save_preset(name: str, params: Dict[str, Any],
                preset_dir: str = PRESET_DIR) -> str:
    os.makedirs(preset_dir, exist_ok=True)
    clean = {k: v for k, v in params.items() if k in PRESET_KEYS}
    path = os.path.join(preset_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(clean, f, indent=2)
    return path


def load_preset(name_or_path: str, preset_dir: str = PRESET_DIR) -> Dict[str, Any]:
    path = (name_or_path if os.path.exists(name_or_path)
            else os.path.join(preset_dir, f"{name_or_path}.json"))
    with open(path) as f:
        raw = json.load(f)
    return {k: v for k, v in raw.items() if k in PRESET_KEYS}


def list_presets(preset_dir: str = PRESET_DIR) -> List[str]:
    if not os.path.isdir(preset_dir):
        return []
    return sorted(f[:-5] for f in os.listdir(preset_dir) if f.endswith(".json"))
