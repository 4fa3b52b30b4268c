"""The model blender's core (port of ``rvc_tpu/utils/blender_gui.py``):
``normalize_sr`` ("48k" -> 48000) and ``model_blender``. Its display-bound
launcher is part of the UI, which the port does not have yet."""

from __future__ import annotations

from .checkpoints import normalize_sr
from .model_tools import model_blender

__all__ = ["model_blender", "normalize_sr"]
