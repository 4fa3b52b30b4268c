"""rvc_tpu_torch — the PyTorch/CUDA port of rvc_tpu for NVIDIA Hopper.

The package mirrors ``rvc_tpu``'s module layout. It imports torch, numpy and
scipy only: nothing of JAX and nothing of ``rvc_tpu``. Entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
