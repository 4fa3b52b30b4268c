"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

# streaming multiprocessors of an H100 SXM: what the kernels' planners fill
H100_SMS = 132


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """Return the torch device an entry point runs on.

    The default is the card. Without a CUDA device this raises instead of
    quietly running on the CPU: a caller who wants the CPU says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rvc_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    return dev
