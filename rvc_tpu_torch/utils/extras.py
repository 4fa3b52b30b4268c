"""Small standalone helpers (port of ``rvc_tpu/utils/extras.py``).

- ``log_sigma_for_weight``: the balancer log-sigma that reproduces a loss
  weight W under the uncertainty weighting loss/(2 e^{2s}) + s, and its
  inverse ``weight_for_log_sigma``.

    python -m rvc_tpu_torch.utils.extras
"""

from __future__ import annotations

import math


def log_sigma_for_weight(weight: float) -> float:
    """Balancer log-sigma that makes the uncertainty-weighted term equal
    `weight * loss`: loss/(2 e^{2s}) = W*loss -> s = -0.5*ln(2W)."""
    if weight <= 0:
        raise ValueError("weight must be positive")
    return -0.5 * math.log(2.0 * weight)


def weight_for_log_sigma(log_sigma: float) -> float:
    """Inverse of log_sigma_for_weight."""
    return 0.5 * math.exp(-2.0 * log_sigma)


def main() -> None:  # pragma: no cover - interactive CLI
    while True:
        raw = input("Enter target scaling (positive number), or 'q' to quit: ")
        if raw.strip().lower() == "q":
            return
        try:
            w = float(raw)
            print(f"log_sigma: {log_sigma_for_weight(w):.4f}")
        except ValueError as e:
            print(e)


if __name__ == "__main__":
    main()
