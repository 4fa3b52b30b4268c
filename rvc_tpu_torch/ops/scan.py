"""Doubling (Hillis-Steele) scans for the output effects' recursions.

Both run along the first axis of a tensor, every column an independent
lane, in ceil(log2(n)) steps of whole-tensor operations: no loop over
samples or rows, no host round trip, on whatever device the tensor is on.

- ``linear_recurrence``: y[k] = a * y[k-1] + u[k] (zero initial state),
  by y[s:] += a^s * y[:-s] for s = 1, 2, 4, ... It is a one-pole
  ``lfilter`` along axis 0; a delay of d samples is the recurrence over the
  rows of the signal viewed as (m, d).
- ``decay_max``: r[k] = max(x[k], rel * r[k-1]) (r[-1] = 0 for x >= 0), by
  r[s:] = max(r[s:], rel^s * r[:-s]): a peak follower's release.

After the step of shift s, y[k] holds the recurrence over the 2s inputs
ending at k; each step reads the previous step's tensor, so the update is
out of place.
"""

from __future__ import annotations

import torch


def _shifts(n: int):
    s = 1
    while s < n:
        yield s
        s *= 2


def linear_recurrence(u: torch.Tensor, a: float) -> torch.Tensor:
    """y[k] = a * y[k-1] + u[k] along axis 0, y[-1] = 0."""
    y = u
    for s in _shifts(u.shape[0]):
        y = torch.cat([y[:s], y[s:] + (a ** s) * y[:-s]])
    return y


def decay_max(x: torch.Tensor, rel: float) -> torch.Tensor:
    """r[k] = max(x[k], rel * r[k-1]) along axis 0, for x >= 0."""
    r = x
    for s in _shifts(x.shape[0]):
        r = torch.cat([r[:s], torch.maximum(r[s:], (rel ** s) * r[:-s])])
    return r
