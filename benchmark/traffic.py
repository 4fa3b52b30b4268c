"""The one traffic generator: a mix file's parameters and a seed in, the
requests of a closed-loop client out.

A mix fixes a set of ``set_size`` input lengths, the quantiles of its length
distribution, which every seed shares; a seed draws each set member's
signal, the order of the set in each pass over it, and each request's noise
seed. So two seeds give the same work in another order, and a run's window
sees whole passes but for the last. Signals are a voice-like tone at 16 kHz:
a fundamental drawn from the mix's pitch range and its third harmonic under
a tremolo with gaps, over a little noise."""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator, List

import numpy as np

from .weights import derive_seed


@dataclass
class Request:
    index: int          # position in the client's sequence
    member: int         # which member of the length set
    audio: np.ndarray   # float32 at the mix's rate
    seed: int           # the request's noise generator seed

    @property
    def seconds(self) -> float:
        return len(self.audio) / 16000.0


def lengths(mix: dict) -> List[int]:
    """The set's lengths in samples, from shortest to longest."""
    p = mix["lengths"]
    n = p["set_size"]
    qs = [(j + 0.5) / n for j in range(n)]
    if p["dist"] == "lognormal":
        secs = [math.exp(math.log(p["median_s"]) + p["sigma"] * NormalDist().inv_cdf(u))
                for u in qs]
    elif p["dist"] == "uniform":
        secs = [p["min_s"] + u * (p["max_s"] - p["min_s"]) for u in qs]
    else:
        raise ValueError(f"unknown length distribution {p['dist']!r}")
    rate = mix["signal"]["rate"]
    return [int(round(min(max(s, p["min_s"]), p["max_s"]) * rate)) for s in secs]


def voice(n: int, rng: np.random.Generator, s: dict) -> np.ndarray:
    t = np.arange(n) / s["rate"]
    f0 = rng.uniform(*s["f0_hz"])
    phase = rng.uniform(0, 2 * np.pi)
    tone = (np.sin(2 * np.pi * f0 * t + phase)
            + s["third_harmonic"] * np.sin(2 * np.pi * 3 * f0 * t + 3 * phase))
    env = ((0.6 + 0.4 * np.sin(2 * np.pi * s["tremolo_hz"] * t))
           * ((t % s["gap_period_s"]) < s["gap_on_s"]))
    return (s["amplitude"] * env * tone + s["noise"] * rng.normal(size=n)).astype(np.float32)


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, int(seed)
        rng = np.random.default_rng(derive_seed(seed, "signals"))
        self.set = [voice(n, rng, mix["signal"]) for n in lengths(mix)]

    def __iter__(self) -> Iterator[Request]:
        rng = np.random.default_rng(derive_seed(self.seed, "order"))
        i = 0
        while True:
            for member in rng.permutation(len(self.set)):
                yield Request(i, int(member), self.set[member],
                              derive_seed(self.seed, "request", i))
                i += 1

    def check_sample(self) -> set:
        """Request indices whose outputs are compared, drawn from the seed
        among the first ``from_first`` requests (the longest request of the
        window is compared besides)."""
        c = self.mix["check"]
        rng = np.random.default_rng(derive_seed(self.seed, "check"))
        return set(rng.choice(c["from_first"], c["requests"], replace=False).tolist())
