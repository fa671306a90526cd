"""The one traffic generator: a mix's file in, batches of ramps out.

A mix (``traffic/<name>.json``) gives the batch ``B``, the ramp's start
temperature ``T0``, the range of heating rates ``[rate_lo, rate_hi]``
(K/s), ``strata`` and ``rates_seed``. The lanes of all solves of a run,
in order, are cut into groups of ``strata`` lanes; each group holds one
rate from each of ``strata`` equal slices of the range, uniform inside
its slice. The rates come from ``rates_seed``, the mix's own; the run's
seed orders the lanes inside each group. So every seed solves the same
set of ramps in another order, and a run's work does not move with its
seed (a batch's steps are those of its slowest lane: drawn rates moved a
64-lane batch between 931 and 1118 steps); no two lanes of a run share a
rate, so no solve repeats another. Solve ``k`` takes lanes
``[k B, (k + 1) B)``; a window ends only where a group ends (``whole``),
so each run solves whole groups, the same ramps whatever its seed.

Streams: the window's solves, the warm-up batch and the correctness
sample are drawn from separate streams of one seed.
"""
from __future__ import annotations

import numpy as np

WINDOW, WARMUP, SAMPLE = 0, 1, 2


def seed_words(seed: int, stream: int) -> list[int]:
    """Any whole number (negative, or past 64 bits) as SeedSequence words."""
    s = int(seed)
    words = [abs(s) & 0xFFFFFFFF, (abs(s) >> 32) & 0xFFFFFFFF, int(s < 0)]
    return words + [stream]


class Ramps:
    """The run's rates, drawn lazily, solve by solve."""

    def __init__(self, traffic: dict, seed: int, stream: int = WINDOW):
        ramp = traffic["ramp"]
        self.batch = int(traffic["batch"])
        self.lo, self.hi = float(ramp["rate_lo"]), float(ramp["rate_hi"])
        self.strata = int(ramp["strata"])
        if not (self.batch >= 1 and self.strata >= 1 and self.hi > self.lo):
            raise ValueError(f"bad mix {traffic.get('name')!r}")
        self._rates = np.random.default_rng([int(ramp["rates_seed"]), stream])
        self._order = np.random.default_rng(seed_words(seed, stream))
        self._lanes = np.empty(0)

    def _group(self) -> np.ndarray:
        inner = self._rates.random(self.strata)
        rates = self.lo + (self.hi - self.lo) * (np.arange(self.strata)
                                                 + inner) / self.strata
        return rates[self._order.permutation(self.strata)]

    @property
    def whole(self) -> bool:
        """Whether the solves so far hold whole groups."""
        return self._lanes.size == 0

    def next_batch(self) -> np.ndarray:
        """The next solve's (B,) heating rates."""
        while self._lanes.size < self.batch:
            self._lanes = np.concatenate([self._lanes, self._group()])
        out, self._lanes = self._lanes[:self.batch], self._lanes[self.batch:]
        return out
