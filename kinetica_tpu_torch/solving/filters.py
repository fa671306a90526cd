"""Reaction filters.

Same capability as the reference's ``RxFilter``
(Julia reference src/solving/filters.jl): a list of ``(sd, rd) -> bool
mask`` functions whose masks combine by OR; ``keep_filtered`` inverts the
final mask. Masks are numpy bool arrays of length ``rd.nr``.
"""
from __future__ import annotations

import numpy as np


class RxFilter:
    def __init__(self, filters=None, keep_filtered: bool = False):
        if filters is None:
            filters = [lambda sd, rd: np.zeros(rd.nr, dtype=bool)]
        self.filters = list(filters)
        self.keep_filtered = keep_filtered

    def get_filter_mask(self, sd, rd) -> np.ndarray:
        """Combined mask: True = reaction selected by >= 1 filter
        (filters.jl:40-52)."""
        if not self.filters:
            raise ValueError("RxFilter has no filter functions defined.")
        inv_mask = ~np.asarray(self.filters[0](sd, rd), dtype=bool)
        for f in self.filters[1:]:
            inv_mask &= ~np.asarray(f(sd, rd), dtype=bool)
        mask = ~inv_mask
        if self.keep_filtered:
            mask = ~mask
        return mask


def get_filter_mask(rf: RxFilter, sd, rd) -> np.ndarray:
    return rf.get_filter_mask(sd, rd)
