"""Solve-core utilities (counterpart of ``kinetica_tpu/solving/solve_utils.py``).

Ported: :func:`make_u0`. The rate screening, discrete-rate tables, inert
insertion and low-k cutoff belong to solve paths that are not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..core.network import SpeciesData


def make_u0(sd: SpeciesData, pars) -> np.ndarray:
    """Initial concentration vector from pars.u0 (solve_utils.jl:262-297)."""
    if not isinstance(pars.u0, dict):
        u0_in = np.asarray(pars.u0, dtype=np.float64)
        if len(u0_in) != sd.n:
            if pars.allow_short_u0:
                u0 = np.zeros(sd.n)
                u0[: len(u0_in)] = u0_in
            else:
                raise ValueError(
                    "Length of supplied initial concentration vector does not "
                    "match with number of species in system.")
        else:
            u0 = u0_in
        return u0
    u0 = np.zeros(sd.n, dtype=np.float64)
    for spec, conc in pars.u0.items():
        if spec not in sd.toInt:
            raise KeyError(f"Species {spec} not in SpeciesData. "
                           "Check pars.u0 is correct.")
        u0[sd.toInt[spec]] = conc
    return u0
