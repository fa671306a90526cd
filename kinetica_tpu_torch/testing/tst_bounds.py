"""How far two correct evaluations of the TST rates may part.

The vibrational entropy keeps the JAX package's form
``x/expm1(x) - log1p(-exp(-x))`` (``calculators/tst.py``). For a mode with
x = e/kT near zero, ``1 - exp(-x)`` cancels: an ``exp`` one ulp off
(libraries differ: XLA's, the CPU's vectorised one, CUDA's) moves the
term by up to ``ulp * exp(-x) / (1 - exp(-x))``, ~2e-16 / x. A rate is
the exponential of the sum of such terms over its TS's modes and its
reactants' modes, so its relative difference between two libraries is
bounded by the sum of those terms over the modes, each taken at two ulps
(one for each library). For modes of 0.01 eV and up this is ~1e-13 at
most; the fake-ASE pipeline's near-zero modes (1e-11 eV: the toy
potential's free torsions and the unprojected rigid-body modes) make it
~1e-6.
"""
from __future__ import annotations

import numpy as np

from .. import constants

ULP = float(np.finfo(np.float64).eps)


def _mode_sum(table, T):
    """(len(T), n): sum over each system's modes of 2 ulp e^-x/(1-e^-x)."""
    kT = constants.kB * np.asarray(T, dtype=np.float64)[:, None, None]
    x = np.where(table.vib_mask, np.maximum(table.vib_energies / kT, 1e-12),
                 1.0)
    terms = 2.0 * ULP * np.exp(-x) / -np.expm1(-x)
    return np.sum(np.where(table.vib_mask, terms, 0.0), axis=-1)


def rate_rel_bound(calc, T) -> np.ndarray:
    """(len(T), nr) bound on the relative difference between two
    evaluations of a ``TSTCalculator``'s rates whose ``exp`` each lie
    within one ulp, from the conditioning of the vibrational entropy."""
    T = np.atleast_1d(np.asarray(T, dtype=np.float64))
    s_spec = _mode_sum(calc.species, T)
    s_ts = _mode_sum(calc.ts, T)
    reac = np.sum(calc.reac_stoic * s_spec[:, calc.reac_ids], axis=-1)
    return s_ts + reac


def entropy_abs_bound(table, T) -> np.ndarray:
    """(len(T), n) bound, in eV/K, on the difference between two
    evaluations of ``entropy`` over a table's systems whose ``exp`` each
    lie within one ulp."""
    T = np.atleast_1d(np.asarray(T, dtype=np.float64))
    return constants.kB * _mode_sum(table, T)
