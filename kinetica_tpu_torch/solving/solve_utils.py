"""Solve-core utilities (counterpart of ``kinetica_tpu/solving/solve_utils.py``).

Ported: :func:`get_max_rates`, :func:`get_initial_rates`,
:func:`calculate_discrete_rates`, :func:`apply_low_k_cutoff` and
:func:`make_u0`. Calculators return tensors on their device; these
functions hand back host numpy arrays, as the reference does. Not ported:
``insert_inert``.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..calculators.base import KineticCalculator
from ..conditions.condition_set import ConditionSet
from ..core.network import RxData, SpeciesData
from ..utils.logging import logger


def _host(k) -> np.ndarray:
    if isinstance(k, torch.Tensor):
        return k.detach().cpu().numpy()
    return np.asarray(k)


def get_max_rates(conditions: ConditionSet,
                  calculator: KineticCalculator) -> np.ndarray:
    """Max rate constants over all min/max variable-condition corners.

    Requires variable profiles to be solved (for their min/max). Returns the
    corner rate vector with the greatest mean (solve_utils.jl:19-54).
    """
    static_map = {}
    minmax_map = []
    for sym, prof in zip(conditions.symbols, conditions.profiles):
        if prof.is_static:
            static_map[sym] = prof.value
        else:
            minmax_map.append((sym, [prof.minimum(), prof.maximum()]))
    if not minmax_map:
        return _host(calculator(**static_map))
    best, best_mean = None, -np.inf
    for corner in itertools.product([0, 1], repeat=len(minmax_map)):
        cset = dict(static_map)
        for (sym, mm), pick in zip(minmax_map, corner):
            cset[sym] = mm[pick]
        rates = _host(calculator(**cset))
        if rates.mean() > best_mean:
            best, best_mean = rates, rates.mean()
    return best


def get_initial_rates(conditions: ConditionSet,
                      calculator: KineticCalculator) -> np.ndarray:
    """Rate constants at the initial conditions (solve_utils.jl:62-73)."""
    return _host(calculator(**conditions.get_initial_conditions()))


def calculate_discrete_rates(conditions: ConditionSet,
                             calculator: KineticCalculator,
                             nr: int) -> tuple[np.ndarray, np.ndarray]:
    """Precompute k at every merged tstop (solve_utils.jl:91-109).

    Returns ``(tstops, k_table)`` with ``k_table[i] = k(conditions(tstops[i]))``
    of shape (n_tstops, nr). Variable conditions are interpolated from their
    solved profiles, exactly as the reference does.
    """
    if not conditions.discrete_updates:
        raise RuntimeError("Cannot calculate discrete rates for a continuous "
                           "ConditionSet.")
    tstops = conditions.get_tstops()
    scs = conditions.get_static_conditions()
    vcs = conditions.get_variable_conditions()
    for sym, sol in vcs.items():
        if sol is None:
            raise RuntimeError(f"Variable condition {sym} has not been solved.")
    # vectorised over tstops: calculators broadcast over condition tensors
    device = getattr(calculator, "device", "cpu")
    bound = dict(scs)
    for sym, sol in vcs.items():
        bound[sym] = torch.as_tensor(sol(tstops), dtype=torch.float64,
                                     device=device)
    k_table = _host(calculator(**bound))
    if k_table.shape != (len(tstops), nr):
        # the calculator did not broadcast: one call per tstop
        k_table = np.stack([
            _host(calculator(**{s: (float(vcs[s](t)) if s in vcs else v)
                                for s, v in bound.items()}))
            for t in tstops])
    return np.asarray(tstops, dtype=np.float64), k_table


def apply_low_k_cutoff(rd: RxData, calc: KineticCalculator, pars,
                       conditions: ConditionSet) -> int:
    """Remove reactions whose max possible rate can't matter over the tspan.

    Auto cutoff = reltol / t_end; max rates are multiplied by
    ``low_k_maxconc**2`` to emulate bimolecular concentration scaling
    (solve_utils.jl:213-245). Returns the number of removed reactions.
    """
    if isinstance(pars.low_k_cutoff, str) and pars.low_k_cutoff == "none":
        logger.info("   - Low rate cutoff: none")
        return 0
    if isinstance(pars.low_k_cutoff, str) and pars.low_k_cutoff == "auto":
        k_cutoff = pars.reltol / pars.tspan[1]
        logger.info("   - Low rate cutoff: automatic (cutoff = %g)", k_cutoff)
    else:
        k_cutoff = float(pars.low_k_cutoff)
        logger.info("   - Low rate cutoff: manual (cutoff = %g)", k_cutoff)

    max_rates = get_max_rates(conditions, calc) * pars.low_k_maxconc ** 2
    low_ids = [i for i, r in enumerate(max_rates) if r < k_cutoff]
    rd.splice(low_ids)
    calc.splice(low_ids)
    logger.info("   - Removed %d low-rate reactions from network.", len(low_ids))
    return len(low_ids)


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
