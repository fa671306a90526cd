"""The program's inputs, built from the benchmark's own arrays.

The benchmark makes the network (``network.py``) and the ramps
(``traffic.py``) itself and hands the same arrays to the program, through
the functions here, and to the reference. Everything imported here is
public API of ``kinetica_tpu_torch``, the system under test.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .network import Network


@dataclass
class Solved:
    """One solve's answers: ``u`` (B, saves, ns) float64 states at the
    start and at each chunk's end; per lane ``ok`` (the program's success
    retcode), ``n_steps`` and ``n_lu`` (factor builds, a lane each);
    ``attempts``, the program's solves of the batch (more than 1 where
    it retried failed lanes with tighter tolerances)."""
    u: np.ndarray
    ok: np.ndarray
    n_steps: np.ndarray
    n_lu: np.ndarray
    attempts: int = 1

    @property
    def steps_max(self) -> int:
        return int(self.n_steps.max())


def species_reactions(net: Network):
    """The program's ``(SpeciesData, RxData)`` for ``net``."""
    from kinetica_tpu_torch.core.network import RxData, SpeciesData
    sd = SpeciesData(list(net.species))
    names = net.species
    rd = RxData.from_reactions(
        sd, [[names[s] for s in r] for r in net.reactants],
        [[names[s] for s in p] for p in net.products], dH=[0.0] * net.nr)
    if rd.nr != net.nr:
        raise ValueError(f"the program kept {rd.nr} of {net.nr} reactions")
    return sd, rd


def calculator(config: dict, net: Network, device):
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    rates = config["rates"]
    if rates["calculator"] != "PrecalculatedArrheniusCalculator":
        raise ValueError(f"unknown calculator {rates['calculator']!r}")
    return PrecalculatedArrheniusCalculator(net.Ea, net.A,
                                            k_max=rates["k_max"],
                                            device=device)


def params(config: dict, traffic: dict, tf: float):
    """``ODESimulationParams`` of a chunked solve over ``[0, tf]`` at the
    configuration's tolerances and the mix's settings."""
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    solver = config["solver"]
    kw = dict(abstol=solver["abstol"], reltol=solver["reltol"],
              dtype=solver["dtype"],
              low_k_cutoff=config["rates"]["low_k_cutoff"],
              **traffic["settings"])
    return ODESimulationParams(tspan=(0.0, tf), u0=dict(config["initial"]),
                               solve_chunks=True,
                               solve_chunkstep=traffic["chunk"], **kw)


def ramps(rates: np.ndarray, T0: float, tf: float) -> list:
    """One ``ConditionSet`` a lane: T from ``T0`` at ``rate`` K/s to the
    end of the span."""
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    return [ConditionSet({"T": LinearGradientProfile(
        rate=float(r), X_start=T0, X_end=T0 + float(r) * tf)})
        for r in rates]


def success(retcodes) -> np.ndarray:
    from kinetica_tpu_torch.solving.solutions import RETCODE_SUCCESS
    return np.array([rc == RETCODE_SUCCESS for rc in retcodes])
