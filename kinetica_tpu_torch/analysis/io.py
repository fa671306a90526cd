"""Results container of a solve.

Counterpart of ``kinetica_tpu/analysis/io.py::ODESolveOutput`` (the
reference's io.jl:3-48): the solved network, the solution traces, the
precalculated rate table, the condition traces, the parameters and the
conditions, bound together. ``save_output`` / ``load_output`` are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..conditions.condition_set import ConditionSet
from ..core.network import RxData, SpeciesData
from ..solving.params import ODESimulationParams
from ..solving.solutions import ODESolution
from ..utils.interpolation import TimeSeries


@dataclass
class ODESolveOutput:
    """Bound results of a kinetic CRN solve (io.jl:3-48)."""
    sd: SpeciesData
    rd: RxData
    sol: ODESolution
    sol_k: TimeSeries | None
    sol_vcs: dict
    pars: ODESimulationParams
    conditions: ConditionSet

    def __init__(self, solvemethod, sol: ODESolution, sd: SpeciesData,
                 rd: RxData):
        self.sd = sd
        self.rd = rd
        self.sol = sol
        self.sol_k = sol.k
        self.sol_vcs = {sym: TimeSeries(sol.t, trace)
                        for sym, trace in sol.vcs.items()}
        self.pars = solvemethod.pars
        self.conditions = solvemethod.conditions
