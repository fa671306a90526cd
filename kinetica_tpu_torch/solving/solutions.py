"""Solution containers.

TPU-native analog of the reference's solution layer
(Julia reference src/solving/solutions.jl): an ODE solution carrying the
species traces plus, where applicable, the variable-condition traces
(``ODESolutionVC``) and the precomputed discrete rate table
(``build_discrete_rate_solution``). Data is plain numpy on the host after
the device solve; calling the object interpolates linearly in time like the
reference's ``sol(t)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.interpolation import TimeSeries

RETCODE_SUCCESS = "Success"
RETCODE_MAXITERS = "MaxIters"
RETCODE_DTLESSTHANMIN = "DtLessThanMin"
RETCODE_FAILURE = "Failure"

_STATUS_TO_RETCODE = {1: RETCODE_SUCCESS, -1: RETCODE_MAXITERS, -2: RETCODE_DTLESSTHANMIN}


def retcode_from_status(status: int) -> str:
    return _STATUS_TO_RETCODE.get(int(status), RETCODE_FAILURE)


@dataclass
class ODESolution:
    """(t, u) solution with optional condition traces and rate table.

    * ``t`` — (nt,) times; ``u`` — (nt, ns) concentrations.
    * ``vcs`` — dict sym -> (nt,) variable-condition trace (ODESolutionVC
      capability, solutions.jl:1-30).
    * ``k`` — TimeSeries of the precomputed discrete rate vectors, when the
      solve used discrete updates (solutions.jl:120-160).
    * ``stats`` — integrator statistics (steps/fev/jev/lu and retry count).
    """
    t: np.ndarray
    u: np.ndarray
    retcode: str = RETCODE_SUCCESS
    vcs: dict = field(default_factory=dict)
    k: TimeSeries | None = None
    stats: dict = field(default_factory=dict)

    def __post_init__(self):
        self.t = np.asarray(self.t, dtype=np.float64)
        self.u = np.asarray(self.u)
        self._interp = TimeSeries(self.t, self.u)

    def __call__(self, tq):
        """Linear interpolation of species traces at ``tq``."""
        return self._interp(tq)

    @property
    def success(self) -> bool:
        return self.retcode == RETCODE_SUCCESS

    def __len__(self):
        return len(self.t)

    def __repr__(self):
        return (f"ODESolution(nt={len(self.t)}, ns={self.u.shape[1]}, "
                f"retcode={self.retcode}, vcs={list(self.vcs)})")


@dataclass
class EnsembleSolution:
    """Batched solution from a vmapped/sharded solve: u has shape (B, nt, ns).

    No reference equivalent — the reference explicitly leaves ensemble
    calculations to the user (docs/src/tutorials/ode-solution.md:190); here
    batching is a first-class TPU capability.
    """
    t: np.ndarray
    u: np.ndarray                       # (B, nt, ns)
    retcodes: list = field(default_factory=list)
    vcs: dict = field(default_factory=dict)   # sym -> (B, nt)
    stats: dict = field(default_factory=dict)

    @property
    def n_batch(self) -> int:
        return self.u.shape[0]

    @property
    def success(self) -> bool:
        return all(rc == RETCODE_SUCCESS for rc in self.retcodes)

    def __getitem__(self, i: int) -> ODESolution:
        return ODESolution(
            t=self.t, u=self.u[i], retcode=self.retcodes[i],
            vcs={s: v[i] for s, v in self.vcs.items()}, stats={})
