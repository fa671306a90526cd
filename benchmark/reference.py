"""The plain reference: a SciPy BDF solve of one temperature ramp.

Written after ``kinetica_tpu_torch/testing/cpu_reference.py`` (its
mass-action right-hand side and Jacobian, ``arrhenius_k_of_t`` and
``scipy_bdf_trajectory``) at commit
55f0abe3ef2893a2eb2dbb1a91147263e5f51748, and rewritten: sparse operators
in place of its dense per-slot loop, and nothing imported from the program.
It computes everything itself from the network's arrays (``network.py``):

    dT/dt = rate until the ramp ends, then T holds;
    k_j(t) = 1 / (1 / k_max + 1 / (A_j exp(-Ea_j / R T(t)) N_A));
    du/dt = N^T r,   r_j = k_j prod_{s in reactants of j} u_s.

The solve restarts at every save time, as the program's chunked solve
restarts at every chunk, and returns the state at each of them. It runs on
the host CPU in float64 (NumPy and SciPy only; no torch, no program).
With ``state_dtype=np.float32`` the state is rounded to float32 wherever
it is handed on (the start and each save, from which the next chunk
restarts): the control of ``control.py``.
"""
from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.integrate import solve_ivp

from .network import N_A, R, Network


class MassAction:
    """The right-hand side and Jacobian of one network, built once."""

    def __init__(self, net: Network):
        self.ns, self.nr = net.ns, net.nr
        slots = net.slots()
        self.s0 = slots[:, 0]
        self.bi = np.flatnonzero(slots[:, 1] >= 0)
        self.s1 = slots[self.bi, 1]
        self.NT = sparse.csr_matrix(net.stoichiometry().T)
        # dr/du: one entry (j, s0_j) for every reaction, one (j, s1_j) for
        # every bimolecular one
        self._rows = np.concatenate([np.arange(self.nr), self.bi])
        self._cols = np.concatenate([self.s0, self.s1])

    def rates(self, k: np.ndarray, u: np.ndarray) -> np.ndarray:
        r = k * u[self.s0]
        r[self.bi] *= u[self.s1]
        return r

    def rhs(self, k: np.ndarray, u: np.ndarray) -> np.ndarray:
        return self.NT @ self.rates(k, u)

    def jac(self, k: np.ndarray, u: np.ndarray) -> np.ndarray:
        d0 = k.copy()
        d0[self.bi] *= u[self.s1]
        d1 = k[self.bi] * u[self.s0[self.bi]]
        D = sparse.csr_matrix((np.concatenate([d0, d1]),
                               (self._rows, self._cols)),
                              shape=(self.nr, self.ns))
        return (self.NT @ D).toarray()


def ramp_k(net: Network, k_max: float, T0: float, rate: float,
           t_end: float):
    """k(t) of a linear ramp from ``T0`` at ``rate`` K/s that holds from
    ``t_end`` on."""
    Ea, A = net.Ea, net.A

    def k_of_t(t: float) -> np.ndarray:
        T = T0 + rate * t if t <= t_end else T0 + rate * t_end
        k = A * np.exp(-Ea / (R * T)) * N_A
        return 1.0 / (1.0 / k_max + 1.0 / k)

    return k_of_t


def solve_ramp(net: Network, u0: np.ndarray, rate: float, T0: float,
               t_end: float, save_times: np.ndarray, k_max: float,
               rtol: float, atol: float, ma: MassAction | None = None,
               state_dtype=np.float64) -> np.ndarray:
    """The states at ``save_times`` (the first is the start, where the
    state is ``u0``): a (len(save_times), ns) float64 array, each state
    held in ``state_dtype``. Raises if SciPy's solve fails."""
    ma = ma or MassAction(net)
    k_of_t = ramp_k(net, k_max, T0, rate, t_end)

    def held(y):
        return np.asarray(y).astype(state_dtype).astype(np.float64)

    out = [held(u0)]
    for a, b in zip(save_times[:-1], save_times[1:]):
        sol = solve_ivp(lambda t, y: ma.rhs(k_of_t(t), y), (a, b), out[-1],
                        method="BDF", jac=lambda t, y: ma.jac(k_of_t(t), y),
                        rtol=rtol, atol=atol)
        if not sol.success:
            raise RuntimeError(f"reference solve failed on [{a}, {b}]: "
                               f"{sol.message}")
        out.append(held(sol.y[:, -1]))
    return np.stack(out)
