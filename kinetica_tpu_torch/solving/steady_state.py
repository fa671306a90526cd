"""Steady-state finder via pseudo-transient continuation, in PyTorch.

Counterpart of ``kinetica_tpu/solving/steady_state.py``. A steady state u*
(du/dt = 0 under STATIC conditions) is found by driving the BDF
integrator over geometrically growing horizons until the state stops
moving; each epoch integrates in local time [0, T]. The ensemble form
runs every member's lane in one call of the batched
:func:`~kinetica_tpu_torch.ops.bdf.bdf_solve` per epoch, with a (B, nr)
static k payload, where the reference vmaps one solve.
:func:`steady_state_sensitivities` solves the implicit-function system
on the host in f64, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..ops import bdf
from ..utils.logging import logger


@dataclass
class SteadyStateResult:
    u: np.ndarray              # (ns,) steady state (best iterate)
    residual: float            # weighted RMS of du/dt at u (1/s units)
    t_total: float             # pseudo-time integrated to reach it
    converged: bool
    epochs: int

    @property
    def success(self) -> bool:
        return self.converged


def _wrms(x: torch.Tensor, u_ref: torch.Tensor, rtol: float,
          atol: float) -> torch.Tensor:
    """Tolerance-weighted RMS of ``x`` over the last axis."""
    w = 1.0 / (atol + rtol * u_ref.abs())
    return torch.sqrt(torch.mean((x * w) ** 2, dim=-1))


def _residual(integ, u: torch.Tensor, k_payload) -> torch.Tensor:
    """du/dt of the (B, ns) states ``u`` under the static rates."""
    t = torch.zeros(u.shape[0], dtype=torch.float64, device=u.device)
    args = (0.0, k_payload)
    pre = integ.prepare(t, t, args) if integ.prepare is not None else args
    return integ.rhs(t, u, pre)


def find_steady_state(method, sd, rd, t_first: float = 1.0,
                      growth: float = 10.0, max_epochs: int = 14,
                      move_tol: float = 0.05, copy_network: bool = True,
                      device=DEFAULT_DEVICE) -> SteadyStateResult:
    """Pseudo-transient continuation to steady state on ``device``.

    ``method`` is a :class:`~kinetica_tpu_torch.solving.methods
    .StaticODESolve`. Epoch e integrates a horizon ``t_first *
    growth**e``; convergence is declared when one full epoch moves the
    state by less than ``move_tol`` in tolerance-weighted RMS (from the
    second epoch on). The result also reports the weighted RMS of du/dt.
    Oscillatory or drifting systems exhaust ``max_epochs`` and return
    ``converged=False`` with the last iterate.
    """
    from .methods import StaticODESolve, solve_network

    if not isinstance(method, StaticODESolve):
        raise TypeError(
            "find_steady_state requires a StaticODESolve (steady states "
            "are defined under time-invariant conditions)")

    integ = solve_network(method, sd, rd, copy_network=copy_network,
                          return_integrator=True, device=device)
    pars = method.pars
    rtol, atol = float(pars.reltol), float(pars.abstol)

    u = integ.u0
    t_total = 0.0
    T = float(t_first)
    converged = False
    epoch = 0
    for epoch in range(1, max_epochs + 1):
        integ.u0 = u
        res = integ.solve_segment(0.0, T, saveat=[T])
        status = int(res.status[0])
        if status != bdf.DONE:
            logger.info(" - steady-state epoch %d failed (status %d) at "
                        "T=%.3g; stopping", epoch, status, T)
            break
        u_new = res.y_final[0]
        t_total += T
        move = float(_wrms(u_new - u, u_new, rtol, atol))
        u = u_new
        logger.info(" - steady-state epoch %d: T=%.3g move=%.3e", epoch, T,
                    move)
        if move < move_tol and epoch > 1:
            converged = True
            break
        T *= growth

    f = _residual(integ, u[None], integ.args[1])[0]
    return SteadyStateResult(u=u.cpu().numpy(),
                             residual=float(_wrms(f, u, rtol, atol)),
                             t_total=t_total, converged=converged,
                             epochs=epoch)


@dataclass
class SteadyStateEnsemble:
    u: np.ndarray              # (B, ns) per-member steady states
    residual: np.ndarray       # (B,) weighted RMS of du/dt
    t_total: float
    converged: np.ndarray      # (B,) bool
    epochs: int
    n_steps: np.ndarray        # (epochs, B) BDF steps of every epoch

    @property
    def success(self) -> bool:
        return bool(np.all(self.converged))


def find_steady_state_ensemble(method, sd, rd, conditions_list,
                               t_first: float = 1.0, growth: float = 10.0,
                               max_epochs: int = 14, move_tol: float = 0.05,
                               copy_network: bool = True,
                               device=DEFAULT_DEVICE) -> SteadyStateEnsemble:
    """Batched steady states over a sweep of static conditions.

    One batched BDF call per epoch computes the fixed points of the SAME
    CRN under every member's (static) conditions. Epochs are batch-
    synchronous: all lanes integrate every horizon, and the loop stops
    when every lane's last epoch moved less than ``move_tol`` weighted
    RMS. A lane's ``converged`` is that of the last epoch, so it can be
    lost again. Per-lane convergence, residual and step counts are
    reported.
    """
    from .methods import StaticODESolve, solve_network
    from .solve_utils import get_initial_rates

    if not isinstance(method, StaticODESolve):
        raise TypeError(
            "find_steady_state_ensemble requires a StaticODESolve")
    for cs in conditions_list:
        if any(not cs.get_profile(s).is_static for s in cs.symbols):
            raise TypeError("all ensemble members must have static "
                            "conditions (steady states are defined under "
                            "time-invariant conditions)")

    integ = solve_network(method, sd, rd, copy_network=copy_network,
                          return_integrator=True, device=device)
    pars = method.pars
    u0 = integ.u0
    # the calculator was set up on the (possibly spliced) active network
    # inside solve_network, so its k vectors align with integ.net
    k_b = torch.as_tensor(np.stack([
        get_initial_rates(cs, method.calculator)
        for cs in conditions_list]), dtype=u0.dtype, device=u0.device)
    if k_b.shape[1] != integ.net.nr:
        raise RuntimeError("calculator rate-vector length does not match "
                           "the active network")
    B = k_b.shape[0]
    rtol, atol = float(pars.reltol), float(pars.abstol)

    u = u0.expand(B, -1).contiguous()
    t_total = 0.0
    T = float(t_first)
    conv = np.zeros(B, dtype=bool)
    steps = []
    epoch = 0
    for epoch in range(1, max_epochs + 1):
        res = bdf.bdf_solve(
            integ.rhs, integ.jac, u, 0.0, T, [T], rtol=rtol, atol=atol,
            max_steps=int(pars.maxiters), nonnegative=pars.ban_negatives,
            nonnegative_project=pars.project_negatives,
            linsolve=pars.linsolve, lu_drift_tol=pars.lu_drift_tol,
            jac_policy=pars.jac_policy, prepare=integ.prepare,
            args=(0.0, k_b))
        status = res.status.cpu().numpy()
        steps.append(res.n_steps.cpu().numpy())
        if (status != bdf.DONE).any():
            logger.info(" - steady-state ensemble epoch %d: %d lanes "
                        "failed (status min %d); stopping", epoch,
                        int((status != bdf.DONE).sum()), int(status.min()))
            break
        u_new = res.y_final
        t_total += T
        move = _wrms(u_new - u, u_new, rtol, atol).cpu().numpy()
        u = u_new
        conv = (move < move_tol) & (epoch > 1)
        logger.info(" - steady-state ensemble epoch %d: T=%.3g "
                    "max move=%.3e (%d/%d lanes converged)", epoch, T,
                    float(move.max()), int(conv.sum()), B)
        if conv.all():
            break
        T *= growth

    f = _residual(integ, u, k_b)
    return SteadyStateEnsemble(
        u=u.cpu().numpy(), residual=_wrms(f, u, rtol, atol).cpu().numpy(),
        t_total=t_total, converged=conv, epochs=epoch,
        n_steps=np.stack(steps))


def steady_state_sensitivities(method, sd, rd, result=None,
                               copy_network: bool = True,
                               device=DEFAULT_DEVICE) -> np.ndarray:
    """Exact parameter sensitivities of a steady state: S = du*/d ln k.

    At a fixed point f(u*, k) = 0 the implicit function theorem gives

        J du*_j = -df/d(ln k_j) = -(N_j^T r_j),   with L du* = 0,

    where L spans the linear invariants (null(N)). The constrained system
    is solved in f64 on the host by least squares over the stacked
    [J; alpha L] operator, J the f64 analytic Jacobian at u* (not the f32
    Newton preconditioner). ``result`` is a converged
    :class:`SteadyStateResult` (found on ``device`` when not given).
    Returns ``S`` of shape (ns, nr).
    """
    from .methods import StaticODESolve, solve_network
    from .solve_utils import get_initial_rates

    if not isinstance(method, StaticODESolve):
        raise TypeError("steady_state_sensitivities requires a "
                        "StaticODESolve")
    if result is None:
        result = find_steady_state(method, sd, rd, copy_network=copy_network,
                                   device=device)
    if not result.converged:
        raise RuntimeError("steady state did not converge; sensitivities "
                           "at a moving state are not defined")

    integ = solve_network(method, sd, rd, copy_network=copy_network,
                          return_integrator=True, device=device)
    net = integ.net.to_dtype(torch.float64)
    k = torch.as_tensor(get_initial_rates(method.conditions,
                                          method.calculator),
                        dtype=torch.float64, device=net.N.device)
    if k.shape[0] != net.nr:
        raise RuntimeError("calculator rate-vector length does not match "
                           "the active network")
    u = torch.as_tensor(result.u, dtype=torch.float64, device=net.N.device)

    # f64 Jacobian and rates straight from the network model
    J = net.jac(u, k).cpu().numpy()                           # (ns, ns)
    r = net.rates(u, k).cpu().numpy()                         # (nr,)
    Nmat = net.N.cpu().numpy()                                # (nr, ns)
    Bm = (Nmat * r[:, None]).T                                # (ns, nr)

    # linear invariants: c with N c = 0 (=> c . f == 0 for every rate)
    _, s, vt = np.linalg.svd(Nmat, full_matrices=True)
    rank = int((s > s.max() * max(Nmat.shape) * np.finfo(float).eps).sum()) \
        if s.size else 0
    L = vt[rank:]                                             # (n_inv, ns)

    alpha = max(1.0, float(np.linalg.norm(J)))
    A = np.vstack([J, alpha * L])
    rhs = np.vstack([-Bm, np.zeros((L.shape[0], Bm.shape[1]))])
    S, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    return S
