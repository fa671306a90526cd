"""Solve-method containers and the RHS/Jacobian builder of the port.

Counterpart of ``kinetica_tpu/solving/methods.py``. Ported for the batched
continuous sweep: the :class:`StaticODESolve` / :class:`VariableODESolve`
containers, :func:`_make_rhs_jac` for mode ``"continuous_theta"``, and the
chunk grids :func:`_chunk_save_grid` / :func:`_chunk_local_stops`.
``solve_network`` (single solves, six variants) is not ported yet.

The port resolves the reference's "auto" choices to its accelerator
algorithm on every device: the RHS goes through the fused kernel
(:mod:`kinetica_tpu_torch.ops.fused_rhs`, its plain version on CPU) and
the Newton Jacobian is f32 in one-hot matmul form.
"""
from __future__ import annotations

import numpy as np
import torch

from ..calculators.base import KineticCalculator
from ..conditions.condition_set import ConditionSet
from ..models.mass_action import MassActionNetwork, augment
from ..ops.fused_rhs import FusedMassActionRHS
from .filters import RxFilter
from .params import ODESimulationParams


class AbstractODESolveMethod:
    pass


class StaticODESolve(AbstractODESolveMethod):
    """Static-conditions kinetic CRN solve (methods.jl:7-41)."""

    def __init__(self, pars: ODESimulationParams, conditions: ConditionSet,
                 calculator: KineticCalculator, filter: RxFilter | None = None):
        if not conditions.isstatic():
            raise ValueError("All conditions must be static to run a StaticODESolve.")
        if not calculator.has_conditions(conditions.symbols):
            raise ValueError("Calculator does not support all of the provided conditions.")
        self.pars = pars
        self.conditions = conditions
        self.calculator = calculator
        self.filter = filter if filter is not None else RxFilter()


class VariableODESolve(AbstractODESolveMethod):
    """Variable-conditions kinetic CRN solve (methods.jl:44-79)."""

    def __init__(self, pars: ODESimulationParams, conditions: ConditionSet,
                 calculator: KineticCalculator, filter: RxFilter | None = None):
        if not calculator.has_conditions(conditions.symbols):
            raise ValueError("Calculator does not support all of the provided conditions.")
        if not conditions.discrete_updates and not calculator.allows_continuous:
            raise ValueError("Calculator does not support continuous rate updates "
                             "in simulations.")
        self.pars = pars
        self.conditions = conditions
        self.calculator = calculator
        self.filter = filter if filter is not None else RxFilter()


def _make_rhs_jac(net: MassActionNetwork, mode: str, k_fn, jac_net=None):
    """Build ``(rhs, jac, prepare)`` for :func:`bdf.bdf_solve`.

    ``prepare(t_stage, t_start, (offset, payload))`` evaluates the (B, nr)
    rate constants once per step attempt at the stage time; ``rhs`` builds
    ``u_aug = [clip(u), 1]`` and calls the fused RHS kernel; ``jac`` is the
    analytic Jacobian on ``jac_net`` (f32 on the main path).
    """
    if mode != "continuous_theta":
        raise ValueError(f"rate mode {mode!r} is not ported yet "
                         "(only 'continuous_theta')")
    jnet = jac_net if jac_net is not None else net
    jdt = jnet.N.dtype
    fused = FusedMassActionRHS(net.N, net.reac_slots, net.N.device)
    delta = net.delta

    def prepare(t_stage, t_start, a):
        return k_fn(t_stage + a[0], a[1])

    def rhs(t, u, k):
        return fused(augment(u, delta), k)

    def jac(t, u, k):
        return jnet.jac_matmul(u.to(jdt), k.to(jdt))

    return rhs, jac, prepare


def _chunk_save_grid(pars: ODESimulationParams):
    """Local saveat grid (si, 2si, ..., chunkstep) and chunk count."""
    chunkstep = pars.solve_chunkstep
    si = pars.save_interval if pars.save_interval is not None else chunkstep
    m = int(round(chunkstep / si))
    if abs(m * si - chunkstep) > 1e-9 * chunkstep:
        # non-divisible save interval: fall back to one save per chunk
        m, si = 1, chunkstep
    saveat_local = (np.arange(1, m + 1) * si).astype(np.float64)
    saveat_local[-1] = chunkstep
    n_chunks = int(round(pars.tspan[1] / chunkstep))
    return saveat_local, n_chunks


def _chunk_local_stops(global_stops: np.ndarray, n_chunks: int,
                       chunkstep: float) -> np.ndarray:
    """Per-chunk stop times in local coordinates, padded with +inf.

    Only stops strictly inside (0, chunkstep) matter: chunk boundaries are
    integration endpoints already."""
    rows = []
    max_len = 1
    eps = 1e-12 * max(chunkstep * n_chunks, 1.0)
    for nc in range(n_chunks):
        lo, hi = nc * chunkstep, (nc + 1) * chunkstep
        local = [g - lo for g in global_stops if lo + eps < g < hi - eps]
        rows.append(local)
        max_len = max(max_len, len(local))
    out = np.full((n_chunks, max_len), np.inf)
    for i, row in enumerate(rows):
        out[i, : len(row)] = row
    return out


def resolve_device(device) -> torch.device:
    """An explicit device; a CUDA device without a card is an error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but none is available")
    return device
