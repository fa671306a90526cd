"""Solve methods: the static/variable x complete/chunkwise x
continuous/discrete matrix, in PyTorch.

Counterpart of ``kinetica_tpu/solving/methods.py``. :func:`solve_network`
is the library's single-solve entry point with the reference's six
variants; the ensemble (:mod:`kinetica_tpu_torch.parallel.batching`)
shares its RHS/Jacobian builder and chunk grids. A single solve is a
batch of one lane of the batched BDF (:mod:`kinetica_tpu_torch.ops.bdf`).

* Chunkwise solves integrate each chunk in local time. The reference's
  ``lax.scan`` over chunks is a host loop here that carries the final
  step size and, with ``chunk_warm_start``, the BDF method state into the
  next chunk; the chunk offset rides the rate lookup's arguments.
* Discrete rate updates are a precomputed (tstops, k_table) pair read
  with a left-constant lookup at each step's start, with steps clamped
  at the stops.
* Continuous mode evaluates k(T(t), ...) at the step's stage time.
* ``pars.solver="rk45"`` integrates with the explicit Dormand-Prince
  solver (:mod:`kinetica_tpu_torch.ops.rk45`), the rate lookup folded
  into every stage.
* The entry's phases are spans of
  :mod:`~kinetica_tpu_torch.utils.profiling`: ``solve.network`` (the
  call), ``solve.setup`` (up to the solve), ``solve.chunk`` (one chunk's
  integration) and the reference's host sections
  ``solve.calculator_setup``, ``solve.rate_precalc`` (discrete rates) and
  ``solve.chunk_dispatch`` (each group of ``chunks_per_dispatch``
  chunks), timed with :class:`~kinetica_tpu_torch.utils.profiling.Timings`
  enabled.

The port resolves the reference's "auto" choices to its accelerator
algorithm on every device: the RHS of an f64 network goes through the
fused kernel (:mod:`kinetica_tpu_torch.ops.fused_rhs`, its plain version
on CPU), the Newton Jacobian is f32 in the one-hot matmul form, and the
Newton factor "inv_gated" up to 512 species ("lu" above, as the
reference). A ``dtype="float32"`` solve keeps its state, RHS and rates
in f32 (the plain f32 dot, as the reference's f32 networks) and its time
and step size in f64.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..calculators.base import KineticCalculator
from ..conditions.condition_set import ConditionSet
from ..core.network import RxData, SpeciesData
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.mass_action import (MassActionNetwork, augment,
                                  build_mass_action, resolve_clip_delta)
from ..ops import bdf, rk45
from ..ops.dd_contract import DDContraction
from ..ops.fused_rhs import FusedMassActionRHS
from ..ops.interp import left_constant_lookup
from ..ops.linalg import lu_precision_dtype, resolve_linsolve
from ..utils.interpolation import TimeSeries
from ..utils.logging import logger
from ..utils.profiling import span, spanned, timed
from ..utils.time_units import create_savepoints
from .filters import RxFilter
from .params import ODESimulationParams
from .solutions import ODESolution, retcode_from_status
from .solve_utils import (apply_low_k_cutoff, calculate_discrete_rates,
                          get_initial_rates, make_u0,
                          resolve_chunks_per_dispatch)

DEFAULT_COMPLETE_SAVEPOINTS = 1000
STAT_KEYS = ("n_steps", "n_accepted", "n_rejected", "n_fev", "n_jev", "n_lu")


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


@dataclass
class KineticIntegrator:
    """The problem handle returned by ``return_integrator=True``.

    Bundles the RHS/Jacobian, network, initial state and solve
    configuration so callers can integrate segments by hand (the
    reference returns the DiffEq integrator for the same purpose,
    methods.jl:96-105). ``u0`` is (ns,); a segment is a batch of one lane.
    """
    rhs: object
    jac: object
    net: MassActionNetwork
    u0: torch.Tensor
    args: object
    pars: ODESimulationParams
    stops: np.ndarray | None
    prepare: object = None

    def solve_segment(self, t0, tf, saveat, rtol=None, atol=None):
        return bdf.bdf_solve(
            self.rhs, self.jac, self.u0[None], t0, tf, saveat,
            rtol=self.pars.reltol if rtol is None else rtol,
            atol=self.pars.abstol if atol is None else atol,
            stops=self.stops,
            max_steps=int(self.pars.maxiters),
            nonnegative=self.pars.ban_negatives,
            nonnegative_project=self.pars.project_negatives,
            linsolve=self.pars.linsolve, lu_drift_tol=self.pars.lu_drift_tol,
            jac_policy=self.pars.jac_policy, prepare=self.prepare,
            args=self.args)


# ---------------------------------------------------------------------------
# RHS/Jacobian builders.  args convention: (t_shift, payload)
#   static k         : payload = (1, nr) k tensor
#   discrete k       : payload = (tstops (n,), k_table (n, nr) or (B, n, nr))
#   continuous k     : payload unused (k_fn closes over the profiles)
#   continuous_theta : payload = per-member profile theta dict
# ---------------------------------------------------------------------------

def _resolve_contraction(net: MassActionNetwork, pars=None):
    """The RHS contraction of ``pars.rhs_contraction``.

    "auto" and "fused": the fused RHS kernel
    (:class:`~kinetica_tpu_torch.ops.fused_rhs.FusedMassActionRHS`);
    "dd": the contraction kernel
    (:class:`~kinetica_tpu_torch.ops.dd_contract.DDContraction`) over
    rates computed in PyTorch; "float64": None, the plain ``net.rhs``
    (rates and a dense ``r @ N``). Both kernels take any real N, so
    nothing falls back. An f32 network takes the plain f32 dot under
    "auto", as the reference's; the kernels are f64, so "fused" and "dd"
    raise there.
    """
    choice = getattr(pars, "rhs_contraction", "auto") if pars else "auto"
    if choice == "float64":
        return None
    if net.N.dtype != torch.float64:
        if choice == "auto":
            return None
        raise ValueError(f"rhs_contraction={choice!r} runs an f64 kernel; a "
                         f"{net.N.dtype} state takes 'auto' or 'float64'")
    if choice in ("auto", "fused"):
        return FusedMassActionRHS(net.N, net.reac_slots, net.N.device)
    if choice == "dd":
        return DDContraction(net.N, net.N.device)
    raise ValueError(f"unknown rhs_contraction {choice!r}")


def _jac_dtype(pars) -> torch.dtype:
    """f64 for ``jac_dtype="float64"``, else f32 (the preconditioner J)."""
    return torch.float64 if pars.jac_dtype == "float64" else torch.float32


def _state_dtype(pars) -> torch.dtype:
    """The dtype of the state, RHS and rates: ``pars.dtype``."""
    if pars.dtype not in ("float64", "float32"):
        raise ValueError(f"dtype must be 'float64' or 'float32', got "
                         f"{pars.dtype!r}")
    return torch.float64 if pars.dtype == "float64" else torch.float32


def _resolve_jac_form(pars) -> str:
    """``pars.jac_form``: "auto" is "matmul" (the one-hot matmul form, the
    reference's accelerator choice, on every device); "segsum" the
    segment sum of the reference's ``jac``."""
    return "matmul" if pars.jac_form == "auto" else pars.jac_form


def _check_lu_precision(pars, ns: int) -> None:
    """``pars.lu_precision``: "mixed" (the default) is what every port
    factor does, the f32 inverse for the inverse methods and the f64 LU
    for "lu" (the reference's CPU promotes "mixed" to that); "full" asks
    for a factor in the state dtype, which only "lu" gives."""
    lu_precision_dtype(pars.lu_precision, resolve_linsolve(pars.linsolve, ns),
                       torch.float64)


def _make_rhs_jac(net: MassActionNetwork, mode: str, k_fn=None, jac_net=None,
                  contraction=None, analytic_jac: bool = True,
                  jac_form: str = "matmul"):
    """Build ``(rhs, jac, prepare)`` for :func:`bdf.bdf_solve`.

    ``prepare(t_stage, t_start, a)`` evaluates the (B, nr) rate constants
    once per step attempt: static k is the payload; discrete k is looked
    up at the step START (the reference's update callbacks fire at a
    tstop and affect subsequent steps only, solve_utils.jl:488-509);
    continuous k sees the implicit stage time. ``a[0]`` is the chunk
    offset of chunk-local time.

    ``rhs`` runs ``contraction``: the fused kernel on ``u_aug = [clip(u),
    1]``, the contraction kernel on ``net.rates(u, k)``, or ``net.rhs``
    when it is None. ``jac`` is the analytic Jacobian on ``jac_net`` (f32
    on the main path) in ``jac_form`` ("matmul" or "segsum"), or with
    ``analytic_jac=False`` the forward-mode autodiff Jacobian of the same
    mass-action RHS. On a network that is not f64 the rate constants are
    cast to its dtype.
    """
    jnet = jac_net if jac_net is not None else net
    jdt = jnet.N.dtype

    if mode == "static":
        def prepare(t_stage, t_start, a):
            return a[1].expand(t_start.shape[0], -1)
    elif mode == "discrete":
        def prepare(t_stage, t_start, a):
            tstops, ktab = a[1]
            return left_constant_lookup(t_start + a[0], tstops, ktab)
    elif mode == "continuous":
        def prepare(t_stage, t_start, a):
            return k_fn(t_stage + a[0])
    elif mode == "continuous_theta":
        def prepare(t_stage, t_start, a):
            return k_fn(t_stage + a[0], a[1])
    else:
        raise ValueError(f"unknown rate mode {mode!r}")
    if net.N.dtype != torch.float64:
        prepare_k = prepare
        sdt = net.N.dtype

        def prepare(t_stage, t_start, a):
            return prepare_k(t_stage, t_start, a).to(sdt)

    if isinstance(contraction, FusedMassActionRHS):
        delta = net.delta

        def rhs(t, u, k):
            return contraction(augment(u, delta), k.contiguous())
    elif isinstance(contraction, DDContraction):
        def rhs(t, u, k):
            return contraction(net.rates(u, k))
    else:
        def rhs(t, u, k):
            return net.rhs(u, k)

    if analytic_jac:
        jac_impl = jnet.jac_segsum if jac_form == "segsum" else jnet.jac_matmul

        def jac(t, u, k):
            return jac_impl(u.to(jdt), k.to(jdt))
    else:
        def jac(t, u, k):
            return torch.func.vmap(torch.func.jacfwd(jnet.rhs))(
                u.to(jdt), k.to(jdt))

    return rhs, jac, prepare


def _integrate(pars: ODESimulationParams, rhs, jac, u0, t0, tf, saveat,
               rtol, atol, stops, args, first_step=None, prepare=None,
               warm_start=None):
    """One segment of a (1, ns) state with ``pars.solver``; returns
    (status, ys, y_final, stats), with ``h`` (and for BDF ``warm``) in
    stats for the chunk carry.

    rk45 folds ``prepare`` into the RHS, as its stages run at distinct
    times, and starts from its automatic initial step: the reference
    passes it no ``first_step`` either, so the carried h is not used.
    """
    if pars.solver == "rk45":
        def rhs_rk(t, y, a, t_start):
            return rhs(t, y, prepare(t, t_start, a))
        res = rk45.rk45_solve(
            rhs if prepare is None else rhs_rk, u0, t0, tf, saveat,
            rtol=rtol, atol=atol, stops=stops, max_steps=int(pars.maxiters),
            nonnegative=pars.ban_negatives, args=args)
        stats = {k: int(getattr(res, k)[0])
                 for k in ("n_steps", "n_accepted", "n_rejected", "n_fev")}
        stats.update(n_jev=0, n_lu=0, h=res.h)
        return int(res.status[0]), res.ys[0], res.y_final, stats
    res = bdf.bdf_solve(
        rhs, jac, u0, t0, tf, saveat, rtol=rtol, atol=atol, stops=stops,
        max_steps=int(pars.maxiters), nonnegative=pars.ban_negatives,
        nonnegative_project=pars.project_negatives, first_step=first_step,
        linsolve=pars.linsolve, lu_drift_tol=pars.lu_drift_tol,
        jac_policy=pars.jac_policy, prepare=prepare, warm_start=warm_start,
        args=args)
    stats = {k: int(getattr(res, k)[0]) for k in STAT_KEYS}
    stats["h"] = res.h
    stats["warm"] = (res.D, res.order, res.n_equal_steps)
    return int(res.status[0]), res.ys[0], res.y_final, stats


def _make_continuous_k_fn(conditions: ConditionSet,
                          calculator: KineticCalculator):
    """t (B,) -> (B, nr) rate constants from the profiles' closed forms."""
    def k_fn(t):
        k = calculator(**conditions.conditions_at(t))
        return k.expand(t.shape[0], -1).contiguous()
    return k_fn


def _adaptive_device_solve(solve_fn, pars: ODESimulationParams):
    """Host retry loop mirroring adaptive_solve! (solve_utils.jl:376-424).

    ``solve_fn(abstol, reltol) -> (status, payload)``; tolerances tighten
    x10 per retry, at most 5 attempts, floored at machine eps.
    """
    abstol, reltol = pars.abstol, pars.reltol
    mintol = np.finfo(np.float64).eps
    attempts = 0
    while True:
        attempts += 1
        status, payload = solve_fn(abstol, reltol)
        if status == bdf.DONE:
            if pars.update_tols and (abstol != pars.abstol
                                     or reltol != pars.reltol):
                logger.info("   - Writing new tolerances back to ODEParams.")
                pars.abstol, pars.reltol = abstol, reltol
            return status, payload, attempts
        if not pars.adaptive_tols:
            logger.error(" - Solve failed, not retrying as adaptive tolerance "
                         "is not enabled.")
            raise RuntimeError("ODE solution failed.")
        if attempts >= 5:
            logger.error(" - Too many attempts have been made to reduce solver "
                         "tolerance, exiting.")
            raise RuntimeError("ODE solution failed.")
        if abstol / 10 <= mintol or reltol / 10 <= mintol:
            logger.error(" - Solution cannot be converged by reducing solver "
                         "tolerance any further, exiting.")
            raise RuntimeError("ODE solution failed.")
        abstol /= 10
        reltol /= 10
        logger.warning("   - ODE solution failed at current solver tolerances.")
        logger.warning("   - Reducing tolerances to abstol = %g reltol = %g",
                       abstol, reltol)


def _complete_saveat(pars: ODESimulationParams) -> np.ndarray:
    t0, tf = pars.tspan
    if pars.save_interval is not None:
        return create_savepoints(t0, tf, pars.save_interval)
    return np.linspace(t0, tf, DEFAULT_COMPLETE_SAVEPOINTS + 1)


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


def _run_complete(rhs, jac, u0, pars: ODESimulationParams, saveat: np.ndarray,
                  stops: np.ndarray | None, args_payload, prepare=None):
    """Single whole-tspan solve with adaptive-tolerance retries."""
    t0, tf = pars.tspan
    saveat_inner = saveat[saveat > t0 + 0.0]
    stops_t = None if stops is None or len(stops) == 0 else stops

    def solve_fn(abstol, reltol):
        status, ys, _, st = _integrate(
            pars, rhs, jac, u0, t0, tf, saveat_inner, reltol, abstol,
            stops_t, (0.0, args_payload), prepare=prepare)
        return status, (ys, st)

    status, (ys_dev, st), attempts = _adaptive_device_solve(solve_fn, pars)
    ys = np.concatenate([u0.cpu().numpy(), ys_dev.cpu().numpy()])
    ts = np.concatenate([[t0], saveat_inner])
    stats = {k: st[k] for k in STAT_KEYS}
    stats["attempts"] = attempts
    return ts, ys, status, stats


def _run_chunkwise(rhs, jac, u0, pars: ODESimulationParams,
                   global_stops: np.ndarray | None, args_payload,
                   prepare=None):
    """The chunk loop in local time (the reference's lax.scan over chunks,
    methods.jl:796-847), carrying h and, with ``chunk_warm_start``, the
    BDF method state from chunk to chunk (rk45 has no method state).
    With ``pars.progress`` a line is logged after every group of
    ``chunks_per_dispatch`` chunks."""
    chunkstep = pars.solve_chunkstep
    saveat_local, n_chunks = _chunk_save_grid(pars)
    if global_stops is not None and len(global_stops) > 0:
        stops_rows = _chunk_local_stops(global_stops, n_chunks, chunkstep)
    else:
        stops_rows = np.full((n_chunks, 1), np.inf)
    use_warm = pars.chunk_warm_start and pars.solver == "bdf"
    group = resolve_chunks_per_dispatch(pars.chunks_per_dispatch, n_chunks)

    def solve_fn(abstol, reltol):
        u = u0
        worst = bdf.DONE
        h = torch.full((1,), float("nan"), dtype=bdf.time_dtype(u0.dtype),
                       device=u0.device)
        warm = None
        acc = dict.fromkeys(STAT_KEYS, 0)
        ys_parts = []
        for lo in range(0, n_chunks, group):
            hi = min(lo + group, n_chunks)
            with timed("solve.chunk_dispatch"):
                for nc in range(lo, hi):
                    with span("solve.chunk"):
                        status, ys, u, st = _integrate(
                            pars, rhs, jac, u, 0.0, chunkstep, saveat_local,
                            reltol, abstol, stops_rows[nc],
                            (nc * chunkstep, args_payload), first_step=h,
                            prepare=prepare, warm_start=warm)
                    worst = min(worst, status)
                    for k in STAT_KEYS:
                        acc[k] += st[k]
                    h = st["h"]
                    if use_warm:
                        warm = st["warm"]
                    ys_parts.append(ys)
                    if status != bdf.DONE:
                        break
            if status != bdf.DONE:
                # a failed solve is retried or raises: the rest is moot
                break
            if pars.progress:
                logger.info("   - Chunkwise ODE: %d/%d chunks", hi, n_chunks)
        return worst, (ys_parts, acc)

    status, (ys_parts, acc), attempts = _adaptive_device_solve(solve_fn, pars)
    ys = torch.cat(ys_parts).cpu().numpy()
    ys = np.concatenate([u0.cpu().numpy(), ys])
    ts = np.concatenate([
        [0.0],
        (np.arange(n_chunks)[:, None] * chunkstep + saveat_local[None, :]).ravel()])
    stats = {"attempts": attempts, "n_chunks": n_chunks}
    stats.update(acc)
    return ts, ys, status, stats


# ---------------------------------------------------------------------------
# solve_network — the public entry point (methods.jl:86-130, 330-360)
# ---------------------------------------------------------------------------

@spanned("solve.network")
def solve_network(method: AbstractODESolveMethod, sd: SpeciesData, rd: RxData,
                  copy_network: bool = True, return_integrator: bool = False,
                  device=DEFAULT_DEVICE):
    """Solve a CRN under the given method on ``device``; returns an
    :class:`~kinetica_tpu_torch.analysis.io.ODESolveOutput`.

    Dispatch (mirroring the reference): StaticODESolve x {complete,
    chunkwise}; VariableODESolve x {complete, chunkwise} x {continuous,
    discrete}. Rate constants come from the calculator on its own device
    and move to ``device``.
    """
    from ..analysis.io import ODESolveOutput

    pars = method.pars
    conditions = method.conditions
    calc = method.calculator
    dtype = _state_dtype(pars)
    device = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=device)
    fst = dict(dtype=dtype, device=device)

    with span("solve.setup"):
        if copy_network:
            sd_active, rd_active = sd.copy(), rd.copy()
        else:
            sd_active, rd_active = sd, rd

        is_variable = isinstance(method, VariableODESolve)
        if is_variable:
            logger.info(" - Calculating variable condition profiles.")
            conditions.solve_variable_conditions(pars)

        logger.info(" - Filtering reactions...")
        mask = method.filter.get_filter_mask(sd_active, rd_active)
        filtered_ids = list(np.flatnonzero(mask))
        rd_active.splice(filtered_ids)
        # the reference splices the calculator's per-reaction parameters too
        if filtered_ids:
            calc.splice(filtered_ids)
        logger.info("   - Removed %d filtered reactions from network", int(mask.sum()))

        logger.info(" - Performing calculator-specific network setup.")
        with timed("solve.calculator_setup"):
            calc.setup_network(sd_active, rd_active)

        logger.info(" - Removing low-rate reactions")
        apply_low_k_cutoff(rd_active, calc, pars, conditions)

        if rd_active.nr == 0:
            raise ValueError(
                "CRN has no reactions after filtering/setup/low-k cutoff; "
                "nothing to solve. Check the filter masks, low_k_cutoff and "
                "(for explored networks) the max_molecularity ingestion limit.")

        _check_lu_precision(pars, sd_active.n)
        net = build_mass_action(rd_active, sd_active.n, device=device,
                                dtype=dtype, clip_delta=resolve_clip_delta(pars))
        jdt = _jac_dtype(pars)
        jac_net = net.to_dtype(jdt) if jdt != dtype else None
        u0 = torch.as_tensor(make_u0(sd_active, pars), **fst)[None]

        update_mode = ("discrete" if (is_variable and conditions.discrete_updates)
                       else ("continuous" if is_variable else "static"))
        contraction = _resolve_contraction(net, pars)

        # --- rate specification ---
        k_series = None
        k_fn = None
        if update_mode == "static":
            payload = torch.as_tensor(get_initial_rates(conditions, calc),
                                      **fst)[None].contiguous()
            global_stops = None
        elif update_mode == "discrete":
            logger.info(" - Pre-calculating rate constants at discrete time intervals.")
            with timed("solve.rate_precalc"):
                tstops, k_table = calculate_discrete_rates(conditions, calc,
                                                           rd_active.nr)
            # one host-to-device copy of the table per solve
            payload = (torch.as_tensor(tstops, **f64),
                       torch.as_tensor(k_table, **fst))
            global_stops = tstops
            k_series = TimeSeries(tstops, k_table)
        else:
            k_fn = _make_continuous_k_fn(conditions, calc)
            payload = None
            global_stops = np.asarray(conditions.get_tstops())
        rhs, jac, prepare = _make_rhs_jac(net, update_mode, k_fn=k_fn,
                                          jac_net=jac_net, contraction=contraction,
                                          analytic_jac=pars.jac,
                                          jac_form=_resolve_jac_form(pars))

    if return_integrator:
        logger.info(" - Returning integrator early.")
        return KineticIntegrator(rhs=rhs, jac=jac, net=net, u0=u0[0],
                                 args=(0.0, payload), pars=pars,
                                 stops=global_stops, prepare=prepare)

    logger.info(" - Solving network...")
    if pars.solve_chunks:
        ts, ys, status, stats = _run_chunkwise(rhs, jac, u0, pars,
                                               global_stops, payload,
                                               prepare=prepare)
    else:
        saveat = _complete_saveat(pars)
        ts, ys, status, stats = _run_complete(rhs, jac, u0, pars, saveat,
                                              global_stops, payload,
                                              prepare=prepare)
    bdf.count_lanes(stats["n_steps"], stats["n_rejected"])
    logger.info(" - Solved.")

    # --- variable-condition traces at the save times (ODESolutionVC parity) ---
    vcs = {}
    if is_variable:
        for sym, prof in conditions.get_variable_profiles().items():
            vcs[sym] = prof.value(ts).cpu().numpy().astype(np.float64)

    sol = ODESolution(t=ts, u=ys, retcode=retcode_from_status(status),
                      vcs=vcs, k=k_series, stats=stats)
    return ODESolveOutput(method, sol, sd_active, rd_active)
