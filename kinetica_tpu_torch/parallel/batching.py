"""Batched ensemble solves over condition profiles, in PyTorch.

Counterpart of ``kinetica_tpu/parallel/batching.py``. Ported: the async
chunk program in both rate modes, and the per-member adaptive-tolerance
retry with lane compaction.

* ``rate_mode="discrete"`` (the default, the reference's production
  formalism): every member's k table is precomputed on one shared tstop
  grid (:func:`build_condition_sweep`), copied to the device once per
  solve, and looked up left-constant at each step's start.
* ``rate_mode="continuous"``: each member's profile parameters are packed
  into a theta tensor (:func:`build_condition_sweep_theta`) and the rate
  constants k(T(t, theta)) are evaluated per lane inside the step.

Not ported: the scan/host/group chunk modes (they hide dispatch latency on
a remote TPU; ``chunk_mode="auto"`` resolves to "async" on every device),
the mesh-sharded program, and the reference's 64 MB guard on discrete
tables in async mode (it works around a fault of the remote TPU worker).
"""
from __future__ import annotations

import numpy as np
import torch

from ..conditions.condition_set import ConditionSet
from ..core.network import RxData, SpeciesData
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.mass_action import build_mass_action, resolve_clip_delta
from ..ops import bdf
from ..solving.methods import (VariableODESolve, _chunk_local_stops,
                               _chunk_save_grid, _jac_dtype, _make_rhs_jac,
                               _resolve_contraction)
from ..solving.solutions import EnsembleSolution, retcode_from_status
from ..solving.solve_utils import calculate_discrete_rates, make_u0
from ..utils.logging import logger

# per-lane solver counters an ensemble solution reports in its ``stats``
LANE_STATS = ("n_steps", "n_rejected", "n_jev", "n_lu")


def build_condition_sweep(conditions_list: list[ConditionSet], calculator,
                          nr: int, pars) -> tuple[np.ndarray, np.ndarray]:
    """Precompute per-member k tables on a shared tstop grid.

    All members must share the same simulation horizon (their profiles may
    differ in shape/rate). The shared grid is the union of all members'
    tstops; each member's rate table is evaluated on it.

    Returns (tstops (n_stops,), k_tables (B, n_stops, nr)), host arrays.
    """
    for cs in conditions_list:
        cs.solve_variable_conditions(pars)
    tstops = np.unique(np.concatenate([
        np.asarray(cs.get_tstops(), dtype=np.float64)
        for cs in conditions_list]))
    t_dev = torch.as_tensor(tstops, dtype=torch.float64,
                            device=getattr(calculator, "device", "cpu"))
    k_tables = []
    for cs in conditions_list:
        bound = dict(cs.get_static_conditions())
        for sym, prof in cs.get_variable_profiles().items():
            bound[sym] = prof.value(t_dev)
        kt = calculator(**bound).detach().cpu().numpy()
        if kt.shape != (tstops.size, nr):
            raise ValueError(
                f"calculator returned k table of shape {kt.shape} for "
                f"{tstops.size} condition stops; expected ({tstops.size}, "
                f"{nr}) — on-the-fly calculators must broadcast over array-"
                "valued conditions (k[..., None]-style) to be sweepable")
        k_tables.append(kt)
    return tstops, np.stack(k_tables)


def build_condition_sweep_theta(conditions_list: list[ConditionSet],
                                template: ConditionSet):
    """Pack per-member profile parameters for a continuous-mode sweep.

    Every member must bind the same symbols to the same profile class as
    ``template``; the numeric parameter vectors may vary.

    Returns ``(thetas, member_stops)``: ``thetas[sym]`` is (B, p) and
    ``member_stops`` a (B, n_stops) +inf-padded matrix of each member's
    profile-kink stop times.
    """
    syms = list(template.symbols)
    thetas: dict = {}
    stops_list = []
    for cs in conditions_list:
        if list(cs.symbols) != syms:
            raise ValueError("Ensemble members must bind the same condition "
                             "symbols as the template")
    for sym in syms:
        ref_key = template.get_profile(sym).static_key()
        rows = []
        for cs in conditions_list:
            p = cs.get_profile(sym)
            if p.static_key() != ref_key:
                raise ValueError(
                    f"Profile for {sym!r} differs structurally across the "
                    f"ensemble ({p.static_key()} vs {ref_key}); continuous "
                    "batching requires one profile family")
            rows.append(np.asarray(p.theta()))
        thetas[sym] = np.stack(rows)
    for cs in conditions_list:
        ts = np.asarray(cs.get_tstops(), dtype=np.float64)
        stops_list.append(ts if ts.size else np.array([np.inf]))
    n_max = max(s.size for s in stops_list)
    member_stops = np.full((len(conditions_list), n_max), np.inf)
    for b, s in enumerate(stops_list):
        member_stops[b, :s.size] = s
    return thetas, member_stops


class EnsembleProblem:
    """Reusable batched chunkwise sweep over one CRN on one device.

    Construction applies filters and calculator setup once and builds the
    network and the RHS/Jacobian closures; :meth:`solve` runs any batch of
    condition profiles (or, in discrete mode, of k tables) through the
    async chunk program.
    """

    def __init__(self, method: VariableODESolve, sd: SpeciesData, rd: RxData,
                 chunk_mode: str = "auto", rate_mode: str = "discrete",
                 device=DEFAULT_DEVICE):
        if chunk_mode == "auto":
            chunk_mode = "async"
        if chunk_mode != "async":
            raise ValueError(f"chunk_mode {chunk_mode!r} is not ported "
                             "(kinetica_tpu_torch runs 'async')")
        if rate_mode not in ("discrete", "continuous"):
            raise ValueError(f"unknown rate_mode {rate_mode!r}")
        self.method = method
        self.device = resolve_device(device)
        pars = method.pars
        calc = method.calculator
        if rate_mode == "continuous" and not calc.allows_continuous:
            raise ValueError(
                "Calculator does not support continuous rate evaluation; "
                "use rate_mode='discrete'.")
        if pars.dtype != "float64":
            raise ValueError("kinetica_tpu_torch solves in float64 only")
        self.chunk_mode, self.rate_mode = chunk_mode, rate_mode

        self.sd, self.rd = sd.copy(), rd.copy()
        mask = method.filter.get_filter_mask(self.sd, self.rd)
        ids = list(np.flatnonzero(mask))
        self.rd.splice(ids)
        if ids:
            calc.splice(ids)
        calc.setup_network(self.sd, self.rd)

        self.dtype = torch.float64
        self.net = build_mass_action(self.rd, self.sd.n, device=self.device,
                                     dtype=self.dtype,
                                     clip_delta=resolve_clip_delta(pars))
        # Newton Jacobian in f32 (a preconditioner; the Newton fixed point
        # is anchored by the f64 RHS residual)
        self.jac_net = self.net.to_dtype(_jac_dtype(pars))
        contraction = _resolve_contraction(self.net, pars)

        if rate_mode == "discrete":
            k_fn, mode = None, "discrete"
        else:
            template = method.conditions
            classes = {sym: (type(p), tuple(getattr(p, f)
                                            for f in p.static_attrs))
                       for sym, p in ((s, template.get_profile(s))
                                      for s in template.symbols)}

            def k_fn(t, payload):
                bound = {sym: cls.value_theta(t, payload[sym], sv)
                         for sym, (cls, sv) in classes.items()}
                return calc(**bound).expand(t.shape[0], -1).contiguous()
            mode = "continuous_theta"

        self.rhs, self.jac, self.prepare = _make_rhs_jac(
            self.net, mode, k_fn=k_fn, jac_net=self.jac_net,
            contraction=contraction, analytic_jac=pars.jac)
        self.chunkstep = pars.solve_chunkstep
        self.saveat_local, self.n_chunks = _chunk_save_grid(pars)
        self.pars = pars

    def _run_batch(self, u0s, payload, stops_rows, abstol, reltol):
        """One batched async run -> numpy (statuses, ys (B, chunks, m, ns),
        per-lane counters ``LANE_STATS``)."""
        pars = self.pars
        f64 = dict(dtype=torch.float64, device=self.device)
        res = bdf.bdf_solve(
            self.rhs, self.jac, u0s, 0.0, self.chunkstep,
            torch.as_tensor(self.saveat_local, **f64),
            rtol=torch.as_tensor(reltol, **f64),
            atol=torch.as_tensor(abstol, **f64), stops=stops_rows,
            max_steps=int(pars.maxiters), nonnegative=pars.ban_negatives,
            nonnegative_project=pars.project_negatives,
            linsolve=pars.linsolve, jac_policy=pars.jac_policy,
            lu_drift_tol=pars.lu_drift_tol, prepare=self.prepare,
            args=payload, chunks=self.n_chunks,
            chunk_offsets=torch.arange(self.n_chunks, **f64) * self.chunkstep)
        return (res.status.cpu().numpy(), res.ys.cpu().numpy(),
                {k: getattr(res, k).cpu().numpy() for k in LANE_STATS})

    def solve(self, conditions_list: list[ConditionSet] | None = None,
              u0s: np.ndarray | None = None,
              k_tables: np.ndarray | None = None,
              tstops: np.ndarray | None = None) -> EnsembleSolution:
        """Solve a batch of members.

        Continuous mode: one member per ``conditions_list`` entry (default
        the method's conditions). Discrete mode: the same, or given
        ``k_tables`` (B, n_stops, nr) on the shared grid ``tstops``.
        ``u0s`` (B, ns) overrides the initial states; with one member it
        fans that member out to ``len(u0s)`` lanes.
        """
        pars = self.pars
        calc = self.method.calculator
        f64 = dict(dtype=torch.float64, device=self.device)
        if self.rate_mode == "continuous":
            if k_tables is not None or tstops is not None:
                raise ValueError("k_tables/tstops are discrete-mode inputs")
            if conditions_list is None:
                conditions_list = [self.method.conditions]
            thetas, member_stops = build_condition_sweep_theta(
                conditions_list, self.method.conditions)
            B = member_stops.shape[0]
            payload = {sym: torch.as_tensor(v, **f64)
                       for sym, v in thetas.items()}
            rows = [_chunk_local_stops(member_stops[b], self.n_chunks,
                                       self.chunkstep) for b in range(B)]
            m_max = max(r.shape[1] for r in rows)
            stops_np = np.full((B, self.n_chunks, m_max), np.inf)
            for b, r in enumerate(rows):
                stops_np[b, :, :r.shape[1]] = r
            stops_rows = torch.as_tensor(stops_np, **f64)
        else:
            if k_tables is None:
                if conditions_list is None:
                    self.method.conditions.solve_variable_conditions(pars)
                    tstops, k_table = calculate_discrete_rates(
                        self.method.conditions, calc, self.rd.nr)
                    k_tables = k_table[None]
                else:
                    tstops, k_tables = build_condition_sweep(
                        conditions_list, calc, self.rd.nr, pars)
            elif tstops is None:
                raise ValueError("k_tables needs the tstops it is tabulated on")
            B = k_tables.shape[0]

        if u0s is None:
            u0s = np.broadcast_to(make_u0(self.sd, pars), (B, self.sd.n))
        elif u0s.shape[0] != B:
            if B != 1:
                raise ValueError("u0s and condition batch sizes do not match")
            B = u0s.shape[0]
            if self.rate_mode == "discrete":
                k_tables = np.broadcast_to(k_tables, (B,) + k_tables.shape[1:])
            else:
                payload = {k: v.expand(B, -1) for k, v in payload.items()}
                stops_rows = stops_rows.expand(B, -1, -1)
        if self.rate_mode == "discrete":
            # stops are shared by the members; the k tables reach the
            # device in one copy per solve
            stops_rows = torch.as_tensor(
                _chunk_local_stops(tstops, self.n_chunks, self.chunkstep), **f64)
            payload = (torch.as_tensor(np.asarray(tstops), **f64),
                       torch.as_tensor(np.ascontiguousarray(k_tables), **f64))
        u0s_t = torch.as_tensor(np.array(u0s, dtype=np.float64), **f64)

        logger.info(" - Solving %d-member ensemble (%d chunks each, %s/%s "
                    "mode) on %s...", B, self.n_chunks, self.chunk_mode,
                    self.rate_mode, self.device)

        # Per-member adaptive-tolerance recovery (solve_utils.jl:376-424):
        # failed lanes are re-solved with x10-tightened tolerances, at most
        # 5 attempts, gathered into a power-of-two sized retry batch.
        abstol_v = np.full(B, float(pars.abstol))
        reltol_v = np.full(B, float(pars.reltol))
        mintol = np.finfo(np.float64).eps
        attempts = 0
        statuses = ys = None
        self.last_retry_batch = None
        while True:
            attempts += 1
            if statuses is None:
                statuses, ys, lane_stats = self._run_batch(
                    u0s_t, payload, stops_rows, abstol_v, reltol_v)
                statuses, ys = np.array(statuses), np.array(ys)
            else:
                lanes = np.flatnonzero(statuses != bdf.DONE)
                Br = self._retry_batch_size(lanes.size, B)
                idx = np.concatenate(
                    [lanes, np.full(Br - lanes.size, lanes[0], lanes.dtype)])
                self.last_retry_batch = int(Br)
                new_st, new_ys, new_stats = self._run_batch(
                    *self._gather_lanes(u0s_t, payload, stops_rows, idx),
                    abstol_v[idx], reltol_v[idx])
                statuses[lanes] = new_st[:lanes.size]
                for k, v in lane_stats.items():
                    v[lanes] = new_stats[k][:lanes.size]
                ys[lanes] = new_ys[:lanes.size]
            failed = statuses != bdf.DONE
            if not failed.any() or not pars.adaptive_tols:
                break
            if attempts >= 5:
                logger.error(" - Too many attempts have been made to reduce "
                             "solver tolerance for %d ensemble member(s).",
                             int(failed.sum()))
                break
            if ((abstol_v[failed] / 10 <= mintol).any()
                    or (reltol_v[failed] / 10 <= mintol).any()):
                logger.error(" - Failed ensemble member(s) cannot be converged "
                             "by reducing solver tolerance any further.")
                break
            abstol_v[failed] /= 10
            reltol_v[failed] /= 10
            logger.warning("   - %d ensemble member(s) failed; retrying with "
                           "tolerances tightened to abstol = %g reltol = %g",
                           int(failed.sum()), abstol_v[failed].min(),
                           reltol_v[failed].min())
        m = len(self.saveat_local)
        ys = ys.reshape(B, self.n_chunks * m, -1)
        ys = np.concatenate([np.asarray(u0s)[:, None, :], ys], axis=1)
        ts = np.concatenate([
            [0.0],
            (np.arange(self.n_chunks)[:, None] * self.chunkstep
             + self.saveat_local[None, :]).ravel()])

        vcs = {}
        if conditions_list is not None:
            for sym in conditions_list[0].symbols:
                if conditions_list[0].get_profile(sym).is_variable:
                    vcs[sym] = np.stack([
                        cs.get_profile(sym).value(ts).cpu().numpy()
                        for cs in conditions_list])

        return EnsembleSolution(
            t=ts, u=ys,
            retcodes=[retcode_from_status(s) for s in statuses],
            vcs=vcs, stats={"n_chunks": self.n_chunks, "batch": B,
                            "attempts": attempts,
                            "retry_batch": self.last_retry_batch,
                            "abstol": abstol_v, "reltol": reltol_v,
                            **lane_stats})

    def _gather_lanes(self, u0s_t, payload, stops_rows, idx):
        """The inputs of the lanes ``idx`` (a padded numpy index vector)."""
        take = torch.as_tensor(idx, device=self.device)
        if self.rate_mode == "discrete":
            # shared tstops and stop rows; per-member k tables
            return u0s_t[take], (payload[0], payload[1][take]), stops_rows
        return (u0s_t[take], {k: v[take] for k, v in payload.items()},
                stops_rows[take])

    @staticmethod
    def _retry_batch_size(n_failed, B):
        """Next power-of-two >= n_failed, capped at the full batch."""
        Br = 1
        while Br < n_failed:
            Br *= 2
        return min(Br, B)


def solve_network_ensemble(method: VariableODESolve, sd: SpeciesData,
                           rd: RxData,
                           conditions_list: list[ConditionSet] | None = None,
                           u0s: np.ndarray | None = None,
                           rate_mode: str = "discrete",
                           device=DEFAULT_DEVICE) -> EnsembleSolution:
    """One-shot chunkwise ensemble solve (builds the problem each call; use
    :class:`EnsembleProblem` to reuse it across sweeps)."""
    return EnsembleProblem(method, sd, rd, rate_mode=rate_mode,
                           device=device).solve(
        conditions_list=conditions_list, u0s=u0s)
