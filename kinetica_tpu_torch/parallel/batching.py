"""Batched ensemble solves over condition profiles, in PyTorch.

Counterpart of ``kinetica_tpu/parallel/batching.py``. Ported: the
continuous rate mode with the async chunk program — the path the
variable-temperature sweep runs — and the per-member adaptive-tolerance
retry with lane compaction. Each member's profile parameters are packed
into a theta tensor (:func:`build_condition_sweep_theta`) and the rate
constants k(T(t, theta)) are evaluated per lane inside the step.

Not ported: the discrete rate mode, the scan/host/group chunk modes (they
hide dispatch latency on a remote TPU) and the mesh-sharded program.
"""
from __future__ import annotations

import numpy as np
import torch

from ..conditions.condition_set import ConditionSet
from ..core.network import RxData, SpeciesData
from ..models.mass_action import build_mass_action, resolve_clip_delta
from ..ops import bdf
from ..solving.methods import (VariableODESolve, _chunk_local_stops,
                               _chunk_save_grid, _make_rhs_jac,
                               resolve_device)
from ..solving.solutions import EnsembleSolution, retcode_from_status
from ..solving.solve_utils import make_u0
from ..utils.logging import logger


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
    condition profiles through the async chunk program.
    """

    def __init__(self, method: VariableODESolve, sd: SpeciesData, rd: RxData,
                 chunk_mode: str = "async", rate_mode: str = "continuous",
                 device="cpu"):
        if chunk_mode != "async":
            raise ValueError(f"chunk_mode {chunk_mode!r} is not ported "
                             "(kinetica_tpu_torch runs 'async')")
        if rate_mode != "continuous":
            raise ValueError(f"rate_mode {rate_mode!r} is not ported yet "
                             "(kinetica_tpu_torch runs 'continuous')")
        self.method = method
        self.device = resolve_device(device)
        pars = method.pars
        calc = method.calculator
        if not calc.allows_continuous:
            raise ValueError(
                "Calculator does not support continuous rate evaluation.")
        if pars.dtype != "float64":
            raise ValueError("kinetica_tpu_torch solves in float64 only")
        if pars.linsolve not in ("auto", "inv_gated", "lu"):
            raise ValueError(f"linsolve {pars.linsolve!r} is not ported")
        self.linsolve = "lu" if pars.linsolve == "lu" else "inv_gated"
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
        jdt = torch.float64 if pars.jac_dtype == "float64" else torch.float32
        self.jac_net = self.net.to_dtype(jdt)

        template = method.conditions
        classes = {sym: (type(p), tuple(getattr(p, f) for f in p.static_attrs))
                   for sym, p in ((s, template.get_profile(s))
                                  for s in template.symbols)}

        def k_fn(t, payload):
            bound = {sym: cls.value_theta(t, payload[sym], sv)
                     for sym, (cls, sv) in classes.items()}
            return calc(**bound).expand(t.shape[0], -1).contiguous()

        self.rhs, self.jac, self.prepare = _make_rhs_jac(
            self.net, "continuous_theta", k_fn=k_fn, jac_net=self.jac_net)
        self.chunkstep = pars.solve_chunkstep
        self.saveat_local, self.n_chunks = _chunk_save_grid(pars)
        self.pars = pars

    def _run_batch(self, u0s, payload, stops_rows, abstol, reltol):
        """One batched async run -> numpy (statuses, ys (B, chunks, m, ns), steps)."""
        pars = self.pars
        f64 = dict(dtype=torch.float64, device=self.device)
        res = bdf.bdf_solve(
            self.rhs, self.jac, u0s, 0.0, self.chunkstep,
            torch.as_tensor(self.saveat_local, **f64),
            rtol=torch.as_tensor(reltol, **f64),
            atol=torch.as_tensor(abstol, **f64), stops=stops_rows,
            max_steps=int(pars.maxiters), nonnegative=pars.ban_negatives,
            nonnegative_project=pars.project_negatives,
            linsolve=self.linsolve, jac_policy=pars.jac_policy,
            lu_drift_tol=pars.lu_drift_tol, prepare=self.prepare,
            args=payload, chunks=self.n_chunks,
            chunk_offsets=torch.arange(self.n_chunks, **f64) * self.chunkstep)
        return (res.status.cpu().numpy(), res.ys.cpu().numpy(),
                res.n_steps.cpu().numpy())

    def solve(self, conditions_list: list[ConditionSet] | None = None,
              u0s: np.ndarray | None = None) -> EnsembleSolution:
        pars = self.pars
        f64 = dict(dtype=torch.float64, device=self.device)
        if conditions_list is None:
            conditions_list = [self.method.conditions]
        thetas, member_stops = build_condition_sweep_theta(
            conditions_list, self.method.conditions)
        B = member_stops.shape[0]
        payload = {sym: torch.as_tensor(v, **f64) for sym, v in thetas.items()}
        rows = [_chunk_local_stops(member_stops[b], self.n_chunks,
                                   self.chunkstep) for b in range(B)]
        m_max = max(r.shape[1] for r in rows)
        stops_np = np.full((B, self.n_chunks, m_max), np.inf)
        for b, r in enumerate(rows):
            stops_np[b, :, :r.shape[1]] = r
        stops_rows = torch.as_tensor(stops_np, **f64)

        if u0s is None:
            u0s = np.broadcast_to(make_u0(self.sd, pars), (B, self.sd.n))
        elif u0s.shape[0] != B:
            if B != 1:
                raise ValueError("u0s and condition batch sizes do not match")
            B = u0s.shape[0]
            payload = {k: v.expand(B, -1) for k, v in payload.items()}
            stops_rows = stops_rows.expand(B, -1, -1)
        u0s_t = torch.as_tensor(np.ascontiguousarray(u0s), **f64)

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
                statuses, ys, steps_v = self._run_batch(
                    u0s_t, payload, stops_rows, abstol_v, reltol_v)
                statuses, ys, steps_v = (np.array(statuses), np.array(ys),
                                         np.array(steps_v))
            else:
                lanes = np.flatnonzero(statuses != bdf.DONE)
                Br = self._retry_batch_size(lanes.size, B)
                idx = np.concatenate(
                    [lanes, np.full(Br - lanes.size, lanes[0], lanes.dtype)])
                take = torch.as_tensor(idx, device=self.device)
                self.last_retry_batch = int(Br)
                new_st, new_ys, new_steps = self._run_batch(
                    u0s_t[take], {k: v[take] for k, v in payload.items()},
                    stops_rows[take], abstol_v[idx], reltol_v[idx])
                statuses[lanes] = new_st[:lanes.size]
                steps_v[lanes] = new_steps[:lanes.size]
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
                            "n_steps": steps_v})

    @staticmethod
    def _retry_batch_size(n_failed, B):
        """Next power-of-two >= n_failed, capped at the full batch."""
        Br = 1
        while Br < n_failed:
            Br *= 2
        return min(Br, B)
