"""Batched ensemble solves over condition profiles, in PyTorch.

Counterpart of ``kinetica_tpu/parallel/batching.py``. Ported: the async
chunk program in both rate modes, the per-member adaptive-tolerance retry
with lane compaction, and the mesh-sharded solve.

* ``rate_mode="discrete"`` (the default, the reference's production
  formalism): every member's k table is precomputed on one shared tstop
  grid (:func:`build_condition_sweep`), copied to the device once per
  solve, and looked up left-constant at each step's start.
* ``rate_mode="continuous"``: each member's profile parameters are packed
  into a theta tensor (:func:`build_condition_sweep_theta`) and the rate
  constants k(T(t, theta)) are evaluated per lane inside the step.
* ``pars.dtype="float32"`` keeps state, rates and k tables in f32, as
  :func:`~kinetica_tpu_torch.solving.methods.solve_network` does.
* ``pars.progress`` logs the chunks every lane has finished, after every
  ``chunks_per_dispatch`` of them, from the loop's existing reads.
* The call's phases are spans of :mod:`kinetica_tpu_torch.utils.profiling`:
  ``ensemble.solve`` (the call), ``ensemble.prepare`` (inputs to the
  device), ``ensemble.attempt`` (each pass of the retry loop, attr
  ``lanes``) and ``ensemble.collect`` (the solution).
* ``nr_multiple`` pads the reaction axis with inert reactions (zero
  stoichiometry, zero rate) to a multiple; with a ``"model"`` mesh to a
  multiple of the model axis too.
* ``solve(sharding=mesh)`` over a :class:`~kinetica_tpu_torch.parallel.
  sharding.Mesh` (one process per rank, SPMD): each rank of the
  ``"batch"`` axis solves a contiguous block of B / n_batch members, and
  every rank returns the whole :class:`EnsembleSolution`. With a
  ``"model"`` axis, model rank m evaluates reactions ``[m nr_loc, (m+1)
  nr_loc)`` through the same contraction on its block (the fused RHS
  kernel, the contraction kernel or the plain dot) and its share of the
  Jacobian, an ``all_reduce`` over the model axis sums the shares, and
  every model rank runs the identical BDF loop on the sums: the
  counterpart of the reference's ``shard_map`` program, forward-only as
  that is. The adaptive retry stays global (the ranks exchange statuses,
  and every rank retries the same lanes); the model ranks' per-lane
  counters must agree at the end, else the solve raises.

Not ported: the scan/host/group chunk modes (they hide dispatch latency on
a remote TPU; ``chunk_mode="auto"`` resolves to "async" on every device,
and the sharded program is async too, where the reference's is scan), the
reference's 64 MB guard on discrete tables in async mode (it works around
a fault of the remote TPU worker) and its per-shard ``DD_CHUNK`` padding
(the port's kernels take any reaction count). The reference shards the
dense f64 dot without a constructor mesh through its partitioner; the
port has no partitioner, so a ``"model"`` mesh always needs the
constructor's ``mesh``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..conditions.condition_set import ConditionSet
from ..core.network import RxData, SpeciesData
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.mass_action import (build_mass_action, pad_reactions,
                                  resolve_clip_delta)
from ..ops import bdf
from ..ops.jvp import has_tangent
from ..solving.methods import (VariableODESolve, _check_lu_precision,
                               _chunk_local_stops, _chunk_save_grid,
                               _jac_dtype, _make_rhs_jac, _resolve_contraction,
                               _resolve_jac_form, _state_dtype)
from ..solving.solutions import EnsembleSolution, retcode_from_status
from ..solving.solve_utils import (calculate_discrete_rates, make_u0,
                                   resolve_chunks_per_dispatch)
from ..utils.logging import logger
from ..utils.profiling import span, spanned
from .sharding import (Mesh, Placement, all_reduce_sum, ensemble_shardings,
                       gather_members)

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
    async chunk program. With a ``mesh`` that has a ``"model"`` axis it
    also builds this rank's reaction-sharded program, which
    ``solve(sharding=mesh)`` runs; the problem then lives on the mesh's
    device.
    """

    def __init__(self, method: VariableODESolve, sd: SpeciesData, rd: RxData,
                 chunk_mode: str = "auto", rate_mode: str = "discrete",
                 nr_multiple: int = 1, mesh: Mesh | None = None,
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
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"device {self.device} and the mesh's "
                                 f"device {mesh.device} differ")
            self.device = mesh.device
        pars = method.pars
        calc = method.calculator
        if rate_mode == "continuous" and not calc.allows_continuous:
            raise ValueError(
                "Calculator does not support continuous rate evaluation; "
                "use rate_mode='discrete'.")
        self.dtype = _state_dtype(pars)
        self.chunk_mode, self.rate_mode = chunk_mode, rate_mode

        self.sd, self.rd = sd.copy(), rd.copy()
        mask = method.filter.get_filter_mask(self.sd, self.rd)
        ids = list(np.flatnonzero(mask))
        self.rd.splice(ids)
        if ids:
            calc.splice(ids)
        calc.setup_network(self.sd, self.rd)

        _check_lu_precision(pars, self.sd.n)
        net = build_mass_action(self.rd, self.sd.n, device=self.device,
                                dtype=self.dtype,
                                clip_delta=resolve_clip_delta(pars))
        # reaction-axis padding to a multiple of nr_multiple and of the
        # model axis: the padded reactions are inert, their k zero (the
        # discrete tables are padded in solve(), continuous k below)
        n_model = (mesh.shape["model"] if mesh is not None
                   and "model" in mesh.axis_names else 0)
        multiple = max(int(nr_multiple), 1)
        if n_model:
            multiple = math.lcm(multiple, n_model)
        self._nr_pad = (-net.nr) % multiple
        self.net = pad_reactions(net, net.nr + self._nr_pad)
        # Newton Jacobian in f32 (a preconditioner; the Newton fixed point
        # is anchored by the RHS residual in the state dtype)
        self.jac_net = self.net.to_dtype(_jac_dtype(pars))
        self.pars = pars

        if rate_mode == "discrete":
            k_fn, self._mode = None, "discrete"
        else:
            template = method.conditions
            classes = {sym: (type(p), tuple(getattr(p, f)
                                            for f in p.static_attrs))
                       for sym, p in ((s, template.get_profile(s))
                                      for s in template.symbols)}
            npad = self._nr_pad

            def k_fn(t, payload):
                bound = {sym: cls.value_theta(t, payload[sym], sv)
                         for sym, (cls, sv) in classes.items()}
                k = calc(**bound).expand(t.shape[0], -1)
                return torch.nn.functional.pad(k, (0, npad)).contiguous()
            self._mode = "continuous_theta"

        self.rhs, self.jac, self.prepare = _make_rhs_jac(
            self.net, self._mode, k_fn=k_fn, jac_net=self.jac_net,
            contraction=_resolve_contraction(self.net, pars),
            analytic_jac=pars.jac, jac_form=_resolve_jac_form(pars))
        self.chunkstep = pars.solve_chunkstep
        self.saveat_local, self.n_chunks = _chunk_save_grid(pars)

        self._mesh = mesh
        self._sharded = self._build_sharded(mesh, k_fn) if n_model else None

    def _build_sharded(self, mesh: Mesh, k_fn):
        """This rank's ``(rhs, jac, prepare)`` of the reaction-sharded
        program, the counterpart of the reference's ``_build_sharded``.

        Model rank m holds reactions ``[lo, hi) = [m nr_loc, (m+1) nr_loc)``:
        its contraction is the network's contraction built on that block,
        its J the block's share in the Jacobian dtype, and an
        ``all_reduce`` over the model axis sums both.
        The discrete k table reaches the device already sliced to the
        block (``solve()``); continuous k is evaluated at full length on
        every rank and sliced, as the reference does."""
        n_model = mesh.shape["model"]
        nr_loc = self.net.nr // n_model
        lo = mesh.coords["model"] * nr_loc
        hi = lo + nr_loc
        self.block = (lo, hi)
        net_l = self.net.block(lo, hi)
        k_fn_l = None
        if k_fn is not None:
            def k_fn_l(t, payload):
                return k_fn(t, payload)[:, lo:hi].contiguous()
        rhs_l, jac_l, prepare = _make_rhs_jac(
            net_l, self._mode, k_fn=k_fn_l,
            jac_net=self.jac_net.block(lo, hi),
            contraction=_resolve_contraction(net_l, self.pars),
            analytic_jac=self.pars.jac,
            jac_form=_resolve_jac_form(self.pars))

        def rhs(t, u, k):
            if has_tangent(u, k):
                raise RuntimeError(
                    "the model-sharded ensemble is forward-only (as the "
                    "reference's shard_map program): a dual input would "
                    "lose its tangent in the all_reduce")
            return all_reduce_sum(rhs_l(t, u, k), mesh, "model")

        def jac(t, u, k):
            return all_reduce_sum(jac_l(t, u, k), mesh, "model")

        return rhs, jac, prepare

    def _run_batch(self, u0s, payload, stops_rows, abstol, reltol,
                   sharded=False):
        """One batched async run -> numpy (statuses, ys (B, chunks, m, ns),
        per-lane counters ``LANE_STATS``); ``sharded`` runs this rank's
        reaction-sharded program."""
        pars = self.pars
        rhs, jac, prepare = (self._sharded if sharded
                             else (self.rhs, self.jac, self.prepare))
        f64 = dict(dtype=torch.float64, device=self.device)
        on_chunk = None
        if pars.progress:
            group = resolve_chunks_per_dispatch(pars.chunks_per_dispatch,
                                                self.n_chunks)
            shown = [0]

            def on_chunk(nc):
                done = nc if nc == self.n_chunks else nc - nc % group
                if done > shown[0]:
                    shown[0] = done
                    logger.info("   - chunks 1-%d/%d solved on every lane",
                                done, self.n_chunks)
        res = bdf.bdf_solve(
            rhs, jac, u0s, 0.0, self.chunkstep,
            torch.as_tensor(self.saveat_local, **f64),
            rtol=torch.as_tensor(reltol, **f64),
            atol=torch.as_tensor(abstol, **f64), stops=stops_rows,
            max_steps=int(pars.maxiters), nonnegative=pars.ban_negatives,
            nonnegative_project=pars.project_negatives,
            linsolve=pars.linsolve, jac_policy=pars.jac_policy,
            lu_drift_tol=pars.lu_drift_tol, prepare=prepare,
            args=payload, chunks=self.n_chunks,
            chunk_offsets=torch.arange(self.n_chunks, **f64) * self.chunkstep,
            on_chunk=on_chunk)
        return (res.status.cpu().numpy(), res.ys.cpu().numpy(),
                {k: getattr(res, k).cpu().numpy() for k in LANE_STATS})

    @spanned("ensemble.solve")
    def solve(self, conditions_list: list[ConditionSet] | None = None,
              u0s: np.ndarray | None = None, sharding=None,
              k_tables: np.ndarray | None = None,
              tstops: np.ndarray | None = None) -> EnsembleSolution:
        """Solve a batch of members.

        Continuous mode: one member per ``conditions_list`` entry (default
        the method's conditions). Discrete mode: the same, or given
        ``k_tables`` (B, n_stops, nr) on the shared grid ``tstops``.
        ``u0s`` (B, ns) overrides the initial states; with one member it
        fans that member out to ``len(u0s)`` lanes.

        ``sharding``: None, a :class:`~kinetica_tpu_torch.parallel.
        sharding.Mesh` (members over ``"batch"``, reactions over
        ``"model"``: :func:`~kinetica_tpu_torch.parallel.sharding.
        ensemble_shardings`) or a placement of the member axis
        (:func:`~kinetica_tpu_torch.parallel.sharding.batch_sharding`,
        ``replicated``). Every rank of the mesh calls ``solve`` with the
        same arguments and receives the whole solution.
        """
        with span("ensemble.prepare"):
            pars = self.pars
            calc = self.method.calculator
            f64 = dict(dtype=torch.float64, device=self.device)
            fst = dict(dtype=self.dtype, device=self.device)
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
            plan = self._plan(sharding, B)
            mesh, axis, model = plan or (None, None, False)
            if self.rate_mode == "discrete":
                # stops are shared by the members; the k tables reach the
                # device in one copy per solve, padded to the padded reaction
                # axis and, in a model-sharded solve, cut to this rank's block
                stops_rows = torch.as_tensor(
                    _chunk_local_stops(tstops, self.n_chunks, self.chunkstep), **f64)
                k_tables = np.asarray(k_tables)
                if self._nr_pad:
                    k_tables = np.pad(k_tables, ((0, 0), (0, 0), (0, self._nr_pad)))
                if model:
                    k_tables = k_tables[:, :, self.block[0]:self.block[1]]
                payload = (torch.as_tensor(np.asarray(tstops), **f64),
                           torch.as_tensor(np.ascontiguousarray(k_tables), **fst))
            u0s_t = torch.as_tensor(np.array(u0s, dtype=np.float64), **fst)

        logger.info(" - Solving %d-member ensemble (%d chunks each, %s/%s "
                    "mode) on %s%s...", B, self.n_chunks, self.chunk_mode,
                    self.rate_mode, self.device,
                    "" if mesh is None else f", sharded over {mesh!r}")

        # Per-member adaptive-tolerance recovery (solve_utils.jl:376-424):
        # failed lanes are re-solved with x10-tightened tolerances, at most
        # 5 attempts, gathered into a power-of-two sized retry batch (a
        # multiple of the mesh's batch axis, which splits it again).
        abstol_v = np.full(B, float(pars.abstol))
        reltol_v = np.full(B, float(pars.reltol))
        mintol = np.finfo(np.float64).eps
        multiple = mesh.shape[axis] if axis is not None else 1
        attempts = 0
        statuses = ys = None
        spread = None if mesh is None else 0.0
        self.last_retry_batch = None
        while True:
            with span("ensemble.attempt") as sp:
                attempts += 1
                if statuses is None:
                    idx = np.arange(B)
                else:
                    lanes = np.flatnonzero(statuses != bdf.DONE)
                    Br = self._retry_batch_size(lanes.size, B, multiple)
                    idx = np.concatenate(
                        [lanes, np.full(Br - lanes.size, lanes[0], lanes.dtype)])
                    self.last_retry_batch = int(Br)
                sp.note(lanes=int(idx.size))
                new_st, new_ys, new_stats, new_spread = self._solve_lanes(
                    plan, idx, statuses is None, u0s_t, payload, stops_rows,
                    abstol_v, reltol_v)
                if spread is not None:
                    spread = max(spread, new_spread)
                if statuses is None:
                    statuses, ys, lane_stats = (np.array(new_st), np.array(new_ys),
                                                new_stats)
                else:
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
        with span("ensemble.collect"):
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
                                "rank_spread": spread, **lane_stats})

    def _plan(self, sharding, B):
        """``(mesh, member axis or None, model-sharded)`` of a ``solve``'s
        ``sharding`` (None: unsharded), checked as the reference checks
        it."""
        if sharding is None:
            return None
        if isinstance(sharding, Mesh):
            sharding = ensemble_shardings(sharding)[1]
        if not isinstance(sharding, Placement):
            raise TypeError(f"sharding must be a Mesh or a Placement, got "
                            f"{type(sharding).__name__}")
        mesh, spec = sharding
        model = "model" in spec
        axis = spec[0] if spec else None
        if axis is not None and axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no axis {axis!r}")
        if model:
            if self._sharded is None:
                raise ValueError(
                    "model-axis sharding requires EnsembleProblem(..., "
                    "mesh=mesh), the constructor mesh, so that this rank's "
                    "reaction-sharded program is built (the port has no "
                    "partitioner, for any rhs_contraction)")
            if mesh != self._mesh:
                raise ValueError("solve() mesh differs from the mesh this "
                                 "EnsembleProblem was constructed with")
        n = mesh.shape[axis] if axis is not None else 1
        if B % n:
            raise ValueError(f"batch {B} not divisible by the mesh batch "
                             f"axis ({n})")
        return mesh, axis, model

    def _solve_lanes(self, plan, idx, whole, u0s_t, payload, stops_rows,
                     abstol_v, reltol_v):
        """Solve the lanes ``idx`` of the inputs (all of them when
        ``whole``) -> numpy (statuses, ys, lane counters, spread).

        Sharded, each rank of the member axis takes its contiguous block
        of ``idx``, and the ranks exchange their results: every rank
        returns all of ``idx``'s. ``spread`` is the largest difference of
        ys between ranks that solved the same members (0.0: bit-equal;
        None unsharded)."""
        if plan is None:
            if whole:
                args = (u0s_t, payload, stops_rows)
            else:
                args = self._gather_lanes(u0s_t, payload, stops_rows, idx)
            return (*self._run_batch(*args, abstol_v[idx], reltol_v[idx]),
                    None)
        mesh, axis, model = plan
        if axis is not None:
            idx = idx.reshape(mesh.shape[axis], -1)[mesh.coords[axis]]
        st, ys, stats = self._run_batch(
            *self._gather_lanes(u0s_t, payload, stops_rows, idx),
            abstol_v[idx], reltol_v[idx], sharded=model)
        joined, spread = gather_members(
            mesh, axis, {"status": st, "ys": ys, **stats},
            agree=("status",) + LANE_STATS)
        return (joined["status"], joined["ys"],
                {k: joined[k] for k in LANE_STATS}, spread)

    def _gather_lanes(self, u0s_t, payload, stops_rows, idx):
        """The inputs of the lanes ``idx`` (a padded numpy index vector)."""
        take = torch.as_tensor(idx, device=self.device)
        if self.rate_mode == "discrete":
            # shared tstops and stop rows; per-member k tables
            return u0s_t[take], (payload[0], payload[1][take]), stops_rows
        return (u0s_t[take], {k: v[take] for k, v in payload.items()},
                stops_rows[take])

    @staticmethod
    def _retry_batch_size(n_failed, B, multiple=1):
        """Next power-of-two >= n_failed, rounded up to ``multiple`` (the
        mesh's batch axis, so the retry batch splits evenly) and capped at
        the full batch."""
        Br = 1
        while Br < n_failed:
            Br *= 2
        Br = -(-Br // multiple) * multiple
        return min(Br, B)


def solve_network_ensemble(method: VariableODESolve, sd: SpeciesData,
                           rd: RxData,
                           conditions_list: list[ConditionSet] | None = None,
                           u0s: np.ndarray | None = None,
                           sharding=None,
                           rate_mode: str = "discrete",
                           device=DEFAULT_DEVICE) -> EnsembleSolution:
    """One-shot chunkwise ensemble solve (builds the problem each call; use
    :class:`EnsembleProblem` to reuse it across sweeps). A ``sharding``
    that splits the reaction axis is also the problem's constructor mesh,
    which the port needs for every contraction."""
    mesh = None
    if isinstance(sharding, Mesh) and "model" in sharding.axis_names:
        mesh = sharding
    elif isinstance(sharding, Placement) and "model" in sharding.spec:
        mesh = sharding.mesh
    return EnsembleProblem(method, sd, rd, rate_mode=rate_mode, mesh=mesh,
                           device=device).solve(
        conditions_list=conditions_list, u0s=u0s, sharding=sharding)
