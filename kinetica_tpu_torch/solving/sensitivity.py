"""Forward parameter sensitivities of CRN solves, in PyTorch.

Counterpart of ``kinetica_tpu/solving/sensitivity.py``. Parameterisation
as the reference: per-reaction log-scalings ``theta`` with
``k_j -> k_j * exp(theta_j)`` at ``theta = 0``, so ``S[t, m, j] =
d u_m(t) / d theta_j`` is the logarithmic sensitivity ``k_j du_m/dk_j``
of the numerical solution (the discrete sensitivity, as CVODES'
staggered forward method; it agrees with the continuous one to
~sqrt(rtol)).

The reference takes ``jax.jacfwd`` of the whole chunkwise solve. The
port's step loop is driven from the host, so the tangents ride as
forward-mode dual tensors (``torch.autograd.forward_ad``) through the
batched BDF, one tangent per lane: the primal ``theta = 0`` is
replicated into P = ``len(rids)`` lanes, lane j's theta carries the unit
tangent e_j, and S[:, :, j] is lane j's tangent of u. The lanes' primal
states are identical inputs through per-lane arithmetic, so on the card
they must come out bit-equal; the solve raises if they do not. On the
CPU, torch's vectorised transcendental kernels and batched GEMMs round an
element by its place in the SIMD loop, so lanes may part by rounding
there (7.7e-11 over 108 lanes on ``synthetic_pyrolysis_network(6)``);
the CPU check holds them to the solve's absolute tolerance. u is lane
0's.

The solve is the reference's: the discrete-rate chunkwise formalism,
the plain dot RHS (no RHS kernel: it has no forward-mode rule) and the
f64 segment-sum Jacobian, ``bdf_solve`` with its defaults for the linear
solve ("auto", "inv_gated" up to 512 species on every device: the
factor's tangent is rule 2, :mod:`~kinetica_tpu_torch.ops.linalg`;
its Newton-Schulz refinement without the phase-2 gate,
:func:`~kinetica_tpu_torch.ops.linalg.ungated_refinement`), the
Jacobian policy ("lazy") and the drift tolerance (0.1), and the step
size and method state carried across chunks. Nothing in the step loop
stops a gradient: the step size, the order rescaling of the differences
and c = h / alpha carry tangents, as in the reference.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
from torch.autograd import forward_ad

from ..core.network import RxData, SpeciesData
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.mass_action import build_mass_action, resolve_clip_delta
from ..ops import bdf
from ..ops.interp import left_constant_lookup
from ..ops.linalg import ungated_refinement
from ..utils.logging import logger
from .methods import (AbstractODESolveMethod, STAT_KEYS, VariableODESolve,
                      _chunk_local_stops, _chunk_save_grid, _make_rhs_jac,
                      _state_dtype)
from .solve_utils import (apply_low_k_cutoff, calculate_discrete_rates,
                          get_initial_rates, make_u0)


@dataclass
class SensitivitySolution:
    """t (nt,), u (nt, ns), S (nt, ns, n_params), rids (n_params,).

    ``rd`` is the network snapshot the solve actually ran on (after
    filtering and the low-k cutoff): ``rids`` index into it. ``stats``
    holds the solve's step counts (summed over chunks; not saved).
    """
    t: np.ndarray
    u: np.ndarray
    S: np.ndarray
    rids: np.ndarray
    rd: RxData = None
    stats: dict = None

    def species_sensitivity(self, sd: SpeciesData, smi: str) -> np.ndarray:
        """(nt, n_params) log-sensitivities of one species' trajectory."""
        return self.S[:, sd.toInt[smi], :]


class SensitivityProblem:
    """Reusable forward-sensitivity solve over one CRN on ``device``.

    Uses the discrete-rate chunkwise formalism: rates are precomputed on
    the conditions' tstop grid and scaled per lane by ``exp(theta)`` after
    the lookup, so a tangent of theta runs through the whole solve.
    """

    def __init__(self, method: AbstractODESolveMethod, sd: SpeciesData,
                 rd: RxData, rids=None, device=DEFAULT_DEVICE):
        pars = method.pars
        # never mutate the caller's calculator: solve_network splices it in
        # place, so a shared instance would desynchronise from our network
        calc = copy.deepcopy(method.calculator)
        self.method = method
        self.sd, self.rd = sd.copy(), rd.copy()
        self.device = resolve_device(device)

        is_variable = isinstance(method, VariableODESolve)
        if is_variable and not method.conditions.discrete_updates:
            raise ValueError(
                "Sensitivity solves use the discrete-rate formalism: build "
                "the ConditionSet with ts_update=... (continuous-only "
                "condition sets are not supported here)")
        if pars.lu_precision not in ("mixed", "full"):
            raise ValueError(f"lu_precision must be 'mixed' or 'full', got "
                             f"{pars.lu_precision!r}")

        mask = method.filter.get_filter_mask(self.sd, self.rd)
        ids = list(np.flatnonzero(mask))
        self.rd.splice(ids)
        if ids:
            calc.splice(ids)
        calc.setup_network(self.sd, self.rd)
        # solve_network's preprocessing, in its order: the conditions are
        # solved before the low-k cutoff ("auto" needs solved profiles)
        if is_variable:
            method.conditions.solve_variable_conditions(pars)
        apply_low_k_cutoff(self.rd, calc, pars, method.conditions)

        self.rids = (np.arange(self.rd.nr, dtype=np.int64) if rids is None
                     else np.asarray(rids, dtype=np.int64))
        if len(self.rids) and (self.rids.min() < 0
                               or self.rids.max() >= self.rd.nr):
            raise ValueError("rids out of range for the filtered network")

        self.dtype = _state_dtype(pars)
        self.net = build_mass_action(self.rd, self.sd.n, device=self.device,
                                     dtype=self.dtype,
                                     clip_delta=resolve_clip_delta(pars))
        if pars.lu_precision == "full" and bdf.resolve_linsolve(
                "auto", self.sd.n) != "lu":
            raise ValueError("lu_precision='full' needs an LU factor; the "
                             "sensitivity solve's factor is an f32 inverse")
        self.rhs, self.jac, _ = _make_rhs_jac(self.net, "discrete",
                                              jac_form="segsum")
        self.pars = pars
        self.t0 = pars.tspan[0]
        self.chunkstep = (pars.solve_chunkstep if pars.solve_chunks
                          else pars.tspan[1] - pars.tspan[0])
        self.saveat_local, self.n_chunks = (
            _chunk_save_grid(pars) if pars.solve_chunks
            else (np.asarray([self.chunkstep]), 1))

        if is_variable:
            tstops, ktab = calculate_discrete_rates(method.conditions, calc,
                                                    self.rd.nr)
        else:
            tstops = np.asarray([0.0])
            ktab = np.asarray(get_initial_rates(method.conditions,
                                                calc))[None, :]
        f64 = dict(dtype=torch.float64, device=self.device)
        self._tstops = torch.as_tensor(tstops, **f64)
        # one (n_stops, nr) table for every lane; the lanes' scales apply
        # after the lookup, so no per-lane copy of the table is made
        self._ktab = torch.as_tensor(np.asarray(ktab), **f64)
        self._stops_rows = _chunk_local_stops(tstops - self.t0,
                                              self.n_chunks, self.chunkstep)
        self._u0 = torch.as_tensor(make_u0(self.sd, pars), dtype=self.dtype,
                                   device=self.device)
        self._rid_idx = torch.as_tensor(self.rids, dtype=torch.int64,
                                        device=self.device)
        self.last_stats: dict = {}

    def _prepare(self, t_stage, t_start, a):
        """k of every lane at the step start: the table row times the
        lane's ``exp(theta)`` scale, in the state dtype."""
        offset, (tstops, ktab, scale) = a
        k = left_constant_lookup(t_start + offset, tstops, ktab) * scale
        return k.to(self.dtype)

    @ungated_refinement()
    def _solve_theta(self, theta, ktab=None, u0=None):
        """The theta-parameterised chunkwise solve, one lane per row of the
        (B, P) ``theta`` (a (P,) vector is one lane). Returns ``(ys,
        status)``: (B, n_chunks * n_save, ns) states after u0 and the
        worst status of each lane over the chunks. A dual ``theta``
        carries its tangents into ``ys``."""
        pars = self.pars
        ktab = self._ktab if ktab is None else ktab
        u0 = self._u0 if u0 is None else u0
        theta = torch.as_tensor(theta, dtype=torch.float64,
                                device=self.device)
        if theta.ndim == 1:
            theta = theta[None]
        B = theta.shape[0]
        scale = torch.ones(B, ktab.shape[1], dtype=ktab.dtype,
                           device=self.device)
        scale = scale.index_copy(1, self._rid_idx, torch.exp(theta))
        u = u0.to(self.dtype).expand(B, -1).contiguous()
        h, warm = None, None
        status = torch.full((B,), bdf.DONE, dtype=torch.int64,
                            device=self.device)
        parts = []
        acc = dict.fromkeys(STAT_KEYS, 0)
        for nc in range(self.n_chunks):
            res = bdf.bdf_solve(
                self.rhs, self.jac, u, 0.0, self.chunkstep, self.saveat_local,
                rtol=pars.reltol, atol=pars.abstol,
                stops=self._stops_rows[nc], max_steps=int(pars.maxiters),
                nonnegative=pars.ban_negatives,
                nonnegative_project=pars.project_negatives, linsolve="auto",
                first_step=h, prepare=self._prepare, warm_start=warm,
                args=(self.t0 + nc * self.chunkstep,
                      (self._tstops, ktab, scale)))
            u, h = res.y_final, res.h
            warm = (res.D, res.order, res.n_equal_steps)
            status = torch.minimum(status, res.status)
            parts.append(res.ys)
            for k in STAT_KEYS:
                acc[k] += int(getattr(res, k).max())
        self.last_stats = acc
        return torch.cat(parts, dim=1), status

    def solve(self) -> SensitivitySolution:
        P = len(self.rids)
        logger.info(" - Forward-sensitivity solve: %d parameters over "
                    "%d chunks.", P, self.n_chunks)
        B = max(P, 1)
        theta0 = torch.zeros(B, P, dtype=torch.float64, device=self.device)
        with forward_ad.dual_level():
            theta = forward_ad.make_dual(
                theta0, torch.eye(B, P, dtype=torch.float64,
                                  device=self.device))
            ys_dual, status = self._solve_theta(theta)
            ys, dys = forward_ad.unpack_dual(ys_dual)
            dys = torch.zeros_like(ys) if dys is None else dys
        worst = int(status.min())
        if worst != bdf.DONE:
            raise RuntimeError(
                f"Sensitivity solve failed (worst BDF status {worst}); "
                "loosen tolerances or reduce the parameter set")
        spread = float((ys - ys[:1]).abs().max()) if B > 1 else 0.0
        self.last_stats["lane_spread"] = spread
        # the card's kernels compute every lane alike: bit-equal lanes. The
        # CPU's vectorised exp/pow/sigmoid and batched GEMMs round an
        # element by its place in the SIMD loop, so there the lanes may
        # part by rounding, held to the solve's absolute tolerance
        limit = 0.0 if self.device.type == "cuda" else float(self.pars.abstol)
        if not spread <= limit:
            raise RuntimeError(
                "Sensitivity solve: the replicated lanes' primal states "
                f"differ by {spread:.3e} (allowed {limit:g} on "
                f"{self.device.type})")
        u0_np = self._u0.double().cpu().numpy()
        u = np.concatenate([u0_np[None], ys[0].double().cpu().numpy()])
        S = dys[:P].double().permute(1, 2, 0).cpu().numpy()
        S_np = np.concatenate([np.zeros((1,) + S.shape[1:]), S])
        ts = self.t0 + np.concatenate([
            [0.0],
            (np.arange(self.n_chunks)[:, None] * self.chunkstep
             + self.saveat_local[None, :]).ravel()])
        stats = dict(self.last_stats, lanes=B, n_chunks=self.n_chunks)
        return SensitivitySolution(t=ts, u=u, S=S_np, rids=self.rids,
                                   rd=self.rd, stats=stats)


def solve_network_sensitivities(method, sd, rd, rids=None,
                                device=DEFAULT_DEVICE):
    """One-shot forward-sensitivity solve (see :class:`SensitivityProblem`)."""
    return SensitivityProblem(method, sd, rd, rids=rids, device=device).solve()


def rank_reactions(sens: SensitivitySolution, sd: SpeciesData,
                   rd: RxData | None = None,
                   species: str | None = None, top_n: int = 10):
    """Rank reactions by peak absolute log-sensitivity.

    ``species`` restricts the ranking to one trajectory; otherwise the max
    is taken over all species. Returns a list of (rid, score) sorted
    descending. The rids index ``sens.rd`` (the filtered network snapshot
    the solve ran on); a ``rd`` with a different reaction count raises.
    """
    if rd is not None and sens.rd is not None and rd.nr != sens.rd.nr:
        raise ValueError(
            f"rd has {rd.nr} reactions but the sensitivity solve ran on "
            f"{sens.rd.nr}; rids index sens.rd — use that network")
    S = (sens.S[:, sd.toInt[species], :][:, None, :] if species is not None
         else sens.S)
    score = np.max(np.abs(S), axis=(0, 1))
    order = np.argsort(score)[::-1][:top_n]
    return [(int(sens.rids[i]), float(score[i])) for i in order]


def save_sensitivities(sens: SensitivitySolution, saveto: str) -> None:
    """Persist a SensitivitySolution as a portable .npz, the reference's
    format (files load in either package).

    The network snapshot is not embedded: save it with the solve output
    (:func:`~kinetica_tpu_torch.analysis.io.save_output`); ``rids`` and
    the reaction count are stored so a mismatched reload is detected.
    """
    if not saveto.endswith(".npz"):
        saveto = saveto + ".npz"
    np.savez_compressed(
        saveto, t=sens.t, u=sens.u, S=sens.S, rids=sens.rids,
        nr=np.asarray(sens.rd.nr if sens.rd is not None else -1))
    logger.info("Saved sensitivities to %s", saveto)


def load_sensitivities(path: str, rd: RxData | None = None) -> SensitivitySolution:
    """Load a :func:`save_sensitivities` file.

    Pass the matching (filtered) ``rd`` to re-attach the network snapshot;
    a reaction-count mismatch raises rather than silently mis-indexing.
    """
    with np.load(path) as z:
        nr = int(z["nr"])
        if rd is not None and nr >= 0 and rd.nr != nr:
            raise ValueError(
                f"Sensitivity file was computed on a {nr}-reaction network "
                f"but the given rd has {rd.nr}")
        return SensitivitySolution(t=z["t"], u=z["u"], S=z["S"],
                                   rids=z["rids"], rd=rd)
