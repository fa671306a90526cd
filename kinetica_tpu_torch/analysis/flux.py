"""Reaction flux analysis over solved trajectories.

Counterpart of ``kinetica_tpu/analysis/flux.py``. Decomposes a kinetic
solve into per-reaction fluxes r_j(t) = k_j(t) prod_s u_slot(t), their
time integrals (reaction extents) and the net per-species production
each reaction contributed. Sensitivities
(:mod:`kinetica_tpu_torch.solving.sensitivity`) measure how the solution
would change with each rate constant; fluxes measure what each reaction
did.

The analysis is the reference's host numpy over the saved solution grid;
the rate table is read with the port's ``left_constant_lookup`` (or the
calculator re-evaluated on CPU tensors), and the clip width is the
port's ``resolve_clip_delta``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..solving.solve_utils import _host


@dataclass
class FluxResult:
    """Per-reaction fluxes over a solution's save grid.

    * ``t`` — (nt,) times; ``rates`` — (nt, nr) instantaneous fluxes
      r_j(t) in concentration/time units.
    * ``extent`` — (nr,) integrated flux (trapezoid over the grid):
      the total extent of each reaction over the trajectory.
    * ``net_production`` — (ns,) sum_j N[j, s] * extent_j. Up to save-
      grid integration error this reconstructs u(t_end) - u(t_0).
    * ``identity_error`` — the self-check residual: |net - du| over
      [t_1, t_end] relative to the gross per-species flux. The first
      save interval is excluded (stiff solves equilibrate fast
      pre-equilibria in a sub-grid spike at t_0 that NO save grid
      integrates — e.g. the isomerisation burst when starting from a
      pure feed), and the normalisation is the gross flux, not du
      (near fast equilibria forward/backward extents are orders of
      magnitude larger than their difference, so du-level
      reconstruction is intrinsically cancelled away). A failing check
      is a STATEMENT ABOUT THE REGIME, not only the grid: on
      k_max-saturated networks whose entire conversion happens in a
      sub-grid ignition burst, no save density makes grid-level
      extents meaningful — analyse fluxes at conditions where the
      dynamics are resolved, or accept instantaneous ``rates`` only
      (``check=False``).
    * ``startup_error`` — the complementary guard for the EXCLUDED
      first interval: |ext_0 @ N - (u_1 - u_0)| relative to the
      full-trajectory gross flux. Excluding interval 0 from
      ``identity_error`` is correct for mild pre-equilibria, but an
      unresolved ignition burst there silently dominates the reported
      extents (rate(t_0) is huge on a pure saturated feed); this term
      measures that contamination and trips the same check.
    """
    t: np.ndarray
    rates: np.ndarray
    extent: np.ndarray
    net_production: np.ndarray
    identity_error: float = float("nan")
    startup_error: float = float("nan")

    def top(self, n: int = 10):
        """The ``n`` largest-|extent| reactions as (rid, extent) pairs."""
        order = np.argsort(-np.abs(self.extent), kind="stable")[:n]
        return [(int(j), float(self.extent[j])) for j in order]


def _mass_action_arrays(sd, rd):
    """(N, slots) numeric mass-action arrays from the CRN data model."""
    ns, nr = sd.n, rd.nr
    arity = max(2, max((sum(s) for s in rd.stoic_reacs), default=2))
    slots = np.full((nr, arity), ns, dtype=np.int64)   # ns = constant-1 slot
    N = np.zeros((nr, ns))
    for j in range(nr):
        p = 0
        for sid, st in zip(rd.id_reacs[j], rd.stoic_reacs[j]):
            N[j, sid] -= st
            for _ in range(st):
                slots[j, p] = sid
                p += 1
        for sid, st in zip(rd.id_prods[j], rd.stoic_prods[j]):
            N[j, sid] += st
    return N, slots


def _k_of_time(out, calc):
    """(nt, nr) rate-constant table along the save grid.

    Sources, in order: the solve's own discrete rate table (``sol_k``,
    exact left-constant semantics), else re-evaluation of ``calc`` at
    the saved condition traces (continuous formalism; variable symbols
    come from ``sol_vcs``, static symbols from the bound ConditionSet).
    """
    t = np.asarray(out.sol.t)
    if out.sol_k is not None:
        from ..ops.interp import left_constant_lookup
        f64 = dict(dtype=torch.float64)
        ts = torch.as_tensor(np.asarray(out.sol_k.t), **f64)
        table = torch.as_tensor(np.asarray(out.sol_k.u), **f64)
        return left_constant_lookup(torch.as_tensor(t, **f64), ts,
                                    table).numpy()
    if calc is None:
        raise ValueError(
            "this solve has no stored rate table (continuous/static "
            "formalism); pass the calculator via reaction_fluxes(out, "
            "calc=...) so k(t) can be re-evaluated")
    conds_t = {}
    for sym in out.conditions.symbols:
        if sym in out.sol_vcs:
            conds_t[sym] = np.asarray(out.sol_vcs[sym](t))
        else:
            prof = out.conditions.get_profile(sym)
            conds_t[sym] = np.full(t.shape, float(np.asarray(prof.value)))
    try:     # broadcast path: builtin calculators accept tensor conditions
        k = _host(calc(**{s: torch.as_tensor(v, dtype=torch.float64)[:, None]
                          for s, v in conds_t.items()}))
        if k.shape == (t.size, out.rd.nr):
            return k
    except Exception:
        pass
    return np.stack([_host(calc(**{s: float(v[i])
                                   for s, v in conds_t.items()}))
                     for i in range(t.size)])


def reaction_fluxes(out, calc=None, check: bool = True,
                    attribution: str = "trapezoid") -> FluxResult:
    """Compute per-reaction fluxes for a solved network.

    ``out`` is an :class:`~kinetica_tpu_torch.analysis.io.ODESolveOutput`;
    ``calc`` is required for continuous/static solves (no stored rate
    table). With ``check`` (default) the flux/production identity
    sum_j N[j] * extent_j ~ u_end - u_0 is asserted to within save-grid
    integration error.

    ``attribution`` selects how extents are integrated:

    * ``"trapezoid"`` (default) — plain trapezoid of the instantaneous
      rates over the save grid. Faithful only when the grid resolves
      the dynamics; the self-checks raise otherwise.
    * ``"projected"`` — per save interval, extents are made exactly
      consistent with that interval's net species change
      ``e_i @ N = u_{i+1} - u_i`` (conserved quantities exactly
      preserved). Intervals the grid RESOLVES (pre-projection residual
      <= 5% of their gross flux) keep the trapezoid extents with a
      minimum-norm correction — a negligible nudge. Unresolved
      intervals (e.g. an ignition burst from a pure saturated feed,
      where the trapezoid overstates the burst channels by
      ``rate(t0) * dt / |du|``, 10^4-10^5x in practice, including as
      phantom cancelling forward/backward pairs) are REPLACED by the
      minimum-norm extents consistent with the net change — the honest
      answer when only the net is knowable at this grid. The
      per-interval pre-projection residuals are still reported in
      ``identity_error``/``startup_error`` as attribution uncertainty,
      but nothing raises.

    Concentrations enter the rate products through the SAME smooth
    positive clip the device RHS integrates
    (:func:`kinetica_tpu_torch.models.mass_action._clip_pos` at the solve's
    resolved width) rather than a sharp ``max(u, 0)`` — fluxes answer
    "what did each reaction actually do in THIS solve", and for species
    that sit below the clip width the two differ by O(1) relative (the
    sharp form reports phantom flux the integrator never saw).
    """
    from ..models.mass_action import resolve_clip_delta

    if attribution not in ("trapezoid", "projected"):
        raise ValueError("attribution must be 'trapezoid' or 'projected', "
                         f"got {attribution!r}")
    sd, rd, sol = out.sd, out.rd, out.sol
    N, slots = _mass_action_arrays(sd, rd)
    t = np.asarray(sol.t, dtype=np.float64)
    u = np.asarray(sol.u, dtype=np.float64)
    k_t = np.asarray(_k_of_time(out, calc), dtype=np.float64)

    delta = resolve_clip_delta(getattr(out, "pars", None))
    # numpy transcription of models.mass_action._clip_pos (this module
    # stays host-side)
    with np.errstate(over="ignore"):
        u_clip = u / (1.0 + np.exp(-u / delta))
    u_aug = np.concatenate([u_clip, np.ones((u.shape[0], 1))], axis=1)
    rates = k_t * u_aug[:, slots].prod(axis=2)          # (nt, nr)

    if attribution == "projected" and t.size > 1:
        dt = np.diff(t)[:, None]
        E0 = 0.5 * (rates[:-1] + rates[1:]) * dt        # (nt-1, nr)
        dU = np.diff(u, axis=0)                         # (nt-1, ns)
        # per-interval resolvedness: trapezoid residual vs gross flux
        resid0 = E0 @ N - dU                            # (nt-1, ns)
        gross0 = np.abs(E0) @ np.abs(N)                 # (nt-1, ns)
        resolved = (np.abs(resid0).max(axis=1)
                    <= 0.05 * np.maximum(gross0.max(axis=1), 1e-300))
        # resolved: keep E0, nudge by min-norm correction; unresolved:
        # E0 := 0 so the same formula yields the pure min-norm extents
        # consistent with du. resid/du lie in row-space(N) (conserved
        # components cancel up to solver drift), so the pinv projection
        # makes the constraint exact to that drift.
        E0 = E0 * resolved[:, None]
        P = np.linalg.pinv(N.T @ N)                     # (ns, ns)
        resid = E0 @ N - dU
        E = E0 - (resid @ P) @ N.T
        extent = E.sum(axis=0)
        check = False                                   # exact by design
    else:
        extent = np.trapezoid(rates, t, axis=0)
    net = extent @ N

    # self-checks (see FluxResult.identity_error / startup_error for
    # the interval split and the gross normalisations)
    err = err0 = float("nan")
    if t.size > 2:
        ext_tail = np.trapezoid(rates[1:], t[1:], axis=0)
        du_tail = u[-1] - u[1]
        gross_tail = np.abs(ext_tail) @ np.abs(N)
        err = float(np.abs(ext_tail @ N - du_tail).max()
                    / max(gross_tail.max(), 1e-300))
        ext0 = np.trapezoid(rates[:2], t[:2], axis=0)
        gross_full = np.abs(extent) @ np.abs(N)
        err0 = float(np.abs(ext0 @ N - (u[1] - u[0])).max()
                     / max(gross_full.max(), 1e-300))
        if check and max(err, err0) > 0.05:
            which = ("startup interval holds an unresolved ignition "
                     "burst that dominates the extents"
                     if err0 > err else
                     "the save grid is too coarse to integrate the "
                     "fluxes faithfully")
            raise ValueError(
                f"flux/production identity violated (tail {err:.1%} / "
                f"startup {err0:.1%} of the gross flux): {which} — "
                "re-solve with a finer save grid (smaller save_interval), "
                "or, if the conversion is a sub-grid ignition burst "
                "(saturated k), analyse at conditions where the dynamics "
                "are resolved; check=False keeps the instantaneous rates "
                "(extents remain grid artifacts)")
    return FluxResult(t=t, rates=rates, extent=extent, net_production=net,
                      identity_error=err, startup_error=err0)


def species_flux_balance(flux: FluxResult, out, species: str, n: int = 10):
    """The ``n`` reactions contributing most to one species' net change,
    as (rid, contribution) pairs where contribution = N[j, s] * extent_j
    (concentration units, signed)."""
    sd, rd = out.sd, out.rd
    N, _ = _mass_action_arrays(sd, rd)
    sid = sd.toInt[species]
    contrib = N[:, sid] * flux.extent
    order = np.argsort(-np.abs(contrib), kind="stable")[:n]
    return [(int(j), float(contrib[j])) for j in order]
