"""Morris elementary-effects screening over reaction rate constants.

Counterpart of ``kinetica_tpu/analysis/screening.py``. Global screening
of which reactions' rate constants an observable depends on across a
multiplicative parameter range: randomised one-at-a-time trajectories
through the scaled hypercube (Morris 1991), summarised per parameter by
``mu_star`` (mean |effect|: importance) and ``sigma`` (std of effects:
nonlinearity and interaction). Rate constants are perturbed as
``k_i -> k_i * 10**((x_i - 1/2) * span_decades)``.

All ``r * (p + 1)`` design points run as one batched discrete-rate
:class:`~kinetica_tpu_torch.parallel.batching.EnsembleProblem` sweep on
``device``, one k table per lane; the design and the statistics are the
reference's host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.network import RxData, SpeciesData
from ..device import DEFAULT_DEVICE
from ..solving.solve_utils import _host, calculate_discrete_rates, make_u0
from ..utils.logging import logger


@dataclass
class MorrisResult:
    """Elementary-effect statistics per screened reaction.

    ``ee`` is the raw (r, p) matrix of elementary effects of the scalar
    objective with respect to each reaction's log10 rate-constant
    perturbation (so units are d(objective) per decade of k).
    """
    rids: np.ndarray          # (p,) screened reaction ids
    mu: np.ndarray            # (p,) mean elementary effect
    mu_star: np.ndarray       # (p,) mean |elementary effect|
    sigma: np.ndarray         # (p,) std of elementary effects
    ee: np.ndarray            # (r, p) raw effects
    span_decades: float = 1.0
    objective_name: str = ""
    failed_points: int = 0

    def ranking(self) -> np.ndarray:
        """Reaction ids sorted by decreasing ``mu_star``."""
        return self.rids[np.argsort(self.mu_star)[::-1]]

    def summarise(self, sd: SpeciesData, rd: RxData, top: int = 10) -> str:
        from ..core.network import format_rxn
        order = np.argsort(self.mu_star)[::-1][:top]
        lines = [f"Morris screening of {self.objective_name or 'objective'} "
                 f"({len(self.rids)} reactions, span {self.span_decades} "
                 "decades):"]
        for j in order:
            rid = int(self.rids[j])
            lines.append(f"  mu*={self.mu_star[j]:.3e} sigma={self.sigma[j]:.3e}"
                         f"  [{rid}] {format_rxn(sd, rd, rid)}")
        return "\n".join(lines)


def morris_design(p: int, n_trajectories: int, n_levels: int = 4,
                  seed: int = 12345) -> tuple[np.ndarray, np.ndarray, float]:
    """Randomised Morris one-at-a-time trajectories on the unit hypercube.

    Returns ``(points, steps, orders, delta)``: ``points`` is
    (r, p + 1, p) with consecutive rows differing in exactly one
    coordinate by ``±delta``; ``signs[t, j] = ±delta`` for the step that
    moved coordinate ``order[t, j]`` — flattened standard construction
    (Morris 1991; Saltelli et al. 2008 ch. 3).
    """
    if n_levels % 2:
        raise ValueError("n_levels must be even")
    rng = np.random.default_rng(seed)
    delta = n_levels / (2.0 * (n_levels - 1))
    base_grid = np.arange(0, n_levels // 2) / (n_levels - 1)  # x + delta <= 1
    points = np.empty((n_trajectories, p + 1, p))
    signs = np.empty((n_trajectories, p), dtype=np.float64)
    orders = np.empty((n_trajectories, p), dtype=np.intp)
    for t in range(n_trajectories):
        x = rng.choice(base_grid, size=p)
        sgn = rng.choice([-1.0, 1.0], size=p)
        # start at the end of the sign's range so every step stays in [0,1]
        x = np.where(sgn < 0, x + delta, x)
        order = rng.permutation(p)
        pts = [x.copy()]
        for i in order:
            x = x.copy()
            x[i] += sgn[i] * delta
            pts.append(x)
        points[t] = np.stack(pts)
        signs[t] = sgn
        orders[t] = order
    if points.min() < -1e-12 or points.max() > 1 + 1e-12:
        raise AssertionError("Morris design left the unit hypercube")
    return points, signs * delta, orders, delta


def morris_screening(method, sd: SpeciesData, rd: RxData,
                     rids: np.ndarray | list[int] | None = None,
                     objective: str | callable = None,
                     n_trajectories: int = 8, n_levels: int = 4,
                     span_decades: float = 1.0, seed: int = 12345,
                     chunk_mode: str = "auto",
                     device=DEFAULT_DEVICE) -> MorrisResult:
    """Screen reaction importance by Morris elementary effects.

    * ``method`` — a configured Static/VariableODESolve (its conditions
      must support discrete rate tables; static conditions always do).
    * ``rids`` — reaction ids to screen (default: all — keep the batch
      ``n_trajectories * (p + 1)`` in mind at large nr).
    * ``objective`` — a species SMILES (scalar objective = its final
      concentration) or a callable ``f(t, u) -> float`` over one
      member's saved trajectory. Defaults to the last pushed species.
    * ``span_decades`` — total multiplicative range of each rate
      constant: ``k * 10**±(span_decades / 2)``.

    All design points are solved in ONE batched ensemble sweep.
    """
    from ..parallel.batching import EnsembleProblem

    rids = (np.arange(rd.nr) if rids is None
            else np.asarray(rids, dtype=np.intp))
    p = rids.size
    if objective is None:
        objective = sd.toStr[sd.n - 1]
    if isinstance(objective, str):
        sid = sd.toInt[objective]
        obj_fn = lambda t, u: float(u[-1, sid])
        obj_name = f"final [{objective}]"
    else:
        obj_fn = objective
        obj_name = getattr(objective, "__name__", "objective")

    # nominal discrete rate table on the method's conditions
    conditions = method.conditions
    pars = method.pars
    if conditions.isstatic():
        tstops = np.asarray([pars.tspan[1]], dtype=np.float64)
        bound = dict(conditions.get_static_conditions())
        k_base = _host(method.calculator(**bound))[None]      # (1, nr)
    else:
        conditions.solve_variable_conditions(pars)
        tstops, k_base = calculate_discrete_rates(conditions,
                                                  method.calculator, rd.nr)

    points, steps, orders, delta = morris_design(p, n_trajectories,
                                                 n_levels, seed)
    B = n_trajectories * (p + 1)
    logger.info(" - Morris screening: %d reactions, %d trajectories -> "
                "%d batched solves", p, n_trajectories, B)

    # multiplicative factors per design point: (B, nr)
    factors = np.ones((B, rd.nr))
    flat = points.reshape(B, p)
    factors[:, rids] = 10.0 ** ((flat - 0.5) * span_decades)
    k_tables = k_base[None] * factors[:, None, :]   # (B, n_stops, nr)

    problem = EnsembleProblem(method, sd, rd, rate_mode="discrete",
                              chunk_mode=chunk_mode, device=device)
    ens = problem.solve(k_tables=k_tables, tstops=tstops)
    ok = np.asarray([rc == "Success" for rc in ens.retcodes])
    f = np.full(B, np.nan)
    t = np.asarray(ens.t)
    for b in np.flatnonzero(ok):
        f[b] = obj_fn(t, np.asarray(ens.u[b]))
    f = f.reshape(n_trajectories, p + 1)

    # elementary effects: consecutive points differ in coordinate
    # orders[t, j] by steps[t, orders[t, j]]
    ee = np.full((n_trajectories, p), np.nan)
    for tr in range(n_trajectories):
        for j in range(p):
            i = orders[tr, j]
            ee[tr, i] = (f[tr, j + 1] - f[tr, j]) / steps[tr, i]
    # steps are on the unit hypercube; rescale so effects are per DECADE
    ee = ee / span_decades

    valid = np.isfinite(ee)
    n_failed = int(B - ok.sum())
    if n_failed:
        logger.warning("   - %d Morris design point(s) failed to solve; "
                       "their effects are excluded", n_failed)
    with np.errstate(invalid="ignore"):
        mu = np.nanmean(ee, axis=0)
        mu_star = np.nanmean(np.abs(ee), axis=0)
        n_valid = valid.sum(axis=0)
        if (n_valid > 1).any():
            import warnings
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                sigma = np.nanstd(ee, axis=0, ddof=1)
            sigma = np.where(n_valid > 1, sigma, 0.0)
        else:
            sigma = np.zeros(p)
    return MorrisResult(rids=rids, mu=mu, mu_star=mu_star, sigma=sigma,
                        ee=ee, span_decades=span_decades,
                        objective_name=obj_name, failed_points=n_failed)
