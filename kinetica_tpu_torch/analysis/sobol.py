"""Sobol variance-based global sensitivity of a CRN observable.

Counterpart of ``kinetica_tpu/analysis/sobol.py``. Where Morris screening
(:mod:`kinetica_tpu_torch.analysis.screening`) ranks reactions cheaply,
Sobol indices quantify them: the first-order index ``S1_i`` is the
fraction of the objective's variance explained by rate constant ``i``
alone, the total index ``ST_i`` the fraction it takes part in with all
interactions. Estimators: Saltelli (2010) first order and Jansen (1999)
total order over the radial A/B/AB_i design, ``N * (d + 2)`` solves, the
rate constants perturbed as ``k_i -> k_i * 10**((x_i - 1/2) *
span_decades)`` with ``x`` a scrambled Sobol sequence (scipy.stats.qmc).

The design runs as one batched discrete-rate
:class:`~kinetica_tpu_torch.parallel.batching.EnsembleProblem` sweep on
``device``; design and estimators are the reference's host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.network import RxData, SpeciesData
from ..device import DEFAULT_DEVICE
from ..solving.solve_utils import _host, calculate_discrete_rates
from ..utils.logging import logger


@dataclass
class SobolResult:
    """First-order and total Sobol indices per screened reaction.

    Estimator noise can push ``S1`` slightly negative or above ``ST``
    at small ``n_samples``; ``n_effective`` is the sample count that
    survived solve failures.
    """
    rids: np.ndarray          # (d,) screened reaction ids
    S1: np.ndarray            # (d,) first-order indices
    ST: np.ndarray            # (d,) total-order indices
    var: float                # total objective variance over the design
    mean: float               # objective mean over the A/B samples
    n_samples: int
    n_effective: np.ndarray   # (d,) valid sample rows per index
    span_decades: float = 1.0
    objective_name: str = ""
    failed_points: int = 0

    def ranking(self) -> np.ndarray:
        """Reaction ids sorted by decreasing total index."""
        return self.rids[np.argsort(self.ST)[::-1]]

    def summarise(self, sd: SpeciesData, rd: RxData, top: int = 10) -> str:
        from ..core.network import format_rxn
        order = np.argsort(self.ST)[::-1][:top]
        lines = [f"Sobol indices of {self.objective_name or 'objective'} "
                 f"({len(self.rids)} reactions, N={self.n_samples}, "
                 f"span {self.span_decades} decades):"]
        for j in order:
            rid = int(self.rids[j])
            lines.append(f"  ST={self.ST[j]:.3f} S1={self.S1[j]:.3f}"
                         f"  [{rid}] {format_rxn(sd, rd, rid)}")
        return "\n".join(lines)


def saltelli_design(d: int, n_samples: int, seed: int = 12345
                    ) -> np.ndarray:
    """(N * (d + 2), d) radial Saltelli design on the unit hypercube.

    Rows are ordered ``[A (N rows), B (N rows), AB_0 (N), ..,
    AB_{d-1} (N)]`` where ``AB_i`` is ``A`` with column ``i`` replaced
    from ``B``. Uses a scrambled Sobol sequence for the 2d-dimensional
    joint draw (first d columns -> A, last d -> B), falling back to
    plain pseudo-random if scipy's qmc is unavailable.
    """
    try:
        from scipy.stats import qmc
        # Sobol wants a power-of-two sample count for balance; round up
        # internally and truncate — still low-discrepancy in practice.
        m = int(np.ceil(np.log2(max(n_samples, 2))))
        joint = qmc.Sobol(2 * d, scramble=True, seed=seed
                          ).random_base2(m)[:n_samples]
    except ImportError:                              # pragma: no cover
        joint = np.random.default_rng(seed).random((n_samples, 2 * d))
    A, B = joint[:, :d], joint[:, d:]
    blocks = [A, B]
    for i in range(d):
        ABi = A.copy()
        ABi[:, i] = B[:, i]
        blocks.append(ABi)
    return np.concatenate(blocks, axis=0)


def sobol_indices_from_values(fA: np.ndarray, fB: np.ndarray,
                              fAB: np.ndarray):
    """Pure estimator: Saltelli-2010 first-order + Jansen total indices.

    ``fA, fB`` are (N,), ``fAB`` is (d, N); NaNs (failed solves) are
    excluded row-wise per index. Returns ``(S1, ST, var, mean,
    n_effective)``. Variance is the sample variance of the pooled A/B
    values — the usual normaliser.
    """
    fA = np.asarray(fA, dtype=np.float64)
    fB = np.asarray(fB, dtype=np.float64)
    fAB = np.asarray(fAB, dtype=np.float64)
    d, N = fAB.shape
    base_ok = np.isfinite(fA) & np.isfinite(fB)
    pooled = np.concatenate([fA[np.isfinite(fA)], fB[np.isfinite(fB)]])
    mean = float(pooled.mean()) if pooled.size else float("nan")
    var = float(pooled.var(ddof=1)) if pooled.size > 1 else float("nan")
    S1 = np.full(d, np.nan)
    ST = np.full(d, np.nan)
    n_eff = np.zeros(d, dtype=np.intp)
    for i in range(d):
        ok = base_ok & np.isfinite(fAB[i])
        n_eff[i] = ok.sum()
        if n_eff[i] < 2 or not (var > 0.0):
            continue
        # Saltelli et al. 2010, table 2 (b): V_i = mean(fB * (fABi - fA))
        S1[i] = float(np.mean(fB[ok] * (fAB[i, ok] - fA[ok])) / var)
        # Jansen 1999: E V(f|x_~i) = mean((fA - fABi)^2) / 2
        ST[i] = float(np.mean((fA[ok] - fAB[i, ok]) ** 2) / (2.0 * var))
    return S1, ST, var, mean, n_eff


def sobol_sensitivity(method, sd: SpeciesData, rd: RxData,
                      rids: np.ndarray | list[int] | None = None,
                      objective: str | callable = None,
                      n_samples: int = 64, span_decades: float = 1.0,
                      seed: int = 12345, chunk_mode: str = "auto",
                      device=DEFAULT_DEVICE) -> SobolResult:
    """Variance-based Sobol sensitivity of an observable to rate constants.

    Same contract as :func:`~kinetica_tpu_torch.analysis.screening.morris_screening`
    (``objective`` = species SMILES for its final concentration, or a
    callable ``f(t, u) -> float``); cost is ``n_samples * (d + 2)``
    solves run as ONE batched ensemble sweep — screen with Morris first
    and pass the surviving ``rids`` when ``rd.nr`` is large.
    """
    from ..parallel.batching import EnsembleProblem

    rids = (np.arange(rd.nr) if rids is None
            else np.asarray(rids, dtype=np.intp))
    d = rids.size
    if objective is None:
        objective = sd.toStr[sd.n - 1]
    if isinstance(objective, str):
        sid = sd.toInt[objective]
        obj_fn = lambda t, u: float(u[-1, sid])
        obj_name = f"final [{objective}]"
    else:
        obj_fn = objective
        obj_name = getattr(objective, "__name__", "objective")

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

    design = saltelli_design(d, n_samples, seed)       # (N*(d+2), d)
    Btot = design.shape[0]
    logger.info(" - Sobol sensitivity: %d reactions, N=%d -> %d batched "
                "solves", d, n_samples, Btot)

    factors = np.ones((Btot, rd.nr))
    factors[:, rids] = 10.0 ** ((design - 0.5) * span_decades)
    k_tables = k_base[None] * factors[:, None, :]      # (Btot, n_stops, nr)

    problem = EnsembleProblem(method, sd, rd, rate_mode="discrete",
                              chunk_mode=chunk_mode, device=device)
    ens = problem.solve(k_tables=k_tables, tstops=tstops)
    ok = np.asarray([rc == "Success" for rc in ens.retcodes])
    f = np.full(Btot, np.nan)
    t = np.asarray(ens.t)
    for b in np.flatnonzero(ok):
        f[b] = obj_fn(t, np.asarray(ens.u[b]))
    n_failed = int(Btot - ok.sum())
    if n_failed:
        logger.warning("   - %d Saltelli design point(s) failed to solve; "
                       "excluded row-wise from the estimators", n_failed)

    N = n_samples
    fA, fB = f[:N], f[N:2 * N]
    fAB = f[2 * N:].reshape(d, N)
    S1, ST, var, mean, n_eff = sobol_indices_from_values(fA, fB, fAB)
    return SobolResult(rids=rids, S1=S1, ST=ST, var=var, mean=mean,
                       n_samples=N, n_effective=n_eff,
                       span_decades=span_decades, objective_name=obj_name,
                       failed_points=n_failed)
