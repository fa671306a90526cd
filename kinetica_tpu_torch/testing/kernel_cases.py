"""Edge-case inputs of the kernels, made from a seed with numpy.

The CPU tests hold the plain versions against the JAX package on them, and
``chip_smoke.py`` holds the kernels against the plain versions on the card,
so both see the same cases.
"""
from __future__ import annotations

import numpy as np
import torch

# the Gauss-Jordan widths the edge cases cover: one element, the ragged
# tile edges (33, 53 = the 181-wide Schur block, 73 = nc=24, 127) and the
# kernel's limit
GJ_EDGE_WIDTHS = (1, 33, 53, 73, 127, 128)


def near_singular_newton(B: int, n: int, seed: int = 0) -> np.ndarray:
    """(B, n, n) f32 equilibrated Newton matrices I - c J that are
    singular, or nearly so, in f32.

    J is a conserved first-order network over every pair of species:
    species j turns into species i at rate k_ij = 10^U(-2, 12), so J = K -
    diag(column sums of K) and ones(n) is a left null vector of J; c =
    10^U(0, 6) a member. Each I - c J is scaled by the Newton factor's row
    and column equilibration (``ops.linalg._equilibrate``). A Gauss-Jordan
    elimination that exchanges rows by an exact copy instead of the
    reference's arithmetic meets an exactly cancelled pivot on some of
    them and comes out at the 1e30 clamp."""
    from ..ops.linalg import _equilibrate
    rng = np.random.default_rng(seed)
    K = 10.0 ** rng.uniform(-2.0, 12.0, (B, n, n))
    K[:, np.arange(n), np.arange(n)] = 0.0
    J = K - np.eye(n) * K.sum(axis=1)[:, None, :]
    c = 10.0 ** rng.uniform(0.0, 6.0, (B, 1, 1))
    return _equilibrate(torch.as_tensor(np.eye(n) - c * J))[0].numpy()


def gj_edge_cases(n: int, seed: int = 0) -> tuple[np.ndarray, list[str]]:
    """(members, n, n) f32 matrices and their names.

    * ``"random"``: I + G / (2 sqrt(n)), G standard normal (its spectrum
      lies in a disk of radius 1/2 about 1: well conditioned at every n);
    * ``"tie"``: the same with two equal largest |a_i0| of column 0, in
      rows n // 3 and a later one (2 a and -2 a): the first row must win;
    * ``"nan_column"``: column n // 2 all NaN (the member comes out NaN,
      the others are untouched);
    * ``"singular"``: column (n - 1) // 2 all zero (comes out finite);
    * ``"near_singular"``: a member of :func:`near_singular_newton` (the
      pivot cancellations of the row exchange).

    ``"tie"`` needs two rows, so it is left out at n = 1.
    """
    rng = np.random.default_rng(seed)
    base = (np.eye(n) + rng.standard_normal((n, n)) / (2.0 * np.sqrt(n))
            ).astype(np.float32)
    cases = {"random": base}
    if n >= 2:
        tie = base.copy()
        top = np.float32(2.0) * np.abs(tie[:, 0]).max()
        t1 = n // 3
        t2 = max(2 * n // 3, t1 + 1)
        tie[t1, 0], tie[t2, 0] = top, -top
        cases["tie"] = tie
    nan = base.copy()
    nan[:, n // 2] = np.nan
    cases["nan_column"] = nan
    sing = base.copy()
    sing[:, (n - 1) // 2] = 0.0
    cases["singular"] = sing
    cases["near_singular"] = near_singular_newton(1, n, seed)[0]
    return np.stack(list(cases.values())), list(cases)


def rhs_edge_network(ns: int = 73, nr: int = 1095, long_row: int = 700,
                     seed: int = 0) -> tuple[np.ndarray, np.ndarray, int, int]:
    """A network whose species rows include an empty one and a long one.

    Returns ``(N, slots, empty, long)``: N (nr, ns) f64 with small-integer
    coefficients (two to three species a reaction), slots (nr, 2) indices
    into ``u_aug`` (``ns`` is the constant 1), species ``empty`` in no
    reaction's N and species ``long`` in the first ``long_row`` reactions.
    """
    rng = np.random.default_rng(seed)
    empty, long = 1, 0
    others = np.setdiff1d(np.arange(ns), [empty, long])
    N = np.zeros((nr, ns))
    for j in range(nr):
        sp = rng.choice(others, size=rng.integers(2, 4), replace=False)
        N[j, sp] = rng.choice([-2.0, -1.0, 1.0, 2.0], size=sp.size)
    N[:long_row, long] = rng.choice([-1.0, 1.0], size=long_row)
    slots = rng.integers(0, ns + 1, (nr, 2))
    return N, slots, empty, long


def rhs_rel_err(fused, u_aug, k, du):
    """max |du - plain| / sum_j |N_js r_j| over the entries, for ``du``
    computed by the fused RHS ``fused`` from ``u_aug`` and ``k``."""
    r = k * u_aug[:, fused._slots64].prod(dim=-1)
    scale = r.abs()[:, fused.csr.rxn64] * fused.csr.coef.abs()
    denom = torch.zeros_like(du).index_add_(1, fused.csr.species64, scale)
    return float(((du - fused.plain(u_aug, k)).abs()
                  / denom.clamp_min(1e-300)).max())


# the Newton-solve widths the edge cases cover: one row, the warp edges
# (31, 32, 33) and the main path's widths (73 = nc=24, 181 = nc=60); each
# splits into ragged row slabs at the larger cluster sizes
NEWTON_EDGE_WIDTHS = (1, 31, 32, 33, 73, 181)


def newton_edge_cases(n: int, seed: int = 0):
    """``(M, J, b, c, names)``: four lanes of (I - c J) dy = b, as numpy
    arrays (M and J f32, b and c f64).

    Each lane has its own standard normal J and c = 0.1 / rho(J), so every
    eigenvalue of c J lies within 0.1 of 0.

    * ``"random"``: M the f32 inverse of I - c J, b standard normal;
    * ``"zero_b"``: the same with b = 0: dy = 0, and the lane stops after
      the mandatory sweep;
    * ``"nan"``: the same with b[n // 2] = NaN: the lane comes out all NaN,
      the others untouched;
    * ``"stale"``: M the inverse of I - 3 c J (a factor built at a stale c):
      a sweep cuts the error only by ~0.15-0.3, so the lane takes every
      sweep of four.
    """
    rng = np.random.default_rng(seed)
    names = ["random", "zero_b", "nan", "stale"]
    B = len(names)
    J = rng.standard_normal((B, n, n))
    c = 0.1 / np.abs(np.linalg.eigvals(J)).max(axis=1)
    b = rng.standard_normal((B, n))
    shift = np.where(np.array(names) == "stale", 3.0, 1.0)
    J32 = J.astype(np.float32)
    M = np.linalg.inv(np.eye(n)[None] - (shift * c)[:, None, None]
                      * J32.astype(np.float64)).astype(np.float32)
    b[names.index("zero_b")] = 0.0
    b[names.index("nan"), n // 2] = np.nan
    return M, J32, b, c, names


def newton_sweeps(solve, M, J, b, c, n_sweeps: int = 4) -> torch.Tensor:
    """The sweeps each lane took in ``solve(M, J, b, c, k)``: the fewest k
    whose dy equals the ``n_sweeps`` result bit for bit (a lane that stops
    is frozen; NaN equals NaN here)."""
    final = solve(M, J, b, c, n_sweeps)
    taken = torch.full((b.shape[0],), n_sweeps, dtype=torch.int64)
    for k in range(n_sweeps - 1, 0, -1):
        dy = solve(M, J, b, c, k)
        same = ((dy == final) | (dy.isnan() & final.isnan())).all(dim=1)
        taken = torch.where(same.cpu(), k, taken)
    return taken


def mid_ramp_jacobian(n_carbons: int, device, tf: float = 14.0) -> torch.Tensor:
    """The (ns, ns) f32 Jacobian of ``synthetic_pyrolysis_network(n_carbons)``
    at the mid-ramp state of ``chip_smoke.py``'s member 0: the 40 K/s ramp
    from 500 K (``PrecalculatedArrheniusCalculator``, k_max = 1e12), pure
    C{n_carbons} at t = 0, scipy-BDF (rtol 1e-8, atol 1e-10) to t = tf / 2.
    Phases 4, 4d and 4f build their Newton systems on it."""
    from ..calculators.builtin import PrecalculatedArrheniusCalculator
    from ..conditions.profiles import LinearGradientProfile
    from ..models.mass_action import build_mass_action
    from .cpu_reference import scipy_bdf_baseline
    from .synthetic import synthetic_pyrolysis_network

    rate, t_start = 40.0, 500.0
    sd, rd, Ea, A = synthetic_pyrolysis_network(n_carbons)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device=device)
    prof = LinearGradientProfile(rate=rate, X_start=t_start,
                                 X_end=t_start + rate * tf)
    u0 = np.zeros(sd.n)
    u0[sd.toInt[f"C{n_carbons}"]] = 1.0
    _, u_mid = scipy_bdf_baseline(sd, rd, calc, prof, (0.0, tf / 2), u0,
                                  1e-8, 1e-10, best_of=1)
    jnet = build_mass_action(rd, sd.n, device=device).to_dtype(torch.float32)
    return jnet.jac_matmul(torch.as_tensor(u_mid, device=device).float(),
                           calc(t_start + rate * tf / 2).float())


def _count_differing(x: torch.Tensor, y: torch.Tensor) -> int:
    """Entries of x and y that differ (NaN equals NaN)."""
    return int((~((x == y) | (x.isnan() & y.isnan()))).sum())


def newton_check(M, J, b, c, names=None, old=None) -> dict:
    """The Newton-solve kernel on CUDA inputs against its plain version.

    Returns ``lane_rel`` (per-lane max |d| / max|dy| over the lanes not
    named ``"nan"``), ``finite`` (those lanes), ``nan_lanes_nan`` and
    ``differing``: for every cluster size the card takes (and ``"old"``,
    the result of ``old(M, J, b, c)``), the entries that differ from the
    planned launch's. At B = 0 only the result's shape is checked
    (``shape_ok``).
    """
    from ..ops import newton_solve

    dy = newton_solve.fused_newton_solve(M, J, b, c)
    torch.cuda.synchronize()
    if b.shape[0] == 0:
        return dict(shape_ok=dy.shape == b.shape)
    dyp = newton_solve.fused_newton_solve_plain(M, J, b, c)
    nan = [i for i, name in enumerate(names or []) if name == "nan"]
    keep = [i for i in range(b.shape[0]) if i not in nan]
    lane = ((dy[keep] - dyp[keep]).abs().amax(dim=1)
            / dyp[keep].abs().amax(dim=1).clamp_min(1e-300))
    differing = {cs: _count_differing(newton_solve.launch(M, J, b, c, 4, cs), dy)
                 for cs in newton_solve.cluster_sizes(b.shape[1], b.device)}
    if old is not None:
        differing["old"] = _count_differing(old(M, J, b, c), dy)
    return dict(lane_rel=float(lane.max()),
                finite=bool(dy[keep].isfinite().all()),
                nan_lanes_nan=all(bool(dy[i].isnan().all()) for i in nan),
                differing=differing)
