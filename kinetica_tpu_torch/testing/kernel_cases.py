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


def gj_edge_cases(n: int, seed: int = 0) -> tuple[np.ndarray, list[str]]:
    """(members, n, n) f32 matrices and their names.

    * ``"random"``: I + G / (2 sqrt(n)), G standard normal (its spectrum
      lies in a disk of radius 1/2 about 1: well conditioned at every n);
    * ``"tie"``: the same with two equal largest |a_i0| of column 0, in
      rows n // 3 and a later one (2 a and -2 a): the first row must win;
    * ``"nan_column"``: column n // 2 all NaN (the member comes out NaN,
      the others are untouched);
    * ``"singular"``: column (n - 1) // 2 all zero (comes out finite).

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
