"""Lookup and interpolation of tabulated profiles and rates.

Counterpart of ``kinetica_tpu/ops/interp.py``: :func:`linear_interp`
(clamped linear interpolation of a table) and
:func:`left_constant_lookup`, the semantics of discrete rate updates,
where the row set at a tstop holds until the next one (the reference's
``ChunkwiseRateUpdateAffect``, solve_utils.jl:488-509), batched over
lanes.
"""
from __future__ import annotations

import torch


def linear_interp(tq, t_grid: torch.Tensor,
                  u_grid: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``u_grid`` rows at ``tq``, clamped to the
    grid's ends.

    ``t_grid`` (nt,) sorted, repeated knots allowed (an interval of zero
    width gives its left row); ``u_grid`` (nt, ...). ``tq`` a scalar or a
    tensor of query times; the result has shape ``tq.shape + u_grid.shape[1:]``.
    """
    tq = torch.as_tensor(tq, dtype=t_grid.dtype, device=t_grid.device)
    tq = torch.clamp(tq, t_grid[0], t_grid[-1])
    idx = torch.searchsorted(t_grid, tq.contiguous(), right=True) - 1
    idx = idx.clamp(0, t_grid.shape[0] - 2)
    t0, t1 = t_grid[idx], t_grid[idx + 1]
    wide = t1 > t0
    w = torch.where(wide, (tq - t0) / torch.where(wide, t1 - t0, 1.0), 0.0)
    w = w.reshape(w.shape + (1,) * (u_grid.ndim - 1))
    return (1.0 - w) * u_grid[idx] + w * u_grid[idx + 1]


def left_constant_lookup(tq: torch.Tensor, t_grid: torch.Tensor,
                         u_grid: torch.Tensor) -> torch.Tensor:
    """``u_grid[i]`` for ``t_grid[i] <= tq < t_grid[i + 1]``, per lane.

    ``tq`` (B,) query times; ``t_grid`` (n,) sorted; ``u_grid`` (n, m)
    shared by every lane or (B, n, m) one table per lane. Queries before
    the first or after the last grid point clamp to the end rows. Returns
    (B, m).
    """
    idx = torch.searchsorted(t_grid, tq.contiguous(), right=True) - 1
    idx = idx.clamp(0, t_grid.shape[0] - 1)
    if u_grid.ndim == 3:
        return u_grid[torch.arange(tq.shape[0], device=tq.device), idx]
    return u_grid[idx]
