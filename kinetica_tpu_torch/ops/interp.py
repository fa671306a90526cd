"""Left-constant lookup of tabulated rates, batched over lanes.

Counterpart of ``kinetica_tpu/ops/interp.py::left_constant_lookup``: the
semantics of discrete rate updates, where the row set at a tstop holds
until the next one (the reference's ``ChunkwiseRateUpdateAffect``,
solve_utils.jl:488-509).
"""
from __future__ import annotations

import torch


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
