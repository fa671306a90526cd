"""Device-to-host reads on the solve path, counted.

The batched BDF loop is driven from the host, so a few decisions per step
need a value from the device: whether any lane still runs, which lanes
refactor, whether Newton iterations remain. Every such read goes through
this module, which counts it (``count``, and ``by_site`` by the caller's
site, one of ``SITES``) and records it as a ``host_sync.read`` span (attr
``site``; the span includes the wait on the device).
"""
from __future__ import annotations

import torch

from ..utils.profiling import span

# the call sites of the reads: the BDF loop's running mask, Newton's
# active mask, the stale-J refresh, the factor's gate, Newton-Schulz's
# cheap and accurate phases, the RK45 loop's running mask
SITES = ("bdf.loop", "bdf.newton", "bdf.jac_refresh", "linalg.factor_gate",
         "linalg.refine_cheap", "linalg.refine_accurate", "rk45.loop")

count = 0
by_site = dict.fromkeys(SITES, 0)


def _counted(site: str) -> None:
    global count
    count += 1
    by_site[site] += 1


def any_true(mask: torch.Tensor, site: str) -> bool:
    _counted(site)
    with span("host_sync.read", site=site):
        return bool(mask.any())


def true_indices(mask: torch.Tensor, site: str) -> torch.Tensor:
    """Indices of the set entries of a 1-D mask (stays on the device)."""
    _counted(site)
    with span("host_sync.read", site=site):
        return torch.nonzero(mask).squeeze(1)


def any_true_and_min(mask: torch.Tensor, values: torch.Tensor, site: str):
    """``(mask.any(), values.min())`` as host values, in one read."""
    _counted(site)
    with span("host_sync.read", site=site):
        flag, low = torch.stack([mask.any().long(),
                                 values.min().long()]).tolist()
    return bool(flag), int(low)
