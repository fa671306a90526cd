"""Device-to-host reads on the solve path, counted.

The batched BDF loop is driven from the host, so a few decisions per step
need a value from the device: whether any lane still runs, which lanes
refactor, whether Newton iterations remain. Every such read goes through
this module, and ``count`` is the number made since the last reset; it is
a number the chip smoke run reports per step.
"""
from __future__ import annotations

import torch

count = 0


def any_true(mask: torch.Tensor) -> bool:
    global count
    count += 1
    return bool(mask.any())


def true_indices(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the set entries of a 1-D mask (stays on the device)."""
    global count
    count += 1
    return torch.nonzero(mask).squeeze(1)


def any_true_and_min(mask: torch.Tensor, values: torch.Tensor):
    """``(mask.any(), values.min())`` as host values, in one read."""
    global count
    count += 1
    flag, low = torch.stack([mask.any().long(),
                             values.min().long()]).tolist()
    return bool(flag), int(low)
