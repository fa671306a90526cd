"""The device the port's entry points run on.

Every public entry point takes ``device=``, default :data:`DEFAULT_DEVICE`
(the card). The CPU runs only when the caller asks for it, as the CPU
tests do with ``device="cpu"``; a CUDA device on a machine without a card
raises instead of running quietly on the CPU.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """An explicit device; a CUDA device without a card is an error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but none is available "
                           "(pass device='cpu' to run on the CPU)")
    return device
