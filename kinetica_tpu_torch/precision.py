"""Float32 matmul precision policy of the port.

The JAX package runs every f32 product of the Newton algebra at
``Precision.HIGHEST``. On an NVIDIA card PyTorch may route f32 products
through TF32 tensor cores, which keep about 3 decimal digits: the
Newton-Schulz refinement and the per-solve refinement sweeps then lose
that much of the preconditioner. The port sets full f32 explicitly and
the solver asserts it where it starts.
"""
from __future__ import annotations

import torch


def set_precision_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def assert_precision_policy() -> None:
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 matmuls are enabled; the solver needs full-f32 products "
            "(call kinetica_tpu_torch.precision.set_precision_policy())")
