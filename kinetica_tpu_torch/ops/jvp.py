"""Forward-mode tangents at the kernel wrappers.

A kernel is launched through ctypes on ``data_ptr()``: it reads the
primal of a forward-mode dual tensor (``torch.autograd.forward_ad``) and
returns a fresh tensor with no tangent. So each wrapper that the
reference differentiates carries the reference's ``jax.custom_jvp`` rule
as the ``jvp`` of a ``torch.autograd.Function``, on the CUDA kernel and
on the plain CPU version alike (the JAX package applies its rule on
every backend):

* rule 1, the Gauss-Jordan and block-Schur inverses
  (:mod:`~kinetica_tpu_torch.ops.gj_inverse`);
* rule 2, the refined Newton factor (:mod:`~kinetica_tpu_torch.ops.linalg`);
* rule 3, the fused Newton solve (:mod:`~kinetica_tpu_torch.ops.newton_solve`);
* rule 4, the f64 contraction (:mod:`~kinetica_tpu_torch.ops.dd_contract`).

A wrapper without a rule (the fused RHS, the grid probe) raises on a
dual input instead of dropping its tangent.
"""
from __future__ import annotations

import torch
from torch.autograd import forward_ad


def has_tangent(*xs) -> bool:
    """True where any tensor among ``xs`` carries a forward-mode tangent."""
    return any(isinstance(x, torch.Tensor)
               and forward_ad.unpack_dual(x).tangent is not None for x in xs)


def refuse_tangent(name: str, *xs) -> None:
    """Raise where a kernel without a forward-mode rule meets a tangent."""
    if has_tangent(*xs):
        raise RuntimeError(
            f"{name}: the kernel has no forward-mode rule and would drop the "
            "tangent of a dual input (the reference registers none either); "
            "differentiate the plain version instead")


def inverse_tangent(M: torch.Tensor, dA: torch.Tensor | None) -> torch.Tensor:
    """d(A^-1) = -M dA M in M's dtype (the reference's rules 1 and 2)."""
    if dA is None:
        return torch.zeros_like(M)
    return -(M @ dA.to(M.dtype) @ M)
