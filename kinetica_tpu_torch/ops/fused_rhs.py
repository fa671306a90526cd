"""Fused mass-action RHS: kernel 1 of the port (``csrc/fused_rhs.cu``).

Counterpart of ``kinetica_tpu/ops/pallas_matmul.py::FusedMassActionRHS``
(kernels ``_fused_grid_kernel`` / ``_fused_scan_kernel``). For each lane b

    du[b, s] = sum_j N[j, s] * k[b, j] * prod_slot u_aug[b, slot[j, slot]]

with ``u_aug = [clip_pos(u), 1]`` built by the caller. The reference
computes this in double-f32 pairs on the TPU; the port uses native f64,
which reaches the reference's accuracy (~2^-45 relative to the largest
term) without the pair arithmetic.

Differences from the reference, on purpose:

* any real stoichiometry is accepted. The reference rejects |N| > 7 and
  non-integer N (its exact sliced products need small integers); native
  f64 needs neither.
* per-lane stoichiometry is rejected with ``ValueError``. The reference's
  vmap rule silently used lane 0's network (``pallas_matmul.py:593-596``).
* the constructor runs the grid probe (:mod:`.grid_probe`) on a CUDA
  device, as the reference's does on an accelerator, and raises where
  the reference would fall back to its scan form.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs :func:`fused_rhs_plain`, the plain PyTorch version of the
same function. The reference registers no forward-mode rule for this
kernel, so a dual input raises ``RuntimeError`` on either device rather
than losing its tangent (the sensitivity solve uses the plain dot).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import check_launch, load_library
from .dd_contract import (SpeciesCSR, check_smem, dd_contract_plain,
                          host_stoichiometry, species_csr)
from .grid_probe import ensure_grid_supported
from .jvp import refuse_tangent

# kernel launches since the last reset (the plain path never counts)
launches = 0


def fused_rhs_plain(u_aug: torch.Tensor, k: torch.Tensor, slots: torch.Tensor,
                    csr: SpeciesCSR, ns: int) -> torch.Tensor:
    """Gather and product, then the contraction's ``index_add_``."""
    return dd_contract_plain(k * u_aug[:, slots].prod(dim=-1), csr, ns)


class FusedMassActionRHS:
    """The network description of one CRN, built once, on one device.

    ``N`` (nr, ns) and ``reac_slots`` (nr, arity) are numpy arrays or
    tensors; slot index ``ns`` is the constant-1 entry of ``u_aug``. The
    transposed stoichiometry is stored as CSR rows per species, ordered by
    reaction, which fixes the kernel's summation order.
    """

    def __init__(self, N, reac_slots, device):
        Nh = host_stoichiometry(N)
        slots = _host_array(reac_slots, np.int64)
        if slots.ndim != 2:
            raise ValueError(
                "fused_rhs takes one network for all lanes: reac_slots must "
                f"be (nr, arity), got {slots.shape} (per-lane stoichiometry "
                "is not supported)")
        nr, ns = Nh.shape
        if slots.shape[0] != nr:
            raise ValueError("reac_slots/N reaction count mismatch")
        if slots.size and (slots.min() < 0 or slots.max() > ns):
            raise ValueError("reac_slots entries must lie in [0, ns]")
        self.nr, self.ns, self.arity = nr, ns, slots.shape[1]
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_smem(8 * (ns + 1 + nr), "fused_rhs")
        ensure_grid_supported(self.device)
        self.slots = torch.as_tensor(slots, dtype=torch.int32,
                                     device=self.device).contiguous()
        self.csr = species_csr(Nh, self.device)
        # int64 copy for the plain version's indexing
        self._slots64 = self.slots.long()

    def _check(self, u_aug: torch.Tensor, k: torch.Tensor) -> None:
        for name, x, width in (("u_aug", u_aug, self.ns + 1), ("k", k, self.nr)):
            if x.dtype != torch.float64:
                raise TypeError(f"fused_rhs: {name} must be float64, got {x.dtype}")
            if x.ndim != 2 or x.shape[1] != width:
                raise ValueError(f"fused_rhs: {name} must be (B, {width}), "
                                 f"got {tuple(x.shape)}")
            if not x.is_contiguous():
                raise ValueError(f"fused_rhs: {name} must be contiguous")
            if x.device != self.device:
                raise ValueError(f"fused_rhs: {name} is on {x.device}, the "
                                 f"network on {self.device}")
        if u_aug.shape[0] != k.shape[0]:
            raise ValueError("fused_rhs: u_aug and k batch sizes differ")

    def __call__(self, u_aug: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """(B, ns+1) f64 clipped-augmented u and (B, nr) f64 k -> (B, ns) f64."""
        self._check(u_aug, k)
        refuse_tangent("fused_rhs", u_aug, k)
        if u_aug.device.type == "cpu":
            return fused_rhs_plain(u_aug, k, self._slots64, self.csr, self.ns)
        if u_aug.device.type != "cuda":
            raise ValueError(f"fused_rhs: unsupported device {u_aug.device}")
        global launches
        lib = _library()
        du = torch.empty(u_aug.shape[0], self.ns, dtype=torch.float64,
                         device=u_aug.device)
        if u_aug.shape[0] == 0:
            return du
        err = lib.fused_rhs_launch(
            u_aug.data_ptr(), k.data_ptr(), self.slots.data_ptr(),
            self.csr.row_ptr.data_ptr(), self.csr.rxn.data_ptr(),
            self.csr.coef.data_ptr(), du.data_ptr(), u_aug.shape[0], self.ns,
            self.nr, self.arity,
            torch.cuda.current_stream(u_aug.device).cuda_stream)
        check_launch(err, "fused_rhs")
        launches += 1
        return du

    def plain(self, u_aug: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version on any device (for comparisons)."""
        self._check(u_aug, k)
        return fused_rhs_plain(u_aug, k, self._slots64, self.csr, self.ns)


def _host_array(x, dtype) -> np.ndarray:
    """A writable host copy of a numpy array, jax array or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=dtype)


def _library() -> ctypes.CDLL:
    lib = load_library("fused_rhs")
    fn = lib.fused_rhs_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
