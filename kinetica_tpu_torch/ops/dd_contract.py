"""f64 contraction du = r @ N: kernel 3 of the port (``csrc/dd_contract.cu``).

Counterpart of ``kinetica_tpu/ops/pallas_matmul.py::DDContraction``
(kernel ``_dd_chunk_kernel``), the ``rhs_contraction="dd"`` choice: the
rates r (B, nr) are computed outside the kernel and contracted with the
stoichiometry, du[b, s] = sum_j r[b, j] N[j, s]. The reference emulates
f64 with three f32 slices and TwoSum on the TPU; the port sums native
f64 (~1e-16 relative to sum_j |N_js r_j|).

Differences from the reference, on purpose (as in
:mod:`~kinetica_tpu_torch.ops.fused_rhs`): any real N is accepted, where
the reference rejects |N| > 7 and non-integer N; a per-lane N is rejected
with ``ValueError``, where the reference's vmap rule silently used lane 0.

The transposed stoichiometry is stored as CSR rows per species ordered
by reaction (:func:`species_csr`); the kernel and
:mod:`~kinetica_tpu_torch.ops.fused_rhs` sum those rows in that order.
On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs :func:`dd_contract_plain`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import check_launch, load_library
from .grid_probe import ensure_grid_supported

# kernel launches since the last reset (the plain path never counts)
launches = 0
# the shared memory one block may hold on an H100 (the kernels stage a
# lane's rates there)
MAX_SMEM = 227 * 1024


def check_smem(nbytes: int, name: str) -> None:
    """Raise where a lane's staged values exceed a block's shared memory."""
    if nbytes > MAX_SMEM:
        raise ValueError(
            f"{name}: a lane needs {nbytes / 1024:.1f} KB of shared memory, "
            f"above the {MAX_SMEM // 1024} KB a block holds on this card")


class SpeciesCSR(NamedTuple):
    """Nonzeros of N^T, row by row (species), each row ordered by reaction."""
    row_ptr: torch.Tensor    # (ns + 1,) int32
    rxn: torch.Tensor        # (nnz,) int32
    coef: torch.Tensor       # (nnz,) f64, N[rxn, species]
    species64: torch.Tensor  # (nnz,) int64, for the plain version
    rxn64: torch.Tensor      # (nnz,) int64


def species_csr(Nh: np.ndarray, device: torch.device) -> SpeciesCSR:
    """CSR rows of N^T for the (nr, ns) f64 host stoichiometry ``Nh``."""
    ns = Nh.shape[1]
    sp, rx = np.nonzero(Nh.T)            # row-major: by species, then reaction
    i32 = dict(dtype=torch.int32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    return SpeciesCSR(
        row_ptr=torch.as_tensor(
            np.concatenate([[0], np.cumsum(np.bincount(sp, minlength=ns))]),
            **i32),
        rxn=torch.as_tensor(rx, **i32),
        coef=torch.as_tensor(Nh[rx, sp], dtype=torch.float64, device=device),
        species64=torch.as_tensor(sp, **i64),
        rxn64=torch.as_tensor(rx, **i64))


def host_stoichiometry(N) -> np.ndarray:
    """A writable (nr, ns) f64 host copy of N; a per-lane N is an error."""
    if isinstance(N, torch.Tensor):
        N = N.detach().cpu().numpy()
    Nh = np.array(N, dtype=np.float64)
    if Nh.ndim != 2:
        raise ValueError(
            "one network for all lanes: N must be (nr, ns), got "
            f"{Nh.shape} (per-lane stoichiometry is not supported)")
    return Nh


def dd_contract_plain(r: torch.Tensor, csr: SpeciesCSR, ns: int) -> torch.Tensor:
    """``index_add_`` of r[:, rxn] * coef into the species, in r's dtype."""
    du = torch.zeros(r.shape[0], ns, dtype=r.dtype, device=r.device)
    return du.index_add_(1, csr.species64, r[:, csr.rxn64] * csr.coef)


class DDContraction:
    """``r -> r @ N`` for one stoichiometry matrix, built once on one device."""

    def __init__(self, N, device):
        Nh = host_stoichiometry(N)
        self.nr, self.ns = Nh.shape
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_smem(8 * self.nr, "dd_contract")
        ensure_grid_supported(self.device)
        self.csr = species_csr(Nh, self.device)

    def _check(self, r: torch.Tensor) -> None:
        if r.dtype != torch.float64:
            raise TypeError(f"dd_contract: r must be float64, got {r.dtype}")
        if r.ndim != 2 or r.shape[1] != self.nr:
            raise ValueError(f"dd_contract: r must be (B, {self.nr}), "
                             f"got {tuple(r.shape)}")
        if not r.is_contiguous():
            raise ValueError("dd_contract: r must be contiguous")
        if r.device != self.device:
            raise ValueError(f"dd_contract: r is on {r.device}, the network "
                             f"on {self.device}")

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """(B, nr) f64 rates -> (B, ns) f64 du."""
        self._check(r)
        if r.device.type == "cpu":
            return dd_contract_plain(r, self.csr, self.ns)
        if r.device.type != "cuda":
            raise ValueError(f"dd_contract: unsupported device {r.device}")
        global launches
        du = torch.empty(r.shape[0], self.ns, dtype=torch.float64,
                         device=r.device)
        if r.shape[0] == 0:
            return du
        err = _library().dd_contract_launch(
            r.data_ptr(), self.csr.row_ptr.data_ptr(), self.csr.rxn.data_ptr(),
            self.csr.coef.data_ptr(), du.data_ptr(), r.shape[0], self.ns,
            self.nr, torch.cuda.current_stream(r.device).cuda_stream)
        check_launch(err, "dd_contract")
        launches += 1
        return du

    def plain(self, r: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version on any device (for comparisons)."""
        self._check(r)
        return dd_contract_plain(r, self.csr, self.ns)


def _library() -> ctypes.CDLL:
    lib = load_library("dd_contract")
    fn = lib.dd_contract_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
