"""The least time an operation can take on the card: the yardstick of
every ``*_roofline`` metric.

Frozen copy of ``kinetica_tpu_torch/testing/device_timing.py``'s
``bound``, ``rhs_work``, ``solve_work``, ``inverse_work`` and its peaks at
commit 55f0abe3ef2893a2eb2dbb1a91147263e5f51748, rewritten to take the
operation's shapes (lanes, species, reactions, nonzeros) in place of the
program's objects, so that a later kernel that replaces today's is judged
on the same work. The peaks are NVIDIA's H100 SXM data sheet (dense,
outside the tensor cores) at its 700 W limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}


def bound_s(nbytes: float, flops: float, kind: str) -> float:
    """The least seconds for the work: the larger of bytes over the memory
    rate and operations over the peak rate of their type."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind])


def rhs_work(lanes: int, ns: int, nr: int, arity: int, nnz: int):
    """(bytes, f64 flops) of one mass-action right-hand side over ``lanes``
    lanes: u (with its constant entry), k and du read or written once, the
    network once (slots int32, CSR row pointers int32, entries int32 index
    and f64 coefficient); ``arity`` products a rate, 2 flops a nonzero of
    the stoichiometry."""
    net = nr * arity * 4 + (ns + 1) * 4 + nnz * 12
    return ((lanes * (ns + 1) + lanes * nr + lanes * ns) * 8 + net,
            lanes * (arity * nr + 2.0 * nnz))


def solve_work(lanes: int, n: int, sweeps: int = 4):
    """(bytes, f32 flops) of one Newton solve with the explicit inverse:
    M and J (f32) read once, b, c and dy (f64) once; dy = M b and up to
    ``sweeps`` refinement sweeps of two matvecs. The bytes bound it even
    at the most sweeps, so the bound holds whatever sweeps the lanes
    took."""
    return (2 * lanes * n * n * 4 + (2 * lanes * n + lanes) * 8,
            2.0 * lanes * n * n * (1 + 2 * sweeps))


def inverse_work(lanes: int, n: int):
    """(bytes, f32 flops) of ``lanes`` inverses of n x n: A read and M
    written once; the 2 n^3 flops of Gauss-Jordan."""
    return 2 * lanes * n * n * 4, 2.0 * lanes * n ** 3
