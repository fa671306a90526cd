"""Start-up grid probe: kernel 5 of the port (``csrc/grid_probe.cu``).

Counterpart of the probe kernel ``k`` in
``kinetica_tpu/ops/pallas_matmul.py::fused_grid_supported``: an (8, 128)
f32 block of ones is added into one zeroed output by a grid of 2 blocks,
and every element must come out as 2.0 (within 1e-6). The reference runs
it once per process, from the constructor of its fused RHS, on every
accelerator (never on the CPU), and falls back to the scan form of that
kernel when it fails.

The port has one form of each kernel, so there is nothing to fall back
to: :func:`ensure_grid_supported` raises ``RuntimeError`` naming the card
when the probe fails. The constructors of
:class:`~kinetica_tpu_torch.ops.fused_rhs.FusedMassActionRHS` and
:class:`~kinetica_tpu_torch.ops.dd_contract.DDContraction` and the
wrapper :func:`~kinetica_tpu_torch.ops.newton_solve.fused_newton_solve`
call it on a CUDA device. A passed probe is cached for the process.

On a CUDA tensor :func:`grid_probe` launches the kernel or raises; on a
CPU tensor it runs :func:`grid_probe_plain`. It has no forward-mode rule:
a dual input raises ``RuntimeError``.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, load_library
from .jvp import refuse_tangent

ROWS, COLS, BLOCKS = 8, 128, 2
TOL = 1e-6

# kernel launches since the last reset (the plain path never counts)
launches = 0
# set once the probe has passed in this process
passed = False


def grid_probe_plain(x: torch.Tensor, blocks: int = BLOCKS) -> torch.Tensor:
    """``blocks`` additions of ``x`` into a zeroed output."""
    out = torch.zeros_like(x)
    for _ in range(blocks):
        out += x
    return out


def grid_probe(x: torch.Tensor, blocks: int = BLOCKS) -> torch.Tensor:
    """A grid of ``blocks`` blocks, each adding f32 ``x`` into one output."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("grid_probe: x must be contiguous float32")
    refuse_tangent("grid_probe", x)
    if x.device.type == "cpu":
        return grid_probe_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"grid_probe: unsupported device {x.device}")
    global launches
    out = torch.zeros_like(x)
    err = _library().grid_probe_launch(
        x.data_ptr(), out.data_ptr(), x.numel(), blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "grid_probe")
    launches += 1
    return out


def _run(device: torch.device) -> torch.Tensor:
    x = torch.ones(ROWS, COLS, dtype=torch.float32, device=device)
    return grid_probe(x).cpu()


def _card_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device)


def ensure_grid_supported(device) -> None:
    """Run the probe once per process on a CUDA device; raise if it fails."""
    global passed
    device = torch.device(device)
    if device.type != "cuda" or passed:
        return
    out = _run(device)
    worst = float((out - float(BLOCKS)).abs().max())
    if not worst <= TOL:
        raise RuntimeError(
            f"grid probe failed on {_card_name(device)}: a {BLOCKS}-block "
            f"grid accumulating into one output is off by {worst:.3e} "
            f"(tolerance {TOL}); the port's kernels cannot run on this card")
    passed = True


def _library() -> ctypes.CDLL:
    lib = load_library("grid_probe")
    fn = lib.grid_probe_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
