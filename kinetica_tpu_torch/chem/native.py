"""Build and load the port's host-side native code (``csrc/host/``).

Two C++ sources are copied from the JAX package into
``kinetica_tpu_torch/csrc/host/``: ``chemlite.cpp`` (bond perception and
Morgan ranks, loaded here with ctypes) and ``cde_lite.cpp`` (the reaction
sampler executable, see :mod:`kinetica_tpu_torch.exploration.cde_lite`).
Each is compiled with ``g++ -O3`` at first use into the git-ignored
``kinetica_tpu_torch/_build/``, under a name that carries a hash of the
source and the flags (as :mod:`kinetica_tpu_torch.ops.cuda_build` names
the kernels), so an edited source is rebuilt and nothing is ever written
elsewhere. Without a compiler the chem layer degrades to its pure-Python
implementations, as the JAX package's does: this is host code, not the
device path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..utils.logging import logger

_PKG = Path(__file__).resolve().parents[1]
HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
SHARED_FLAGS = ["-O3", "-shared", "-fPIC"]
EXEC_FLAGS = ["-O3"]

_lib = None
_tried = False
#: path of the loaded chem-lite library (None until it loaded)
lib_path: Path | None = None


def build_host(source: str, stem: str, flags: list[str], suffix: str = "",
               force: bool = False) -> Path | None:
    """Compile ``csrc/host/<source>`` into ``_build/<stem>-<hash><suffix>`` if
    needed (always with ``force``); the output path, or None when ``g++``
    is missing or fails."""
    src = HOST_SRC / source
    text = src.read_bytes()
    digest = hashlib.sha256(text + b"\0" + " ".join(flags).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"{stem}-{digest}{suffix}"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{stem}-")
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, "-o", tmp, str(src)], check=True,
                       capture_output=True, timeout=300)
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)     # atomic: a half-written file is never seen
        return out
    except Exception as exc:
        logger.warning("native build of %s failed: %s", source, exc)
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried, lib_path
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build_host("chemlite.cpp", "libchemlite", SHARED_FLAGS, ".so")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.chemlite_perceive_bonds.restype = ctypes.c_int
        lib.chemlite_perceive_bonds.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int]
        lib.chemlite_morgan_ranks.restype = None
        lib.chemlite_morgan_ranks.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        _lib, lib_path = lib, path
    except OSError as exc:
        logger.debug("chemlite native load failed: %s", exc)
        _lib = None
    return _lib


def perceive_bonds_native(pos: np.ndarray, radii: np.ndarray,
                          tol: float) -> np.ndarray | None:
    """(n, 3) positions + covalent radii -> (m, 2) bonded index pairs."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(radii)
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    radii = np.ascontiguousarray(radii, dtype=np.float64)
    cap = max(64, 8 * n)
    while True:
        out = np.empty((cap, 2), dtype=np.int32)
        m = lib.chemlite_perceive_bonds(
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            radii.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, float(tol),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if m <= cap:
            return out[:m].copy()
        cap = m + 16


def morgan_ranks_native(init_inv: np.ndarray, bond_a: np.ndarray,
                        bond_b: np.ndarray,
                        bond_order: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    n = len(init_inv)
    init_inv = np.ascontiguousarray(init_inv, dtype=np.int64)
    bond_a = np.ascontiguousarray(bond_a, dtype=np.int32)
    bond_b = np.ascontiguousarray(bond_b, dtype=np.int32)
    bond_order = np.ascontiguousarray(bond_order, dtype=np.int32)
    out = np.empty(n, dtype=np.int32)
    lib.chemlite_morgan_ranks(
        n, init_inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(bond_a),
        bond_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bond_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bond_order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
