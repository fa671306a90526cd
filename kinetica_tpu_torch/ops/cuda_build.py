"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C launch function,
which may include headers of ``csrc/`` (``#include "x.cuh"``). It is
compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library
under ``kinetica_tpu_torch/_build/`` and loaded with ``ctypes``. The
library's file name carries a hash of the source, the headers it includes
and the flags, so an edited source or header is rebuilt and a stale
library is never loaded. Nothing here runs at import time: the CPU tests
import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when cached), "ptxas": log}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, the ``csrc/`` headers it includes (and
    theirs) and the flags."""
    h = hashlib.sha256()
    todo, seen = [f"{name}.cu"], set()
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = (CSRC / path).read_bytes()
        h.update(path.encode() + b"\0" + text + b"\0")
        todo.extend(m.decode() for m in _INCLUDE.findall(text))
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    so = BUILD_DIR / f"lib{name}-{source_digest(name)}.so"
    info = {"seconds": 0.0, "ptxas": ""}
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so",
                                         delete=False) as tmp:
            tmp_path = tmp.name
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp_path, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp_path)
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp_path, so)      # atomic: a half-written .so is never seen
        info = {"seconds": time.perf_counter() - t0, "ptxas": proc.stderr}
    build_info[name] = info
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib


def load_libraries(names) -> list[ctypes.CDLL]:
    """Build several kernels at once (one ``nvcc`` each) and load them."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return list(pool.map(load_library, names))


def check_launch(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
