"""Subprocess pool and environment helpers for CDE runs.

Same capability as Julia reference src/exploration/cde_utils.jl: a bounded
concurrent command pool (`parallel_run`, cde_utils.jl:6-19) and OMP/MKL
thread environment setup for xTB inside CDE (cde_utils.jl:31-52).
"""
from __future__ import annotations

import os
import subprocess
from concurrent.futures import ThreadPoolExecutor


def env_multithread(nthreads: int) -> dict:
    """Copy of the environment with OMP/MKL thread counts set."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = str(nthreads)
    env["MKL_NUM_THREADS"] = str(nthreads)
    env["MKL_DYNAMIC"] = "FALSE"
    return env


def parallel_run(commands: list[dict], ntasks: int = 1) -> list[int]:
    """Run shell commands concurrently, at most ``ntasks`` at a time.

    Each command is a dict of ``subprocess.run`` kwargs (args, cwd, env,
    stdout, stderr paths). Returns the list of return codes in order.
    """
    def run_one(spec: dict) -> int:
        stdout_path = spec.get("stdout")
        stderr_path = spec.get("stderr")
        stdout = open(stdout_path, "w") if stdout_path else subprocess.DEVNULL
        stderr = open(stderr_path, "w") if stderr_path else subprocess.DEVNULL
        try:
            proc = subprocess.run(
                spec["args"], cwd=spec.get("cwd"), env=spec.get("env"),
                stdout=stdout, stderr=stderr)
            return proc.returncode
        finally:
            for fh in (stdout, stderr):
                if fh not in (subprocess.DEVNULL,):
                    try:
                        fh.close()
                    except Exception:
                        pass

    with ThreadPoolExecutor(max_workers=max(1, ntasks)) as pool:
        return list(pool.map(run_one, commands))
