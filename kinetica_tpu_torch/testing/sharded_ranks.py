"""Run sharded ensemble cases over spawned ranks of ``torch.distributed``.

The tests (on the CPU) and ``chip_smoke.py`` (on the card) both drive the
sharded :class:`~kinetica_tpu_torch.parallel.batching.EnsembleProblem`
through :class:`Ranks`: it starts ``world`` processes from the ``spawn``
context, each of which joins a gloo process group over a file store in a
fresh temporary directory (no fixed port, so concurrent runs never meet),
builds the meshes its cases name and runs :func:`run_cases`; the caller
gets every rank's numpy results back. The code a rank runs lives here,
in a module that imports neither jax nor a test module.

A case is a plain dict (it crosses the process boundary by pickle)::

    {"name": "fused", "network": 8 | "pyrolysis6", "rates": [...],
     "X0": 500.0, "tf": 3.0, "chunk": 1.0, "ts_update": 0.5 | None,
     "u0": {"C8": 1.0}, "pars": {...ODESimulationParams keywords},
     "rate_mode": "discrete", "nr_multiple": 1,
     "mesh": ((2, 2), ("batch", "model")) | None,      # constructor mesh
     "sharding": ((2, 2), ("batch", "model")) | None,  # solve()'s mesh
     "batch": None | n (solve the first n members),
     "check_kernels": False, "expect_error": False,
     "fail_rank": None | r (rank r raises before the case: the others
                  must not hang)}
"""
from __future__ import annotations

import ctypes
import datetime
import importlib
import logging
import multiprocessing
import os
import queue
import shutil
import signal
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

K_MAX = 1e12


def six_reaction_pyrolysis():
    """The 6-species, 6-reaction methane pyrolysis network of the JAX
    package's ``tests/test_parallel.py``: (sd, rd, Ea, A)."""
    from ..core.network import RxData, SpeciesData
    sd = SpeciesData(["C", "[H]", "[CH3]", "[H][H]", "CC", "C=C"])
    rd = RxData.from_reactions(
        sd,
        reacs=[["C"], ["[CH3]", "[H]"], ["C", "[H]"], ["[CH3]", "[CH3]"],
               ["CC"], ["CC"]],
        prods=[["[CH3]", "[H]"], ["C"], ["[CH3]", "[H][H]"], ["CC"],
               ["C=C", "[H][H]"], ["[CH3]", "[CH3]"]])
    Ea = np.array([3.6e5, 0.0, 4.0e4, 0.0, 3.2e5, 3.5e5])
    A = np.array([1e-8, 1e-12, 1e-13, 1e-12, 1e-7, 1e-8])
    return sd, rd, Ea, A


def ramp_problem(case: dict, device):
    """(method, sd, rd, conditions) of a case: linear ramps from
    ``case["X0"]`` at each of ``case["rates"]`` K/s over ``case["tf"]``."""
    from ..calculators.builtin import PrecalculatedArrheniusCalculator
    from ..conditions.condition_set import ConditionSet
    from ..conditions.profiles import LinearGradientProfile
    from ..solving.methods import VariableODESolve
    from ..solving.params import ODESimulationParams
    from .synthetic import synthetic_pyrolysis_network

    if case["network"] == "pyrolysis6":
        sd, rd, Ea, A = six_reaction_pyrolysis()
    else:
        sd, rd, Ea, A = synthetic_pyrolysis_network(int(case["network"]))
    tf, X0 = float(case["tf"]), float(case["X0"])
    conds = [ConditionSet({"T": LinearGradientProfile(
        rate=float(r), X_start=X0, X_end=X0 + float(r) * tf)},
        ts_update=case.get("ts_update")) for r in case["rates"]]
    pars = ODESimulationParams(
        tspan=(0.0, tf), u0=dict(case["u0"]), solve_chunks=True,
        solve_chunkstep=float(case["chunk"]), low_k_cutoff="none",
        **case.get("pars", {}))
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=K_MAX, device=device)
    return VariableODESolve(pars, conds[0], calc), sd, rd, conds


class _Counters:
    """The kernels' launch counts, host syncs and all_reduces of a run."""

    NAMES = ("fused_rhs", "gj_inverse", "dd_contract", "newton_solve",
             "grid_probe")

    def __init__(self):
        from ..ops import host_sync
        from ..parallel import sharding
        self.mods = {n: importlib.import_module(f"..ops.{n}", __package__)
                     for n in self.NAMES}
        self.host_sync, self.sharding = host_sync, sharding

    def reset(self):
        for mod in self.mods.values():
            mod.launches = 0
        self.mods["grid_probe"].passed = False
        self.host_sync.count = 0
        self.sharding.all_reduces = 0
        self.sharding.all_reduce_seconds = 0.0

    def read(self):
        return {"launches": {n: m.launches for n, m in self.mods.items()},
                "host_syncs": self.host_sync.count,
                "all_reduces": self.sharding.all_reduces,
                "all_reduce_s": self.sharding.all_reduce_seconds}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_block_kernels(prob, B: int, rng) -> dict:
    """This rank's fused RHS and contraction built on its reaction block,
    against their plain versions at the shard's shape (its member block,
    nr_loc reactions): max |d| / sum_j |N_js r_j| of each."""
    from ..models.mass_action import augment
    from ..ops.dd_contract import DDContraction
    from ..ops.fused_rhs import FusedMassActionRHS
    lo, hi = prob.block
    net_l = prob.net.block(lo, hi)
    dev = prob.device
    u = torch.as_tensor(10.0 ** rng.uniform(-14, 0, (B, net_l.ns)),
                        device=dev)
    k = torch.as_tensor(10.0 ** rng.uniform(-3, 12, (B, net_l.nr)),
                        device=dev)
    u_aug = augment(u, net_l.delta).contiguous()
    r = net_l.rates(u, k).contiguous()
    scale = (r.abs() @ net_l.N.abs()).clamp(min=1e-300)
    fused = FusedMassActionRHS(net_l.N, net_l.reac_slots, dev)
    dd = DDContraction(net_l.N, dev)
    out = {}
    for name, fn, plain in (("fused_rhs", lambda: fused(u_aug, k),
                             lambda: fused.plain(u_aug, k)),
                            ("dd_contract", lambda: dd(r),
                             lambda: dd.plain(r))):
        got = fn()
        _sync(dev)
        out[name] = float(((got - plain()).abs() / scale).max())
    out["shape"] = (B, net_l.nr, net_l.ns)
    return out


def run_cases(spec: dict) -> dict:
    """One rank's run of ``spec["cases"]`` -> {case name: results}.

    Results of a solve: ``u``, ``retcodes``, ``n_steps``, ``rank_spread``,
    ``nr`` and ``nr_pad`` of the problem, its wall seconds, the counters
    of :class:`_Counters`, and with ``check_kernels`` the block kernels
    against their plain versions. A case with ``expect_error`` returns the
    ``ValueError`` it raised (``{"error": message}``); any other exception
    fails the rank.
    """
    from ..parallel.batching import EnsembleProblem
    from ..parallel.sharding import make_mesh

    device_arg = spec.get("device", "cpu")
    timeout = datetime.timedelta(seconds=float(spec.get("timeout_s", 60)))
    meshes = {}

    def mesh_of(m):
        if m is None:
            return None
        key = (tuple(m[0]), tuple(m[1]))
        if key not in meshes:
            meshes[key] = make_mesh(axis_names=key[1], shape=key[0],
                                    device=None if device_arg == "cuda"
                                    else device_arg, timeout=timeout)
        return meshes[key]

    counters = _Counters()
    rng = np.random.default_rng(2024 + torch.distributed.get_rank())
    out = {}
    for case in spec["cases"]:
        if case.get("fail_rank") == torch.distributed.get_rank():
            raise RuntimeError(f"case {case['name']}: this rank fails on "
                               "purpose")
        ctor_mesh = mesh_of(case.get("mesh"))
        solve_mesh = mesh_of(case.get("sharding"))
        device = (ctor_mesh or solve_mesh).device
        method, sd, rd, conds = ramp_problem(case, device)
        if case.get("batch"):
            conds = conds[:case["batch"]]
        try:
            counters.reset()
            prob = EnsembleProblem(method, sd, rd,
                                   rate_mode=case.get("rate_mode", "discrete"),
                                   nr_multiple=case.get("nr_multiple", 1),
                                   mesh=ctor_mesh, device=device)
            _sync(device)
            t0 = time.perf_counter()
            ens = prob.solve(conditions_list=conds, sharding=solve_mesh)
            _sync(device)
            wall = time.perf_counter() - t0
        except ValueError as exc:
            if case.get("expect_error"):
                out[case["name"]] = {"error": str(exc)}
                continue
            raise
        if case.get("expect_error"):
            raise RuntimeError(f"case {case['name']}: no ValueError raised")
        res = {"u": ens.u, "retcodes": list(ens.retcodes),
               "n_steps": np.asarray(ens.stats["n_steps"]),
               "rank_spread": ens.stats["rank_spread"], "nr": prob.net.nr,
               "nr_pad": prob._nr_pad, "wall_s": wall,
               "block": getattr(prob, "block", None), **counters.read()}
        if case.get("check_kernels"):
            res["kernels"] = check_block_kernels(
                prob, len(conds) // solve_mesh.shape.get("batch", 1), rng)
        out[case["name"]] = res
    return out


def die_with_parent() -> None:
    """Have the kernel kill this process when the one that started it dies
    (``PR_SET_PDEATHSIG``; Linux only, a no-op elsewhere), so that a spawned
    rank or pool worker never outlives a parent that was killed."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)


def _rank_main(rank, world, store, timeout_s, spec, results):
    """A spawned rank: join the process group, run the cases, report."""
    die_with_parent()
    try:
        torch.set_num_threads(1)
        logging.getLogger("kinetica_tpu_torch").setLevel(logging.WARNING)
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, run_cases(spec)))
        finally:
            torch.distributed.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


class Ranks:
    """``world`` spawned ranks running :func:`run_cases` on ``spec``.

    Start them with ``with Ranks(world, spec) as ranks:``, do other work,
    and collect with ``ranks.wait()`` (a list of every rank's results, by
    rank). A rank that fails, dies or outlives ``spec["timeout_s"]`` (60 s
    by default, per collective; the whole run may take ``wait_s``) makes
    ``wait`` raise; leaving the block stops every rank still running.
    """

    def __init__(self, world: int, spec: dict, wait_s: float = 600.0):
        self.world, self.wait_s = world, wait_s
        self._dir = tempfile.mkdtemp(prefix="kinetica_ranks_")
        ctx = multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        timeout_s = float(spec.get("timeout_s", 60))
        self._procs = [ctx.Process(
            target=_rank_main, name=f"kinetica-rank-{r}",
            args=(r, world, os.path.join(self._dir, "store"), timeout_s, spec,
                  self._results)) for r in range(world)]
        for p in self._procs:
            p.start()

    def __enter__(self):
        return self

    def wait(self) -> list[dict]:
        got = {}
        deadline = time.monotonic() + self.wait_s
        while len(got) < self.world:
            try:
                rank, ok, payload = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.name for p in self._procs if p.exitcode not in
                        (None, 0)]
                if dead:
                    try:    # a failed rank's report may still be in flight
                        rank, ok, payload = self._results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"ranks died without a result: {dead}") from None
                    if not ok:
                        raise RuntimeError(f"rank {rank} failed:\n{payload}")
                    got[rank] = payload
                    continue
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks gave {len(got)} of {self.world}"
                                       f" results in {self.wait_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in self._procs:
            p.join(timeout=60)
        return [got[r] for r in range(self.world)]

    def __exit__(self, *exc):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=30)
        self._results.close()
        shutil.rmtree(self._dir, ignore_errors=True)
        return False


def run_ranks(world: int, spec: dict, wait_s: float = 600.0) -> list[dict]:
    """Run ``spec`` over ``world`` ranks and return their results."""
    with Ranks(world, spec, wait_s) as ranks:
        return ranks.wait()
