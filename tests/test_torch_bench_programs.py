"""The port's measurement programs against the JAX side's, on the CPU.

``kinetica_tpu_torch.scripts.bench`` and ``.bench_bsweep`` driven through
their ``main`` with ``--device cpu`` at ``KINETICA_BENCH_NC=6``,
``KINETICA_BENCH_BATCH=4`` (108 reactions, 19 species, the 14 s ramps of
``bench.py``):

* the JSON keys are the JAX program's, read from its source (``bench.py``,
  ``scripts/bench_bsweep.py``); the port's bench adds only the keys its
  docstring names to ``extra``;
* the bench's member 0 agrees with the JAX package's ``EnsembleProblem``
  solve of ``bench.py``'s own ``build()`` (x64, its CPU defaults: the
  plain f64 dot and LU, no Pallas kernel on that path) within 1e-6 in mole
  fraction (two solvers at rtol 1e-8 / atol 1e-10 with different linear
  algebra), and holds its own 1e-6 gate against scipy-BDF;
* every one of the five programs, run as ``python -m`` without a CUDA
  device and without ``--device cpu``, exits non-zero and prints no
  result;
* no run changes the JAX side's ``scripts/bsweep_results.jsonl`` or
  ``scripts/explore_results.jsonl`` (their hashes before and after), and
  ``--out`` refuses a path there.
"""
import ast
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = {"KINETICA_BENCH_NC": "6", "KINETICA_BENCH_BATCH": "4"}
PROGRAMS = ("bench", "bench_bsweep", "bench_longhorizon", "bench_explore",
            "step_count_audit")
JAX_RECORDS = ("scripts/bsweep_results.jsonl", "scripts/explore_results.jsonl")
# the keys the port's bench adds to ``extra``
BENCH_EXTRA = {"compile_s", "repeats", "sweep_s", "per_profile_ms_min",
               "per_profile_ms_max", "device"}


def record_hashes():
    return {p: hashlib.sha256((REPO / p).read_bytes()).hexdigest()
            for p in JAX_RECORDS}


@pytest.fixture(autouse=True)
def jax_records_untouched():
    before = record_hashes()
    yield
    assert record_hashes() == before


def dict_keys(path, func, target):
    """The keys of the dict literal assigned to ``target`` in ``func`` of
    the JAX program at ``path``."""
    tree = ast.parse((REPO / path).read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and ast.unparse(node.targets[0]) == target):
            return [k.value for k in node.value.keys]
    raise LookupError(f"no dict assigned to {target} in {path}:{func}")


def printed_json(capsys):
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def bench_run():
    """The port's bench through its ``main`` (the sweep's ensemble kept),
    and the JAX package's ensemble solve of ``bench.py``'s ``build()``."""
    from kinetica_tpu.parallel.batching import EnsembleProblem
    from kinetica_tpu.solving.methods import VariableODESolve
    from kinetica_tpu_torch.scripts import bench

    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  REPO / "bench.py")
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    jax_bench.N_CARBONS, jax_bench.BATCH = 6, 4
    sd, rd, calc, conds, pars = jax_bench.build()
    jax_ens = EnsembleProblem(VariableODESolve(pars, conds[0], calc), sd, rd,
                              rate_mode="continuous",
                              chunk_mode="auto").solve(conditions_list=conds)

    kept = {}
    timed = bench.timed_sweeps

    def keep(*args, **kw):
        out = timed(*args, **kw)
        kept["ens"] = out[0]
        return out

    with pytest.MonkeyPatch.context() as mp:
        for k, v in SMALL.items():
            mp.setenv(k, v)
        mp.setattr(bench, "timed_sweeps", keep)
        before = record_hashes()
        record = bench.main(["--device", "cpu", "--repeats", "2"])
        assert record_hashes() == before
    return record, kept["ens"], jax_ens


def test_bench_keys_are_bench_py_keys(bench_run):
    record, _, _ = bench_run
    assert list(record) == dict_keys("bench.py", "main", "out") + ["extra"]
    extra_ref = dict_keys("bench.py", "main", "out['extra']")
    assert list(record["extra"])[:len(extra_ref)] == extra_ref
    assert set(record["extra"]) - set(extra_ref) == BENCH_EXTRA


def test_bench_values(bench_run):
    record, ens, _ = bench_run
    ex = record["extra"]
    assert ex["crn"] == "108rxn/19sp" and ex["batch"] == 4
    assert ex["platform"] == "cpu" and ex["device"] == "cpu"
    assert ex["chunk_mode"] == "async" and ex["repeats"] == 2
    assert ex["max_molefrac_err"] <= 1e-6
    assert len(ex["sweep_s"]) == 2
    assert ex["per_profile_ms_min"] <= ex["per_profile_ms"] \
        <= ex["per_profile_ms_max"]
    assert ex["per_profile_ms"] == pytest.approx(
        np.median(ex["sweep_s"]) * 1e3 / 4)
    steps = np.asarray(ens.stats["n_steps"])
    assert (ex["steps_max"], ex["steps_median"]) == (int(steps.max()),
                                                     int(np.median(steps)))
    assert record["value"] == record["vs_baseline"] == pytest.approx(
        ex["cpu_baseline_s"] / (ex["per_profile_ms"] / 1e3))


def test_bench_member0_matches_jax_ensemble(bench_run):
    _, ens, jax_ens = bench_run
    assert ens.success and jax_ens.success
    ref = np.asarray(jax_ens.u[0, -1])
    err = np.max(np.abs(ens.u[0, -1] - ref) / max(ref.sum(), 1.0))
    assert err <= 1e-6


def test_bench_gate_raises(monkeypatch):
    """A member 0 off scipy-BDF by more than 1e-6 fails the run."""
    from kinetica_tpu_torch.scripts import bench
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "cpu_baseline_seconds",
                        lambda *a, **k: (1.0, np.zeros(19)))
    monkeypatch.setattr(bench, "timed_sweeps", _fake_sweeps)
    with pytest.raises(RuntimeError, match="accuracy gate failed"):
        bench.main(["--device", "cpu", "--repeats", "1"])


def _fake_sweeps(problem, conditions_list, device, repeats):
    class Ens:
        u = np.full((4, 29, 19), 1e-3)
        stats = {"n_steps": np.array([10, 10, 10, 10])}
    return Ens(), 1.0, [1.0] * repeats


def test_bench_chunk_mode_must_be_async(monkeypatch):
    from kinetica_tpu_torch.scripts import bench
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("KINETICA_BENCH_CHUNK_MODE", "scan")
    sd, rd, calc, conds, pars = bench.build("cpu")
    with pytest.raises(ValueError, match="chunk_mode 'scan'"):
        bench.ensemble(sd, rd, calc, conds, pars, torch.device("cpu"))


def test_bsweep_keys_and_out(monkeypatch, capsys, tmp_path):
    from kinetica_tpu_torch.scripts import bench_bsweep
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "bsweep.jsonl"
    records = bench_bsweep.main(["4", "--device", "cpu", "--out", str(out)])
    assert printed_json(capsys) == records
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == records
    rec, = records
    assert list(rec) == dict_keys("scripts/bench_bsweep.py", "run_batch",
                                  "rec")
    assert rec["batch"] == 4 and rec["crn"] == "108rxn/19sp"
    assert rec["platform"] == "cpu" and rec["mem"] == {}
    assert rec["linsolve"] == "auto" and rec["chunk_mode"] == "async"
    assert rec["profiles_per_sec"] == pytest.approx(4 / rec["sweep_s"])
    assert rec["ms_per_step"] == pytest.approx(rec["sweep_s"] * 1e3
                                               / rec["steps_max"])


@pytest.mark.parametrize("path", JAX_RECORDS)
def test_out_refuses_the_jax_records(path):
    from kinetica_tpu_torch.scripts import bench
    with pytest.raises(ValueError, match="JAX side's scripts/"):
        bench.append_json(REPO / path, {"batch": 4})


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_without_a_card_exits_nonzero(name):
    """The default device is the card: without one the program raises
    before it solves anything, and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **SMALL)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m",
                        f"kinetica_tpu_torch.scripts.{name}"],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert "a CUDA device was requested but none is available" in r.stderr
    assert r.stdout.strip() == ""
