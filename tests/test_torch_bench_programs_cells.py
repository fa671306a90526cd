"""The port's long-horizon, exploration and step-count programs on the CPU.

Each driven through its ``main`` with ``--device cpu`` at
``KINETICA_BENCH_NC=6``, ``KINETICA_BENCH_BATCH=4``:

* ``bench_longhorizon`` with its horizon cut from 1e5 s to 1e4 s
  (``KINETICA_BENCH_TF``, the test's size; its 40 chunks, ramps and
  settings unchanged): the three
  lines of the JAX script's output, in its format, and member 0 within its
  1e-6 gate of the chunked scipy-BDF;
* ``bench_explore 4``: the JAX record's keys, read from
  ``scripts/bench_explore.py``, its per-level keys in every level, and
  config 5's species and reactions by level (the JAX package's record);
* ``step_count_audit 40``: the JAX script's header, and the scipy-BDF step
  count equal to the JAX audit's exactly (the same numpy code on the same
  chunks).

No run changes the JAX side's ``scripts/*_results.jsonl`` (hashes before
and after).
"""
import ast
import hashlib
import json
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = {"KINETICA_BENCH_NC": "6", "KINETICA_BENCH_BATCH": "4"}
JAX_RECORDS = ("scripts/bsweep_results.jsonl", "scripts/explore_results.jsonl")
NUM = r"[-+0-9.e]+"


@pytest.fixture(autouse=True)
def small_jax_records_untouched(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)

    def hashes():
        return {p: hashlib.sha256((REPO / p).read_bytes()).hexdigest()
                for p in JAX_RECORDS}
    before = hashes()
    yield
    assert hashes() == before


def test_longhorizon_prints_the_jax_lines(monkeypatch, capsys):
    from kinetica_tpu_torch.scripts import bench_longhorizon as lh
    monkeypatch.setenv("KINETICA_BENCH_TF", "1e4")
    out = lh.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    patterns = [
        rf"1e4s sweep \(40 chunks\): {NUM} ms/profile \(warm incl compile "
        rf"\d+s\); steps max=\d+ med=\d+; carbon drift {NUM}",
        rf"lane spread: steps min=\d+ max=\d+ \(x{NUM}\); corr\(steps, ramp "
        rf"rate\) = [+-]{NUM}",
        rf"CPU BDF single profile: {NUM}s -> per-profile speedup {NUM}x; max "
        rf"mole-frac err vs CPU {NUM}"]
    printed = [ln for ln in lines if not ln.startswith("[")]
    assert len(printed) == 3
    for pat, ln in zip(patterns, printed):
        assert re.fullmatch(pat, ln), ln
    assert out["max_molefrac_err"] <= 1e-6
    assert out["carbon_drift"] <= 1e-6
    assert out["batch"] == 4 and out["n_chunks"] == 40 and out["tf"] == 1e4
    assert out["steps_min"] <= out["steps_median"] <= out["steps_max"]


def _jax_keys(func, target):
    tree = ast.parse((REPO / "scripts/bench_explore.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    node = next(n for n in ast.walk(fn)
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and ast.unparse(n.targets[0]) == target)
    return [k.value for k in node.value.keys]


def test_explore_record(capsys, tmp_path):
    from kinetica_tpu_torch.scripts import bench_explore
    from kinetica_tpu_torch.testing.explore_config import RECORD
    out = tmp_path / "explore.jsonl"
    rec = bench_explore.main(["4", "--device", "cpu", "--out", str(out)])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == [rec]
    assert json.loads(out.read_text()) == rec
    assert list(rec) == _jax_keys("main", "rec")
    # the JAX record's per-level keys (scripts/explore_results.jsonl)
    level_keys = {"level", "explore_s", "solve_s", "seeds_s", "n_species",
                  "n_reactions", "batch", "n_seeds_next"}
    jax_rec = json.loads((REPO / JAX_RECORDS[1]).read_text().splitlines()[-1])
    assert set(jax_rec["per_level"][0]) == level_keys
    assert all(level_keys <= set(t) for t in rec["per_level"])
    assert [(t["n_species"], t["n_reactions"]) for t in rec["per_level"]] \
        == list(RECORD)
    assert rec["platform"] == "cpu" and rec["batch"] == 4
    assert (rec["final_species"], rec["final_reactions"]) == RECORD[-1]
    phases = sum(t["explore_s"] + t["solve_s"] + t["seeds_s"]
                 for t in rec["per_level"])
    assert rec["interleave_overhead_s"] == pytest.approx(
        rec["total_s"] - phases)


def test_audit_matches_the_jax_audit(monkeypatch, capsys):
    from kinetica_tpu_torch.scripts import step_count_audit
    monkeypatch.setattr(sys, "argv", ["step_count_audit.py", "40"])
    runpy.run_path(str(REPO / "scripts/step_count_audit.py"),
                   run_name="__main__")
    jax_lines = capsys.readouterr().out.splitlines()
    rows = step_count_audit.main(["40", "--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    assert port_lines[:2] == jax_lines[:2]
    row = rf"\s*40\.0\s+(\d+)\s+(\d+)\s+{NUM}  \(\+\d+ rejected\)"
    _, jax_scipy = map(int, re.fullmatch(row, jax_lines[2]).groups())
    ours, scipy_steps = map(int, re.fullmatch(row, port_lines[2]).groups())
    assert scipy_steps == jax_scipy == rows[0]["scipy"]
    assert ours == rows[0]["ours"] > 0
