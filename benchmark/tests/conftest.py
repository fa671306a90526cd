"""Fixtures of the benchmark's CPU tests: a checkout-like root holding a
small cell of each entry (the 6-carbon network, 4 ramps over 1 s), and the
repository's own root."""
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "tiny_nc6",
    "source": "the 6-carbon network of the benchmark's generator (tests only)",
    "network": {"generator": "synthetic_pyrolysis_network", "n_carbons": 6,
                "seed": 12345},
    "reactions": 108, "species": 19, "initial": {"C6": 1.0},
    "rates": {"calculator": "PrecalculatedArrheniusCalculator",
              "k_max": 1e12, "rate_mode": "continuous",
              "low_k_cutoff": "none"},
    "solver": {"method": "bdf", "abstol": 1e-10, "reltol": 1e-8,
               "dtype": "float64"},
    "reference": {"method": "scipy BDF, float64", "rtol": 1e-11,
                  "atol": 1e-14},
    "reduced": []}


def tiny_traffic(name, entry, batch, settings):
    return {"name": name, "who": "tests", "entry": entry, "batch": batch,
            "ramp": {"T0": 500.0, "rate_lo": 40.0, "rate_hi": 60.0,
                     "strata": max(batch, 2), "rates_seed": 1},
            "tf": 1.0, "chunk": 0.5, "settings": settings,
            "warmup_chunks": 1, "check_lanes": 4}


SWEEP = tiny_traffic("tiny_sweep", "ensemble", 4,
                     {"lu_drift_tol": 0.3, "jac_policy": "lazy",
                      "linsolve": "auto", "rhs_contraction": "auto"})
SINGLE = tiny_traffic("tiny_single", "solve_network", 1,
                      {"lu_drift_tol": 0.3, "jac_policy": "lazy",
                       "linsolve": "inv_fused", "rhs_contraction": "dd"})
LIMITS = {"max_molefrac_err": {"limit": 5e-9},
          "failed_lanes": {"limit": 0}}


def make_root(tmp: Path) -> Path:
    """A checkout-like root: the harness's code folders copied, and one
    configuration, two mixes, two cells with their limits as data."""
    bench = tmp / "benchmark"
    for folder in ("entries", "metrics", "end_to_end"):
        shutil.copytree(REPO / "benchmark" / folder, bench / folder)
    for folder in ("configs", "traffic", "limits"):
        (bench / folder).mkdir(parents=True)
    (bench / "configs" / "tiny_nc6.json").write_text(json.dumps(TINY_CONFIG))
    for mix in (SWEEP, SINGLE):
        (bench / "traffic" / f"{mix['name']}.json").write_text(json.dumps(mix))
    cells = [("tiny_b4", "tiny_sweep"), ("tiny_single", "tiny_single")]
    for cell, _ in cells:
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny_nc6", "source": "tests",
                        "file": "benchmark/configs/tiny_nc6.json",
                        "reduced": [], "why": "tests"}]
    spec["workloads"] = [{"name": c, "config": "tiny_nc6", "traffic": t,
                          "chips": 1, "why": "tests"} for c, t in cells]
    names = [c for c, _ in cells]
    for m in spec["per_layer"]:
        m["workloads"] = names
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
