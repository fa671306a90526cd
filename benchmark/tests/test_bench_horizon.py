"""The 1e5 s horizon cell's data and its three counter readers on the CPU:
the mix, the cell, its limits and its metrics load by name; each reader
reads its counters by hand and gives no reading without them."""
from types import SimpleNamespace

import pytest

from benchmark import check
from benchmark.harness import Spec
from benchmark.trace import Kernel

from conftest import REPO

CELL = "nc24_horizon_b64"
READERS = ("linalg.accurate_sweeps_per_step", "bdf.rejected_pct",
           "ensemble.lane_occupancy_pct")
COUNTERS = {"linalg.refine_accurate_sweeps": 6, "linalg.refine_sweeps": 20,
            "bdf.lane_steps": 480, "bdf.rejected": 24}


def test_the_cell_loads_by_name():
    spec = Spec(REPO)
    cell = spec.workload(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "pyrolysis_nc24_horizon", "ramp_horizon_b64", 1)
    config = spec.config(cell["config"])
    assert config["name"] == cell["config"] and config["reduced"] == []
    mix = spec.traffic(cell["traffic"])
    assert mix["name"] == cell["traffic"] and mix["entry"] == "ensemble"
    assert mix["batch"] == 64 and mix["ramp"]["strata"] == 64
    assert (mix["ramp"]["T0"], mix["ramp"]["rate_lo"],
            mix["ramp"]["rate_hi"]) == (500.0, 4e-3, 6e-3)
    assert round(mix["tf"] / mix["chunk"]) == 40 and mix["tf"] == 1e5
    assert mix["settings"] == spec.traffic("ramp_sweep_b64")["settings"]
    horizon = config["horizon"]
    assert (horizon["tf_s"], horizon["chunks"], horizon["T0_K"],
            horizon["ramp_K_per_s"], horizon["batch"]) == (
        mix["tf"], round(mix["tf"] / mix["chunk"]), mix["ramp"]["T0"],
        [mix["ramp"]["rate_lo"], mix["ramp"]["rate_hi"]], mix["batch"])
    limits = check.load_limits(REPO, CELL)
    m = limits["max_molefrac_err"]
    assert m["lower"] < m["limit"] < m["upper"]
    assert limits["failed_lanes"]["limit"] == 0
    names = {m["name"] for m in spec.metrics(CELL, "per_layer")}
    assert set(READERS) <= names
    for name in names:
        assert callable(spec.module("metrics", name).read)
    per_layer = {m["name"]: m for m in spec.data["per_layer"]}
    for name in READERS:
        assert per_layer[name]["workloads"] == list(spec.workloads)
        assert per_layer[name]["moves"] == "profiles_per_s"


def test_the_horizon_runs_the_nc24_network_and_tolerances():
    """The deployment differs from ``pyrolysis_nc24`` in its horizon, which
    the mix carries; every number the run and its check read is the same."""
    spec = Spec(REPO)
    horizon = spec.config(spec.workload(CELL)["config"])
    nc24 = spec.config("pyrolysis_nc24")
    for key in ("network", "reactions", "species", "initial", "rates",
                "solver", "reference"):
        assert horizon[key] == nc24[key], key


def _record(counters):
    span = SimpleNamespace(id=0, parent=-1, name="ensemble.solve",
                           start_ns=0, end_ns=1000)
    return SimpleNamespace(id=1, dropped=0, counters=dict(counters),
                           spans=[span])


def _ctx(batch=4, steps_max=160):
    tr = SimpleNamespace(window_s=1e-6, kernels=[Kernel("k", 100, 50)])
    return SimpleNamespace(trace=tr, shape=SimpleNamespace(batch=batch),
                           traced=SimpleNamespace(steps_max=steps_max))


@pytest.fixture
def last_solve(monkeypatch):
    from kinetica_tpu_torch.utils import profiling

    def set_record(rec):
        monkeypatch.setattr(profiling, "last_solve", lambda: rec)
    return set_record


def _read(name, ctx):
    return Spec(REPO).module("metrics", name).read(ctx)


def test_readers_by_hand(last_solve):
    last_solve(_record(COUNTERS))
    ctx = _ctx()
    assert _read("linalg.accurate_sweeps_per_step", ctx) == pytest.approx(
        6 / 160)
    assert _read("bdf.rejected_pct", ctx) == pytest.approx(100 * 24 / 480)
    assert _read("ensemble.lane_occupancy_pct", ctx) == pytest.approx(
        100 * 480 / (4 * 160))


@pytest.mark.parametrize("name", READERS)
def test_no_reading_without_the_counter(last_solve, name):
    needs = {"linalg.accurate_sweeps_per_step":
             ("linalg.refine_accurate_sweeps",),
             "bdf.rejected_pct": ("bdf.lane_steps", "bdf.rejected"),
             "ensemble.lane_occupancy_pct": ("bdf.lane_steps",)}[name]
    for missing in needs:
        last_solve(_record({k: v for k, v in COUNTERS.items()
                            if k != missing}))
        assert _read(name, _ctx()) is None, missing
    last_solve(None)
    assert _read(name, _ctx()) is None
