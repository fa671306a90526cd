"""The spans and counters of the port's solve path
(``kinetica_tpu_torch.utils.profiling``), on the CPU.

An async ensemble (B=4 ramps) and a chunkwise discrete ``solve_network``
on a 6-carbon network, each solved with recording off and on:

- every span of the solve path appears, nests in its parent's interval
  under the parent it must have, and one solve's spans share one record;
- ``bdf.step`` spans are the steps max summed over ``bdf_solve`` calls,
  ``host_sync.read`` spans the reads counted (and the reads by site sum
  to the count), the lanes the factor built the lanes' ``n_lu``;
- recording off records nothing and the results are bit-equal either way;
- a ``torch.profiler`` session switches recording on, and each span lies
  within 1 ms of its profiler twin;
- the store's bound drops spans and counts them.
"""
import logging
from collections import Counter

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TF, B = 0.5, 4
PARENTS = {
    "ensemble.prepare": {"ensemble.solve"},
    "ensemble.attempt": {"ensemble.solve"},
    "ensemble.collect": {"ensemble.solve"},
    "solve.setup": {"solve.network"},
    "solve.calculator_setup": {"solve.setup"},
    "solve.rate_precalc": {"solve.setup"},
    "solve.chunk_dispatch": {"solve.network"},
    "solve.chunk": {"solve.chunk_dispatch"},
    "bdf.solve": {"ensemble.attempt", "solve.chunk"},
    "bdf.init": {"bdf.solve"},
    "bdf.step": {"bdf.solve"},
    "bdf.predict": {"bdf.step"},
    "bdf.newton": {"bdf.step"},
    "bdf.newton_iter": {"bdf.newton"},
    "bdf.jac_refresh": {"bdf.step"},
    "bdf.control": {"bdf.step"},
    "bdf.chunk_transition": {"bdf.step"},
    "linalg.factor": {"bdf.init", "bdf.step"},
    "linalg.refine": {"linalg.factor"},
    "host_sync.read": {"bdf.solve", "bdf.step", "bdf.newton",
                       "linalg.factor", "linalg.refine"},
}
ENSEMBLE = {"ensemble.solve", "ensemble.prepare", "ensemble.attempt",
            "ensemble.collect", "bdf.chunk_transition"}
NETWORK = {"solve.network", "solve.setup", "solve.calculator_setup",
           "solve.rate_precalc", "solve.chunk_dispatch", "solve.chunk"}
BDF = {"bdf.solve", "bdf.init", "bdf.step", "bdf.predict", "bdf.newton",
       "bdf.newton_iter", "bdf.jac_refresh", "bdf.control", "linalg.factor",
       "linalg.refine", "host_sync.read"}


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="module")
def solvers():
    """``{"ensemble": fn, "network": fn}``: each solves its problem and
    returns ``(u, bdf_solve calls' steps max summed, Σ n_lu)``."""
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.solving.methods import (VariableODESolve,
                                                    solve_network)
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(6)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e10, device="cpu")
    conds = [ConditionSet({"T": LinearGradientProfile(
        rate=50.0, X_start=float(x), X_end=float(x) + 50.0 * TF)})
        for x in np.linspace(750.0, 1000.0, B)]
    pars = ODESimulationParams(
        tspan=(0.0, TF), u0={"C6": 1.0}, solve_chunks=True,
        solve_chunkstep=TF / 2, low_k_cutoff="none", abstol=1e-6,
        reltol=1e-3, lu_drift_tol=0.3)
    problem = EnsembleProblem(VariableODESolve(pars, conds[0], calc), sd, rd,
                              rate_mode="continuous", device="cpu")

    def ensemble():
        ens = problem.solve(conditions_list=conds)
        assert ens.success and ens.stats["attempts"] == 1
        return (ens.u, int(np.max(ens.stats["n_steps"])),
                int(np.sum(ens.stats["n_lu"])))

    def network():
        cs = ConditionSet({"T": LinearGradientProfile(
            rate=50.0, X_start=800.0, X_end=800.0 + 50.0 * TF)},
            ts_update=TF / 8)
        out = solve_network(VariableODESolve(pars, cs, calc), sd, rd,
                            device="cpu")
        assert out.sol.success and out.sol.stats["n_chunks"] == 2
        # B=1: each chunk's steps max is its steps, the stats their sum
        return out.sol.u, out.sol.stats["n_steps"], out.sol.stats["n_lu"]

    return {"ensemble": ensemble, "network": network}


@pytest.fixture(scope="module")
def runs(solvers):
    """Each solve with recording off, then on: ``{name: (off result, on
    result, record, newest record before the off run, after it, the
    ``Timings`` report of the recorded run)}``."""
    from kinetica_tpu_torch.utils import profiling
    out = {}
    for name, fn in solvers.items():
        before = profiling.last_solve()
        off = fn()
        after = profiling.last_solve()
        profiling.Timings.reset()
        profiling.Timings.enable(True)
        try:
            on = fn()
            report = profiling.Timings.report(log=False)
        finally:
            profiling.Timings.enable(False)
            profiling.Timings.reset()
        out[name] = (off, on, profiling.last_solve(), before, after, report)
    return out


@pytest.mark.parametrize("name", ["ensemble", "network"])
def test_spans_nest_in_one_record(runs, name):
    _, _, rec, _, _, _ = runs[name]
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans) and rec.dropped == 0
    assert {s.record for s in rec.spans} == {rec.id}
    top = rec.top
    assert top.parent == -1 and top.name == ("ensemble.solve"
                                             if name == "ensemble"
                                             else "solve.network")
    assert [s for s in rec.spans if s.parent == -1] == [top]
    names = {s.name for s in rec.spans}
    assert names == BDF | (ENSEMBLE if name == "ensemble" else NETWORK)
    for s in rec.spans[1:]:
        parent = by_id[s.parent]
        assert parent.name in PARENTS[s.name], (s.name, parent.name)
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert all(s.attrs["site"] for s in rec.spans
               if s.name == "host_sync.read")
    assert all(s.attrs["lanes"] >= 0 for s in rec.spans
               if s.name == "linalg.factor")
    if name == "ensemble":
        attempt, = (s for s in rec.spans if s.name == "ensemble.attempt")
        assert attempt.attrs == {"lanes": B}


@pytest.mark.parametrize("name", ["ensemble", "network"])
def test_spans_and_counters_count_the_work(runs, name):
    _, (_, steps, n_lu), rec, _, _, _ = runs[name]
    n = Counter(s.name for s in rec.spans)
    c = rec.counters
    assert n["bdf.step"] == steps
    assert n["host_sync.read"] == c["host_sync.count"] > 0
    assert sum(c["host_sync.by_site"].values()) == c["host_sync.count"]
    sites = Counter(s.attrs["site"] for s in rec.spans
                    if s.name == "host_sync.read")
    assert sites == +Counter(c["host_sync.by_site"])
    assert c["host_sync.by_site"]["bdf.loop"] == steps + n["bdf.solve"]
    assert n["bdf.newton_iter"] == c["bdf.newton_iters"] >= 2 * steps
    assert n["bdf.jac_refresh"] == c["bdf.jac_refreshes"] > 0
    assert c["linalg.factor_lanes"] == n_lu
    assert c["linalg.factor_builds"] == sum(
        1 for s in rec.spans if s.name == "linalg.factor"
        and s.attrs["lanes"] > 0)
    assert c["linalg.refine_sweeps"] > 0


@pytest.mark.parametrize("name", ["ensemble", "network"])
def test_recording_off_records_nothing_and_changes_nothing(runs, name):
    (u_off, steps_off, lu_off), (u_on, steps_on, lu_on), rec, before, after, \
        _ = runs[name]
    assert after is before
    assert rec is not before
    assert np.array_equal(u_off, u_on)
    assert (steps_off, lu_off) == (steps_on, lu_on)


@pytest.mark.parametrize("name", ["ensemble", "network"])
def test_timings_report_self_time(runs, name):
    *_, rec, _, _, report = runs[name]
    for span_name in ("bdf.step", rec.top.name):
        spans = [s for s in rec.spans if s.name == span_name]
        ids = {s.id for s in spans}
        total = sum(s.end_ns - s.start_ns for s in spans)
        children = sum(s.end_ns - s.start_ns for s in rec.spans
                       if s.parent in ids)
        r = report[span_name]
        assert r["count"] == len(spans)
        assert r["total_s"] == pytest.approx(total * 1e-9, rel=1e-12)
        assert r["self_s"] == pytest.approx((total - children) * 1e-9,
                                            rel=1e-9, abs=1e-12)
        assert 0 < r["self_s"] < r["total_s"]


def test_profiler_session_records_with_twins(solvers):
    from torch.profiler import ProfilerActivity, profile

    from kinetica_tpu_torch.utils import profiling
    assert not profiling.Timings.enabled()
    before = profiling.last_solve()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solvers["network"]()
    rec = profiling.last_solve()
    assert rec is not before and rec.top.name == "solve.network"
    names = {s.name for s in rec.spans}
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in names:
        spans = sorted((s.start_ns, s.end_ns) for s in rec.spans
                       if s.name == name)
        twins = sorted(events.get(name, []))
        assert len(twins) == len(spans), name
        for (a, b), (ta, tb) in zip(spans, twins):
            assert abs(a - ta) < 1_000_000 and abs(b - tb) < 1_000_000, name


def test_store_bound_drops_and_counts(monkeypatch):
    from kinetica_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    profiling.Timings.enable(True)
    try:
        with profiling.span("unit.outer"):
            for _ in range(6):
                with profiling.span("unit.inner") as sp:
                    sp.note(i=1)
        rec = profiling.last_solve()
        assert [s.name for s in rec.spans] == ["unit.outer"] + 3 * [
            "unit.inner"]
        assert rec.dropped == 3
        assert len({s.id for s in rec.spans}) == 4
        monkeypatch.setattr(profiling, "MAX_SPANS", 1_000_000)
        for _ in range(profiling.MAX_RECORDS + 2):
            with profiling.span("unit.record"):
                pass
        assert len(profiling._store) == profiling.MAX_RECORDS
        assert profiling._held == profiling.MAX_RECORDS
    finally:
        profiling.Timings.enable(False)
        profiling.Timings.reset()
