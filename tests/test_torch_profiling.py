"""The port's profiling utilities against the JAX package's.

Ports of ``tests/test_utils.py::TestProfiling``: ``timed`` and
``Timings`` enabled and disabled; the sections that ``solve_network``
times (``solve.chunk_dispatch`` per group of ``chunks_per_dispatch``
chunks, ``solve.calculator_setup``, ``solve.rate_precalc``) with the
same counts as the JAX package's on the same discrete solve (nc=4, a
700 -> 900 K ramp, 4 chunks); and ``trace`` writing a Chrome trace on
the CPU that holds an ``annotate`` span.
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
SECTIONS = ("solve.calculator_setup", "solve.chunk_dispatch",
            "solve.rate_precalc")


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(params=["kinetica_tpu", "kinetica_tpu_torch"])
def timings(request):
    import importlib
    prof = importlib.import_module(f"{request.param}.utils.profiling")
    prof.Timings.reset()
    yield request.param, prof
    prof.Timings.enable(False)
    prof.Timings.reset()


def test_timed_sections_and_report(timings):
    _, prof = timings
    prof.Timings.enable(True)
    with prof.timed("unit.section"):
        pass
    with prof.timed("unit.section"):
        pass
    rep = prof.Timings.report(log=False)
    assert rep["unit.section"]["count"] == 2
    assert rep["unit.section"]["total_s"] >= 0.0
    assert rep["unit.section"]["mean_s"] == rep["unit.section"]["total_s"] / 2


def test_disabled_is_noop(timings):
    _, prof = timings
    assert not prof.Timings.enabled()
    with prof.timed("unit.never"):
        pass
    assert prof.Timings.report(log=False) == {}


def _discrete_solve(pkg, cpd):
    import importlib
    calc_m = importlib.import_module(f"{pkg}.calculators.builtin")
    cs_m = importlib.import_module(f"{pkg}.conditions.condition_set")
    prof_m = importlib.import_module(f"{pkg}.conditions.profiles")
    meth = importlib.import_module(f"{pkg}.solving.methods")
    par_m = importlib.import_module(f"{pkg}.solving.params")
    syn = importlib.import_module(f"{pkg}.testing.synthetic")
    dev = {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}
    sd, rd, Ea, A = syn.synthetic_pyrolysis_network(4)
    calc = calc_m.PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, **dev)
    cs = cs_m.ConditionSet({"T": prof_m.LinearGradientProfile(
        rate=200.0, X_start=700.0, X_end=900.0)}, ts_update=0.1)
    pars = par_m.ODESimulationParams(
        tspan=(0.0, 1.0), u0={"C4": 1.0}, solve_chunks=True,
        solve_chunkstep=0.25, low_k_cutoff="none", chunks_per_dispatch=cpd)
    return meth.solve_network(meth.VariableODESolve(pars, cs, calc), sd, rd,
                              **dev)


@pytest.mark.parametrize("cpd,dispatches", [(None, 1), (2, 2), (1, 4)])
def test_solve_network_times_the_reference_sections(cpd, dispatches):
    counts = {}
    for pkg in ("kinetica_tpu", "kinetica_tpu_torch"):
        import importlib
        prof = importlib.import_module(f"{pkg}.utils.profiling")
        prof.Timings.reset()
        prof.Timings.enable(True)
        try:
            assert _discrete_solve(pkg, cpd).sol.success
            rep = prof.Timings.report(log=False)
        finally:
            prof.Timings.enable(False)
            prof.Timings.reset()
        assert set(SECTIONS) <= set(rep)
        assert all(rep[s]["total_s"] > 0.0 for s in SECTIONS)
        counts[pkg] = {s: rep[s]["count"] for s in SECTIONS}
    assert counts["kinetica_tpu_torch"] == counts["kinetica_tpu"]
    assert counts["kinetica_tpu_torch"] == {
        "solve.calculator_setup": 1, "solve.chunk_dispatch": dispatches,
        "solve.rate_precalc": 1}


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    from kinetica_tpu_torch.utils.profiling import annotate, trace
    logdir = tmp_path / "trace"
    with trace(str(logdir)) as path:
        with annotate("kinetica.unit_span"):
            x = torch.arange(64.0).reshape(8, 8)
            (x @ x).sum()
    assert os.path.dirname(path) == str(logdir) and os.path.exists(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "kinetica.unit_span" in names
    assert any(str(n).startswith("aten::mm") for n in names)


def test_annotate_is_transparent_outside_a_trace():
    from kinetica_tpu_torch.utils.profiling import annotate
    with annotate("kinetica.no_trace"):
        y = np.float64(2.0) * 3.0
    assert y == 6.0
