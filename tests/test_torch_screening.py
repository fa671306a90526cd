"""Morris screening (``analysis/screening.py``) of the port against the
JAX package, on the chain CRN of ``tests/test_screening.py`` (A -> B -> C
with k1 rate-limiting, and a disconnected D -> E).

Both packages run the same design (same seed) through their own batched
ensembles; the elementary effects agree within 1e-6 of max|ee| (two
solvers at 1e-8 / 1e-10). The reference's assertions hold on the port's
result, and one elementary effect equals the difference of two of the
port's own ``solve_network`` runs with k scaled by hand (rel 1e-6).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def chain_network(pkg="kinetica_tpu_torch"):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    network = mod("core.network")
    sd = network.SpeciesData(["C", "CC", "CCC", "CCCC", "CCCCC"])
    rd = network.RxData.from_reactions(
        sd, reacs=[["C"], ["CC"], ["CCCC"]],
        prods=[["CC"], ["CCC"], ["CCCCC"]], dH=[0.0, 0.0, 0.0])
    A = np.array([0.5, 50.0, 1.0]) / mod("constants").N_A
    kw = {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}
    calc = mod("calculators.builtin").PrecalculatedArrheniusCalculator(
        np.zeros(3), A, **kw)
    return sd, rd, calc


def make_method(calc, pkg="kinetica_tpu_torch", tf=2.0):
    import importlib
    pars = importlib.import_module(f"{pkg}.solving.params").ODESimulationParams(
        tspan=(0.0, tf), u0={"C": 1.0}, solve_chunks=True,
        solve_chunkstep=1.0, low_k_cutoff="none")
    cs = importlib.import_module(f"{pkg}.conditions.condition_set")
    return importlib.import_module(f"{pkg}.solving.methods").StaticODESolve(
        pars, cs.ConditionSet({"T": 1000.0}), calc)


def run_both(fn_name, module, **kw):
    """The analysis ``fn_name`` of ``module`` in both packages."""
    import importlib
    out = []
    for pkg in ("kinetica_tpu_torch", "kinetica_tpu"):
        fn = getattr(importlib.import_module(f"{pkg}.analysis.{module}"),
                     fn_name)
        sd, rd, calc = chain_network(pkg)
        extra = {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}
        out.append((fn(make_method(calc, pkg), sd, rd, **kw, **extra), sd, rd))
    return out


def test_design_matches_reference():
    from kinetica_tpu.analysis.screening import morris_design as jdesign
    from kinetica_tpu_torch.analysis.screening import morris_design
    for a, b in zip(morris_design(5, 7, n_levels=4, seed=3),
                    jdesign(5, 7, n_levels=4, seed=3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        morris_design(3, 2, n_levels=3)


def test_ranking_and_disconnected_zero():
    (res, sd, rd), (ref, _, _) = run_both(
        "morris_screening", "screening", objective="CCC", n_trajectories=6,
        span_decades=1.0, seed=11)
    scale = np.abs(ref.ee).max()
    assert np.abs(res.ee - ref.ee).max() <= 1e-6 * scale
    np.testing.assert_array_equal(res.ranking(), ref.ranking())
    assert res.failed_points == 0
    assert res.ranking()[0] == 0
    assert res.mu_star[0] > 5 * res.mu_star[1]
    assert res.mu[0] > 0
    assert res.mu_star[2] == 0.0 and res.sigma[2] == 0.0
    text = res.summarise(sd, rd)
    assert "CC" in text and "mu*" in text


def test_elementary_effect_matches_independent_solves():
    from kinetica_tpu_torch.analysis.screening import (morris_design,
                                                       morris_screening)
    from kinetica_tpu_torch.solving.methods import solve_network
    sd, rd, calc = chain_network()
    res = morris_screening(make_method(calc), sd, rd, rids=[0, 1],
                           objective="CCC", n_trajectories=1, n_levels=4,
                           span_decades=1.0, seed=5, device="cpu")
    pts, steps, orders, _ = morris_design(2, 1, n_levels=4, seed=5)

    def solve_scaled(x):
        _, _, calc2 = chain_network()
        A = np.array(calc2.A, dtype=float)
        A[:2] *= 10.0 ** (np.asarray(x) - 0.5)
        from kinetica_tpu_torch.calculators.builtin import \
            PrecalculatedArrheniusCalculator
        calc2 = PrecalculatedArrheniusCalculator(np.zeros(3), A, device="cpu")
        out = solve_network(make_method(calc2), sd, rd, device="cpu")
        assert out.sol.success
        return float(out.sol.u[-1, sd.toInt["CCC"]])

    i = int(orders[0, 0])
    ee_ref = (solve_scaled(pts[0, 1]) - solve_scaled(pts[0, 0])) / steps[0, i]
    assert res.ee[0, i] == pytest.approx(ee_ref, rel=1e-6, abs=1e-12)


def test_callable_objective_and_default():
    (res, sd, _), (ref, _, _) = run_both(
        "morris_screening", "screening", rids=[0, 1],
        objective=lambda t, u: float(u[-1, 2] / max(u[-1, 1] + u[-1, 2],
                                                    1e-300)),
        n_trajectories=3, seed=2)
    assert np.all(np.isfinite(res.mu_star))
    np.testing.assert_allclose(res.mu_star, ref.mu_star, rtol=1e-6,
                               atol=1e-9)
    from kinetica_tpu_torch.analysis.screening import morris_screening
    sd, rd, calc = chain_network()
    res2 = morris_screening(make_method(calc), sd, rd, rids=[0],
                            n_trajectories=2, seed=2, device="cpu")
    assert "CCCCC" in res2.objective_name


def test_top_level_export():
    import kinetica_tpu_torch as kt
    from kinetica_tpu_torch.analysis.screening import (MorrisResult,
                                                       morris_screening)
    assert kt.morris_screening is morris_screening
    assert kt.MorrisResult is MorrisResult
