"""DRG / DRGEP reduction (``analysis/reduction.py``) of the port against
the JAX package, on the pyrolysis core plus trace isomer cluster of
``tests/test_reduction.py``.

* the relation graphs (DRG r_AB, DRGEP r_AB and its path-product
  importances) of both packages on the same port solve: equal to 1e-12;
* the error-controlled sweeps, each package solving with its own
  ``solve_network``: the same ladder of candidates (eps, species,
  reactions), the same accepted mechanism, its error <= tol (1e-6);
* the reference's assertions on the port's results.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def network_with_junk(pkg="kinetica_tpu_torch"):
    """6-species pyrolysis core + 2-species trace isomer cluster."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    network = mod("core.network")
    sd = network.SpeciesData(["C", "[H]", "[CH3]", "[H][H]", "CC", "C=C",
                              "CCO", "COC"])
    reacs = [["C"], ["[CH3]", "[H]"], ["C", "[H]"], ["[CH3]", "[CH3]"],
             ["CC"], ["CC"], ["CCO"], ["COC"], ["CC", "CCO"]]
    prods = [["[CH3]", "[H]"], ["C"], ["[CH3]", "[H][H]"], ["CC"],
             ["C=C", "[H][H]"], ["[CH3]", "[CH3]"], ["COC"], ["CCO"],
             ["CC", "COC"]]
    rd = network.RxData.from_reactions(sd, reacs, prods,
                                       dH=[0.0] * len(reacs))
    Ea = np.array([3.6e5, 0.0, 4.0e4, 0.0, 3.2e5, 3.5e5, 8.0e4, 8.0e4, 8.0e4])
    A = np.array([1e-8, 1e-12, 1e-13, 1e-12, 1e-7, 1e-8, 1e-16, 1e-16, 1e-18])
    kw = {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}
    calc = mod("calculators.builtin").PrecalculatedArrheniusCalculator(
        Ea, A, k_max=1e12, **kw)
    pars = mod("solving.params").ODESimulationParams(
        tspan=(0.0, 10.0), u0={"C": 1.0, "CCO": 1e-6}, solve_chunks=False,
        save_interval=0.2)
    cs = mod("conditions.condition_set").ConditionSet({"T": 900.0})
    method = mod("solving.methods").StaticODESolve(pars, cs, calc)
    return sd, rd, calc, method


@pytest.fixture(scope="module")
def port_out():
    from kinetica_tpu_torch.solving.methods import solve_network
    sd, rd, calc, method = network_with_junk()
    return solve_network(method, sd, rd, device="cpu"), calc


def test_graphs_match_reference(port_out):
    import kinetica_tpu.analysis.reduction as jred
    import kinetica_tpu_torch.analysis.reduction as red
    out, calc = port_out
    jcalc = network_with_junk("kinetica_tpu")[2]
    sd = out.sd
    for name in ("drg_adjacency", "drgep_adjacency"):
        r = getattr(red, name)(out, calc=calc)
        r_ref = getattr(jred, name)(out, calc=jcalc)
        np.testing.assert_allclose(r, r_ref, rtol=1e-12, atol=1e-15)
        assert r.shape == (sd.n, sd.n)
        assert np.all(r >= 0.0) and np.all(r <= 1.0 + 1e-12)
        assert np.all(np.diag(r) == 0.0)
        assert r[sd.toInt["C"], sd.toInt["[CH3]"]] > 0.5
    R = red.drgep_coefficients(r, [sd.toInt["CC"]])
    np.testing.assert_array_equal(
        R, jred.drgep_coefficients(r, [sd.toInt["CC"]]))
    rg = red.drg_adjacency(out, calc=calc)
    assert rg[sd.toInt["C"], sd.toInt["CCO"]] < 1e-3


@pytest.mark.parametrize("method", ["drg", "drgep"])
def test_reduction_matches_reference(method):
    from kinetica_tpu.analysis.reduction import reduce_network_drg as jax_drg
    from kinetica_tpu_torch.analysis.reduction import (DRGReductionResult,
                                                       reduce_network_drg)
    sd, rd, calc, m = network_with_junk()
    res = reduce_network_drg(m, sd, rd, targets=["CC", "C=C"], tol=1e-6,
                             method=method, device="cpu")
    jsd, jrd, _, jm = network_with_junk("kinetica_tpu")
    ref = jax_drg(jm, jsd, jrd, targets=["CC", "C=C"], tol=1e-6,
                  method=method)
    assert isinstance(res, DRGReductionResult) and res.method == method
    assert [l[:3] for l in res.ladder] == [l[:3] for l in ref.ladder]
    assert res.reduction.keep_rids == ref.reduction.keep_rids
    np.testing.assert_array_equal(res.reduction.keep_species,
                                  ref.reduction.keep_species)
    assert res.error <= 1e-6
    assert res.reduction.n_reactions < rd.nr
    assert not (set(res.reduction.keep_rids) & {6, 7, 8})
    kept = {sd.toStr[int(i)] for i in np.flatnonzero(
        res.reduction.keep_species)}
    assert {"C", "[CH3]", "[H]", "CC"} <= kept
    assert method.upper() in res.summary()


def test_apply_compact_and_resolve(port_out):
    from kinetica_tpu_torch.analysis.reduction import reduce_network_drg
    from kinetica_tpu_torch.solving.methods import StaticODESolve, solve_network
    sd, rd, calc, m = network_with_junk()
    res = reduce_network_drg(m, sd, rd, targets=["CC"], tol=1e-6,
                             full_output=port_out[0], device="cpu")
    rd2, calc2 = res.reduction.apply(rd, calc)
    assert rd2.nr == res.reduction.n_reactions == calc2.Ea.shape[0]
    out2 = solve_network(StaticODESolve(m.pars, m.conditions, calc2), sd, rd2,
                         device="cpu")
    tid = sd.toInt["CC"]
    assert np.abs(out2.sol.u[:, tid] - port_out[0].sol.u[:, tid]).max() <= 1e-6
    assert rd.nr == 9 and calc.Ea.shape[0] == 9
    sd3, rd3, smap = res.reduction.compact(sd, rd)
    assert sd3.n == res.reduction.n_species
    assert rd3.nr == res.reduction.n_reactions
    with pytest.raises(ValueError, match="tol"):
        reduce_network_drg(m, sd, rd, targets=["CC"], tol=1e-30,
                           eps_ladder=[0.5, 0.4], full_output=port_out[0],
                           device="cpu")
    with pytest.raises(ValueError, match="method"):
        reduce_network_drg(m, sd, rd, targets=["CC"], method="cuteness",
                           device="cpu")
