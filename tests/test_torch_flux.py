"""Reaction fluxes (``analysis/flux.py``) of the port against the JAX
package's, and the cases of ``tests/test_flux.py``.

Each solve is the port's (``device="cpu"``); both packages' flux
analyses then run on that same output (the JAX one with its own
calculator on the same Arrhenius parameters), so the comparison isolates
the analysis: the rate tables, rates, extents and checks agree to 1e-12
relative (the k table read through each package's lookup, the same
numpy afterwards). The reference's own assertions hold on the port's
solves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


def _calcs(Ea, A, k_max=None):
    from kinetica_tpu.calculators.builtin import \
        PrecalculatedArrheniusCalculator as JaxCalc
    from kinetica_tpu_torch.calculators.builtin import \
        PrecalculatedArrheniusCalculator
    return (PrecalculatedArrheniusCalculator(Ea, A, k_max=k_max,
                                             device="cpu"),
            JaxCalc(Ea, A, k_max=k_max))


def _pars(tf=4.0, n_save=200):
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    return ODESimulationParams(tspan=(0.0, tf), u0={"C6": 1.0},
                               solve_chunks=True, solve_chunkstep=tf / 4,
                               save_interval=tf / n_save,
                               low_k_cutoff="none")


def _pyrolysis(cs, pars=None):
    from kinetica_tpu_torch.solving.methods import (StaticODESolve,
                                                    VariableODESolve,
                                                    solve_network)
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(6)
    calc, jcalc = _calcs(Ea, A, k_max=1e12)
    cls = StaticODESolve if cs.isstatic() else VariableODESolve
    out = solve_network(cls(pars or _pars(), cs, calc), sd, rd, device="cpu")
    return out, calc, jcalc


def _resolved():
    """A -> B -> C chain with O(1/s) rates: fully grid-resolvable."""
    from kinetica_tpu_torch import constants
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.core.network import RxData, SpeciesData
    from kinetica_tpu_torch.solving.methods import StaticODESolve, solve_network
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    sd = SpeciesData(["C", "CC", "CCC"])
    rd = RxData.from_reactions(sd, reacs=[["C"], ["CC"]],
                               prods=[["CC"], ["CCC"]], dH=[0.0, 0.0])
    calc, jcalc = _calcs(np.zeros(2), np.array([0.5, 1.5]) / constants.N_A)
    pars = ODESimulationParams(tspan=(0.0, 2.0), u0={"C": 1.0},
                               solve_chunks=False, save_interval=0.01,
                               low_k_cutoff="none")
    out = solve_network(StaticODESolve(pars, ConditionSet({"T": 500.0}),
                                       calc), sd, rd, device="cpu")
    return out, calc, jcalc


def _same(port, ref):
    """The two packages' FluxResults on one output, to 1e-12."""
    for f in ("t", "rates", "extent", "net_production"):
        a, b = getattr(port, f), np.asarray(getattr(ref, f))
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1e-300), f
    for f in ("identity_error", "startup_error"):
        a, b = getattr(port, f), getattr(ref, f)
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12 * abs(b) + 1e-15


def test_resolved_trapezoid_and_projected():
    import kinetica_tpu.analysis.flux as jflux
    from kinetica_tpu_torch.analysis.flux import (reaction_fluxes,
                                                  species_flux_balance)
    out, calc, jcalc = _resolved()
    flux = reaction_fluxes(out, calc=calc)
    _same(flux, jflux.reaction_fluxes(out, calc=jcalc))
    assert flux.rates.shape == (len(out.sol.t), out.rd.nr)
    assert flux.identity_error < 1e-4 and flux.startup_error < 1e-4
    u = np.asarray(out.sol.u)
    assert np.allclose(flux.net_production, u[-1] - u[0], atol=1e-4)
    top = species_flux_balance(flux, out, "C", n=1)
    assert top == jflux.species_flux_balance(flux, out, "C", n=1)
    assert top[0][0] == 0 and top[0][1] < 0.0
    proj = reaction_fluxes(out, calc=calc, attribution="projected")
    _same(proj, jflux.reaction_fluxes(out, calc=jcalc,
                                      attribution="projected"))
    assert np.allclose(proj.extent, flux.extent, rtol=1e-3, atol=1e-6)
    assert np.allclose(proj.net_production, u[-1] - u[0], atol=1e-12)
    with pytest.raises(ValueError, match="attribution"):
        reaction_fluxes(out, calc=calc, attribution="magic")


def test_subgrid_burst_guard_and_projection():
    import kinetica_tpu.analysis.flux as jflux
    from kinetica_tpu_torch.analysis.flux import reaction_fluxes
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    out, calc, jcalc = _pyrolysis(ConditionSet({"T": 550.0}))
    with pytest.raises(ValueError, match="startup"):
        reaction_fluxes(out, calc=calc)
    bad = reaction_fluxes(out, calc=calc, check=False)
    _same(bad, jflux.reaction_fluxes(out, calc=jcalc, check=False))
    assert bad.startup_error > 0.5
    flux = reaction_fluxes(out, calc=calc, attribution="projected")
    _same(flux, jflux.reaction_fluxes(out, calc=jcalc,
                                      attribution="projected"))
    u = np.asarray(out.sol.u)
    assert np.allclose(flux.net_production, u[-1] - u[0], atol=1e-8)
    c6 = out.sd.toInt["C6"]
    fission = [j for j in range(out.rd.nr) if c6 in out.rd.id_reacs[j]]
    assert sum(abs(flux.extent[j]) for j in fission) < 10.0
    assert sum(abs(bad.extent[j]) for j in fission) > 1e3


def test_discrete_stored_table_and_continuous_reevaluation():
    import kinetica_tpu.analysis.flux as jflux
    from kinetica_tpu_torch.analysis.flux import FluxResult, reaction_fluxes
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile

    def ramp(**kw):
        return ConditionSet({"T": LinearGradientProfile(
            rate=10.0, X_start=520.0, X_end=560.0)}, **kw)
    out, _, _ = _pyrolysis(ramp(ts_update=0.1))
    assert out.sol_k is not None
    flux = reaction_fluxes(out, attribution="projected")
    _same(flux, jflux.reaction_fluxes(out, attribution="projected"))
    u = np.asarray(out.sol.u)
    assert np.allclose(flux.net_production, u[-1] - u[0], atol=1e-8)

    out, calc, jcalc = _pyrolysis(ramp())
    assert out.sol_k is None
    with pytest.raises(ValueError, match="calculator"):
        reaction_fluxes(out)
    flux = reaction_fluxes(out, calc=calc, attribution="projected")
    _same(flux, jflux.reaction_fluxes(out, calc=jcalc,
                                      attribution="projected"))
    assert isinstance(flux, FluxResult)
    vals = [abs(v) for _, v in flux.top(5)]
    assert vals == sorted(vals, reverse=True)


def test_coarse_grid_check_raises():
    from kinetica_tpu_torch.analysis.flux import reaction_fluxes
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    out, calc, _ = _pyrolysis(ConditionSet({"T": 900.0}),
                              _pars(tf=1.0, n_save=4))
    with pytest.raises(ValueError, match="save grid|startup"):
        reaction_fluxes(out, calc=calc)
    assert np.isfinite(reaction_fluxes(out, calc=calc, check=False)
                       .extent).all()
