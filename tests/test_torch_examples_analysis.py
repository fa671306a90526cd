"""The port's ``analysis_pipeline`` example against the JAX package's
computation, on the CPU at nc=4 (the example's published nc=6 takes the
two packages several minutes on a CPU).

The Morris design is equal and the elementary effects within 1e-6 of
max|ee| (as ``tests/test_torch_screening.py``); the Morris top 8, the
Sobol survivors, the DRGEP kept set and the projected flux's top 4
channels are equal; the Sobol indices of the survivors agree within
1e-6; both packages refuse the trapezoid attribution.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def test_analysis_pipeline_matches_jax():
    from kinetica_tpu import (ConditionSet, ODESimulationParams,
                              PrecalculatedArrheniusCalculator,
                              StaticODESolve, morris_screening,
                              reduce_network_drg, sobol_sensitivity,
                              solve_network)
    from kinetica_tpu.analysis.flux import reaction_fluxes
    from kinetica_tpu.analysis.screening import morris_design as jdesign
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    from kinetica_tpu_torch.analysis.screening import morris_design
    from kinetica_tpu_torch.examples import analysis_pipeline

    nc = 4
    out = analysis_pipeline.main(n_carbons=nc, device="cpu")
    target = analysis_pipeline.TARGET

    sd, rd, Ea, A = synthetic_pyrolysis_network(nc)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12)
    pars = ODESimulationParams(tspan=(0.0, 2.0), u0={f"C{nc}": 1.0},
                               solve_chunks=True, solve_chunkstep=0.5,
                               save_interval=0.01)
    method = StaticODESolve(pars, ConditionSet({"T": 1100.0}), calc)
    full = solve_network(method, sd, rd)
    scr = morris_screening(method, sd, rd, objective=target,
                           n_trajectories=4, span_decades=1.0, seed=7)
    sob = sobol_sensitivity(method, sd, rd, rids=scr.ranking()[:6],
                            objective=target, n_samples=32,
                            span_decades=1.0, seed=7)
    red = reduce_network_drg(method, sd, rd, targets=[target], tol=1e-3,
                             method="drgep", full_output=full,
                             eps_ladder=np.geomspace(0.3, 0.12, 8))
    with pytest.raises(ValueError):
        reaction_fluxes(full, calc=calc)
    flux = reaction_fluxes(full, calc=calc, attribution="projected")

    for a, b in zip(morris_design(rd.nr, 4, 4, 7), jdesign(rd.nr, 4, 4, 7)):
        np.testing.assert_array_equal(a, b)
    scale = np.abs(scr.ee).max()
    assert np.abs(out.scr.ee - scr.ee).max() <= 1e-6 * scale
    np.testing.assert_array_equal(out.scr.ranking()[:8], scr.ranking()[:8])
    np.testing.assert_array_equal(out.survivors, scr.ranking()[:6])
    assert np.abs(out.sob.ST - sob.ST).max() <= 1e-6
    assert np.abs(out.sob.S1 - sob.S1).max() <= 1e-6
    assert out.red.reduction.keep_rids == red.reduction.keep_rids
    assert out.red.error <= 1e-3 and red.error <= 1e-3
    assert out.refused is not None
    assert ([int(r) for r, _ in out.flux.top(4)]
            == [int(r) for r, _ in flux.top(4)])
