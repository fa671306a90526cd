"""Forward sensitivities with the port's linear solve forced to the f64
"lu" (the JAX package's CPU choice), and at the multi-tile width.

* "lu": ``bdf.resolve_linsolve`` monkeypatched, the static case of
  ``tests/test_sensitivity.py``: the port's S against the JAX package's
  within 1e-6 of max|S| (measured 4.2e-13), and against
  central differences of its own solve within 5e-3 of each column's
  max|S| with a difference-quotient noise below 1e-3;
* multi-tile: the thinned ``synthetic_pyrolysis_network(60,
  target_reactions=300)`` problem of ``tests/test_grad_multitile.py``
  (181 species: the block-Schur factor, 128 + 53, with rule 2 as its
  tangent) against the JAX package's "lu" within 2e-2 of max|S|, the
  reference's own inv-vs-lu bound (measured 1.2e-9).
"""
import numpy as np
import torch

from test_torch_sensitivity import (RIDS, fd_errors, jax_sensitivities,
                                    port_problem)

torch.set_num_threads(1)


def test_lu_matches_jax(monkeypatch):
    from kinetica_tpu_torch.ops import bdf
    static_ref = jax_sensitivities(variable=False)
    monkeypatch.setattr(bdf, "resolve_linsolve", lambda method, ns: "lu")
    prob = port_problem(variable=False)
    sens = prob.solve()
    rel = np.abs(sens.S - static_ref.S).max() / np.abs(static_ref.S).max()
    print(f"port ('lu') S vs the JAX package's: {rel:.2e} of max|S|")
    assert rel <= 1e-6
    for col, (err, noise) in enumerate(fd_errors(prob, sens.S)):
        print(f"rid {RIDS[col]} ('lu'): vs central differences {err:.2e}, "
              f"noise {noise:.2e}")
        assert noise < 1e-3, (RIDS[col], noise)
        assert err < 5e-3 + noise, (RIDS[col], err, noise)


def _multitile(pkg):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    kw = {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}
    sd, rd, Ea, A = mod("testing.synthetic").synthetic_pyrolysis_network(
        60, target_reactions=300)
    calc = mod("calculators.builtin").PrecalculatedArrheniusCalculator(
        Ea, A, k_max=1e4, **kw)
    pars = mod("solving.params").ODESimulationParams(
        tspan=(0.0, 2e-4), u0={"C60": 1.0}, solve_chunks=False,
        low_k_cutoff="none", save_interval=1e-4)
    ConditionSet = mod("conditions.condition_set").ConditionSet
    method = mod("solving.methods").StaticODESolve(
        pars, ConditionSet({"T": 900.0}), calc)
    return sd, rd, method


def test_multitile_matches_jax():
    from kinetica_tpu.solving.sensitivity import \
        solve_network_sensitivities as jax_solve
    from kinetica_tpu_torch.solving.sensitivity import \
        solve_network_sensitivities
    rids = [0, 7, 42]
    sd, rd, method = _multitile("kinetica_tpu")
    ref = jax_solve(method, sd, rd, rids=rids)
    sd, rd, method = _multitile("kinetica_tpu_torch")
    sens = solve_network_sensitivities(method, sd, rd, rids=rids,
                                       device="cpu")
    assert sens.u.shape == (2, 181)
    scale = np.abs(ref.S).max()
    assert scale > 0
    rel = np.abs(sens.S - ref.S).max() / scale
    print(f"multi-tile port S vs the JAX package's: {rel:.2e} of max|S|")
    assert rel <= 2e-2
