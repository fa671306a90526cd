"""The port's examples (``kinetica_tpu_torch/examples``) against the JAX
package's, on the CPU at a small size.

* ``pyrolysis_sweep`` at nc=4, B=2: the port's example against the JAX
  example's computation (the same ``EnsembleProblem`` sweep through the
  JAX package): final states within 1e-8 of the largest entry; the
  port's two solves equal bit for bit;
* every example's ``main`` defaults to the card and raises without one.

``analysis_pipeline`` is in ``tests/test_torch_examples_analysis.py``,
the exploring examples in ``tests/test_torch_examples_explore.py`` (each
file stays near a minute on one worker).
Run as a script (``python tests/test_torch_examples.py``), this file
prints the JAX examples' records that
``kinetica_tpu_torch/testing/example_records.py`` pins (about 100 s on a
CPU: the JAX examples at their published settings are too slow for
tier 1).
"""
import importlib
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pyrolysis_sweep_matches_jax():
    from kinetica_tpu.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu.conditions.condition_set import ConditionSet
    from kinetica_tpu.conditions.profiles import LinearGradientProfile
    from kinetica_tpu.parallel.batching import EnsembleProblem
    from kinetica_tpu.solving.methods import VariableODESolve
    from kinetica_tpu.solving.params import ODESimulationParams
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    from kinetica_tpu_torch.examples import pyrolysis_sweep

    out = pyrolysis_sweep.main(batch=2, n_carbons=4, device="cpu")
    assert out.ens.success
    np.testing.assert_array_equal(out.first.u, out.ens.u)

    # the JAX example's computation at the same size
    tf = pyrolysis_sweep.TF
    sd, rd, Ea, A = synthetic_pyrolysis_network(4)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12)
    conds = [ConditionSet({"T": LinearGradientProfile(
        rate=float(r), X_start=500.0, X_end=500.0 + float(r) * tf)},
        ts_update=0.25) for r in np.linspace(40.0, 60.0, 2)]
    pars = ODESimulationParams(tspan=(0.0, tf), u0={"C4": 1.0},
                               solve_chunks=True, solve_chunkstep=0.5,
                               low_k_cutoff="none")
    ens = EnsembleProblem(VariableODESolve(pars, conds[0], calc), sd,
                          rd).solve(conditions_list=conds)
    ref = np.asarray(ens.u)[:, -1]
    assert ens.success and out.ens.u.shape == np.asarray(ens.u).shape
    assert np.abs(out.ens.u[:, -1] - ref).max() <= 1e-8 * np.abs(ref).max()


EXAMPLES = ["getting_started", "pyrolysis_sweep", "analysis_pipeline",
            "iterative_exploration", "full_product"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name):
    """Each example's ``main`` and ``--device`` default to ``cuda``; without
    a card ``main()`` raises before it does any work."""
    import inspect
    mod = importlib.import_module(f"kinetica_tpu_torch.examples.{name}")
    assert inspect.signature(mod.main).parameters["device"].default == "cuda"
    from kinetica_tpu_torch.examples import parser
    assert parser(mod.__doc__).parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main()


def test_mock_cde_is_executable():
    from kinetica_tpu_torch.examples.getting_started import MOCK_CDE
    with open(MOCK_CDE) as fh:
        assert fh.readline().startswith("#!")
    assert os.access(MOCK_CDE, os.X_OK)


def jax_example_records():
    """The JAX examples' explored networks at their published settings
    (and ``full_product`` at ``tests/test_full_product.py``'s size), from a
    CPU run of each."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import full_product
    import getting_started
    import iterative_exploration
    from kinetica_tpu.core.network import format_rxn

    def network(res, em=None):
        sd, rd = res.sd, res.rd
        out = dict(species=[sd.toStr[i] for i in range(sd.n)],
                   reactions=[format_rxn(sd, rd, i) for i in range(rd.nr)],
                   u_final=[float(x) for x in np.asarray(res.sol.u)[-1]])
        if em is not None:
            out["levels"] = [(t["n_species"], t["n_reactions"])
                             for t in em.timings]
        return out

    def capture(module):
        got = {}
        orig = module.explore_network

        def explore(em, sm, **kw):
            if getattr(em, "timings", 0) is None:
                em.timings = []
            got["em"], got["res"] = em, orig(em, sm, **kw)
            return got["res"]
        module.explore_network = explore
        return got

    records = {}
    got = capture(getting_started)
    getting_started.main()
    records["GETTING_STARTED"] = network(got["res"])
    got = capture(iterative_exploration)
    iterative_exploration.main()
    records["ITERATIVE_EXPLORATION"] = network(got["res"], got["em"])
    for key, kw in (("FULL_PRODUCT", {}),
                    ("FULL_PRODUCT_SMALL", dict(n_sweep=3, max_levels=2,
                                                reduce_tol=0.5))):
        got = capture(full_product)
        orig_red = full_product.reduce_network_drgep

        def reduce(*a, **k):
            got["target"] = k["targets"][0]
            return orig_red(*a, **k)
        full_product.reduce_network_drgep = reduce
        try:
            sd, rd, mres, red = full_product.main(quiet=True, **kw)
            rec = dict(keep_rids=[int(r) for r in red.reduction.keep_rids],
                       error=float(red.error),
                       mu_star=[float(x) for x in mres.mu_star])
        except ValueError as exc:
            rec = dict(drgep_refused=str(exc))
        finally:
            full_product.reduce_network_drgep = orig_red
        records[key] = dict(network(got["res"], got["em"]),
                            target=got["target"], **rec)
    return records


if __name__ == "__main__":
    import pprint
    for name, rec in jax_example_records().items():
        print(f"{name} = " + pprint.pformat(rec, width=78, sort_dicts=False))
