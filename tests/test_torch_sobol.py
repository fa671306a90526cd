"""Sobol indices (``analysis/sobol.py``) of the port against the JAX
package: the Saltelli design and the estimators bit for bit (pure
numpy), and the whole pipeline on the chain CRN of
``tests/test_screening.py`` (same design, each package's own ensemble):
S1 and ST within 1e-6 absolute, with the reference's assertions on the
port's result.
"""
import numpy as np
import torch

from test_torch_screening import chain_network, make_method, run_both

torch.set_num_threads(1)


def test_design_and_estimators_match_reference():
    from kinetica_tpu.analysis import sobol as jsobol
    from kinetica_tpu_torch.analysis.sobol import (saltelli_design,
                                                   sobol_indices_from_values)
    X = saltelli_design(3, 64, seed=1)
    np.testing.assert_array_equal(X, jsobol.saltelli_design(3, 64, seed=1))
    assert X.shape == (64 * 5, 3)
    rng = np.random.default_rng(0)
    a = np.array([1.0, 2.0, 0.5])
    A, B = X[:64], X[64:128]
    f = (X - 0.5) @ a + 0.3 * (X[:, 0] - 0.5) * (X[:, 1] - 0.5)
    fA, fB, fAB = f[:64], f[64:128], f[128:].reshape(3, 64)
    fAB[1, rng.choice(64, 10, replace=False)] = np.nan
    out = sobol_indices_from_values(fA, fB, fAB)
    ref = jsobol.sobol_indices_from_values(fA, fB, fAB)
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x, y)
    assert out[4].tolist() == [64, 54, 64]


def test_rate_limiting_dominates():
    from kinetica_tpu_torch.analysis.sobol import SobolResult
    (res, sd, rd), (ref, _, _) = run_both(
        "sobol_sensitivity", "sobol", objective="CCC", n_samples=32,
        span_decades=1.0, seed=2)
    assert isinstance(res, SobolResult)
    np.testing.assert_allclose(res.S1, ref.S1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.ST, ref.ST, rtol=0, atol=1e-6)
    assert res.failed_points == 0
    assert res.ranking()[0] == 0 and res.ST[0] > 0.8
    assert abs(res.S1[2]) < 0.02 and abs(res.ST[2]) < 0.02
    assert np.all(res.ST >= res.S1 - 0.05)
    s = res.summarise(sd, rd)
    assert "ST=" in s and "Sobol" in s


def test_subset_rids_and_export():
    import kinetica_tpu_torch as kt
    from kinetica_tpu_torch.analysis.sobol import (SobolResult,
                                                   sobol_sensitivity)
    sd, rd, calc = chain_network()
    res = sobol_sensitivity(make_method(calc), sd, rd, objective="CCC",
                            rids=[0, 1], n_samples=16, seed=4, device="cpu")
    assert res.rids.tolist() == [0, 1] and res.S1.shape == (2,)
    assert kt.sobol_sensitivity is sobol_sensitivity
    assert kt.SobolResult is SobolResult
    assert kt.saltelli_design is not None
    assert kt.sobol_indices_from_values is not None
