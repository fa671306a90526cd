"""The port's small public helpers against the JAX package's.

* ``ops.interp.linear_interp`` against ``kinetica_tpu.ops.interp.
  linear_interp`` on numpy-seeded sorted grids, with queries past both
  ends (clamped) and repeated knots (an interval of zero width), to
  1e-15 of the table's scale;
* ``conditions.profiles.isgradientprofile`` / ``isdirectprofile`` on all
  seven profile classes, equal to the JAX package's answers;
* ``models.mass_action.fd_jacobian`` (forward-mode autodiff of
  ``net.rhs``) against the analytic ``jac_segsum`` and the JAX
  ``fd_jacobian`` on ``synthetic_pyrolysis_network(4)``, to 1e-12 of the
  per-entry sum of |terms| (the sums run in different orders);
* ``ops.bdf.time_dtype``: f64 for an f32 and an f64 state, as the JAX
  package's with x64 on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _grid(rng, nt, repeats):
    t = np.sort(rng.uniform(-3.0, 7.0, nt))
    if repeats:
        # repeated knots, the last one included
        for i in rng.choice(nt - 1, repeats, replace=False):
            t[i + 1] = t[i]
        t[-1] = t[-2]
    return t


@pytest.mark.parametrize("repeats", [0, 3])
@pytest.mark.parametrize("trailing", [(), (4,), (3, 2)])
def test_linear_interp_matches_jax(repeats, trailing):
    from kinetica_tpu.ops.interp import linear_interp as ref
    from kinetica_tpu_torch.ops.interp import linear_interp
    rng = np.random.default_rng(10 * repeats + len(trailing))
    t = _grid(rng, 12, repeats)
    u = rng.standard_normal((t.size,) + trailing)
    # past both ends, on every knot, and between them
    tq = np.concatenate([[t[0] - 2.0, t[-1] + 2.0], t,
                         rng.uniform(t[0], t[-1], 40)])
    scale = np.abs(u).max()
    got = linear_interp(torch.as_tensor(tq), torch.as_tensor(t),
                        torch.as_tensor(u)).numpy()
    want = np.asarray(jax.vmap(lambda q: ref(q, jnp.asarray(t),
                                             jnp.asarray(u)))(jnp.asarray(tq)))
    assert got.shape == (tq.size,) + trailing
    assert np.abs(got - want).max() <= 1e-15 * scale
    # clamped ends exactly: the first and last rows, or at a repeated end
    # knot the row the zero-width interval's rule picks, as in JAX
    np.testing.assert_array_equal(got[:2], want[:2])
    if not repeats:
        np.testing.assert_array_equal(got[0], u[0])
        np.testing.assert_array_equal(got[1], u[-1])
    # a scalar query gives one row
    one = linear_interp(float(tq[5]), torch.as_tensor(t), torch.as_tensor(u))
    assert one.shape == trailing
    assert np.abs(one.numpy() - want[5]).max() <= 1e-15 * scale


PROFILES = {
    "StaticConditionProfile": dict(value=800.0),
    "NullDirectProfile": dict(X_start=640.0, t_end=14.0),
    "LinearDirectProfile": dict(rate=45.0, X_start=500.0, X_end=1130.0),
    "SawtoothDirectProfile": dict(amplitude=50.0, period=2.0, X_mid=900.0,
                                  n_periods=3),
    "NullGradientProfile": dict(X_start=640.0, t_end=14.0),
    "LinearGradientProfile": dict(rate=45.0, X_start=500.0, X_end=1130.0),
    "DoubleRampGradientProfile": dict(
        X_start=500.0, t_start_plateau=1.0, rate1=50.0, X_mid=800.0,
        t_mid_plateau=2.0, rate2=-30.0, X_end=650.0, t_end_plateau=1.5),
}


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_profile_predicates_match_jax(name):
    from kinetica_tpu.conditions import profiles as jp
    from kinetica_tpu_torch.conditions import profiles as tp
    pj = getattr(jp, name)(**PROFILES[name])
    pt = getattr(tp, name)(**PROFILES[name])
    for pred in ("isgradientprofile", "isdirectprofile", "isstatic",
                 "isvariable"):
        assert getattr(tp, pred)(pt) == getattr(jp, pred)(pj), pred
    assert tp.isgradientprofile(pt) == name.endswith("GradientProfile")
    assert tp.isdirectprofile(pt) == name.endswith("DirectProfile")


def test_fd_jacobian_matches_analytic_and_jax():
    from kinetica_tpu.calculators.builtin import PrecalculatedArrheniusCalculator
    from kinetica_tpu.models.mass_action import build_mass_action as jbuild
    from kinetica_tpu.models.mass_action import fd_jacobian as jfd
    from kinetica_tpu_torch.models.mass_action import (MassActionNetwork,
                                                       fd_jacobian)
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(4)
    jnet = jbuild(rd, sd.n)
    tnet = MassActionNetwork.from_numpy(np.asarray(jnet.reac_slots),
                                        np.asarray(jnet.N), delta=jnet.delta,
                                        device="cpu")
    Nabs = MassActionNetwork.from_numpy(np.asarray(jnet.reac_slots),
                                        np.abs(np.asarray(jnet.N)),
                                        delta=jnet.delta, device="cpu")
    rng = np.random.default_rng(4)
    B = 4
    u = 10.0 ** rng.uniform(-14, 0, (B, sd.n))
    u[rng.random((B, sd.n)) < 0.15] = 0.0
    k = np.asarray(PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12)(
        jnp.asarray(rng.uniform(700.0, 1300.0, B))))
    ut, kt = torch.as_tensor(u), torch.as_tensor(k)
    J = fd_jacobian(tnet, ut, kt).numpy()
    assert J.shape == (B, sd.n, sd.n) and J.dtype == np.float64
    bound = Nabs.jac_segsum(ut.abs(), kt).numpy()
    assert np.all(np.abs(J - tnet.jac_segsum(ut, kt).numpy())
                  <= 1e-12 * bound + 1e-300)
    for b in range(B):
        Jj = np.asarray(jfd(jnet, jnp.asarray(u[b]), jnp.asarray(k[b])))
        Jb = fd_jacobian(tnet, ut[b], kt[b]).numpy()
        assert Jb.shape == (sd.n, sd.n)
        assert np.all(np.abs(Jb - Jj) <= 1e-12 * bound[b] + 1e-300)
        np.testing.assert_array_equal(Jb, J[b])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_time_dtype(dtype):
    from kinetica_tpu.ops.bdf import time_dtype as jtd
    from kinetica_tpu_torch.ops.bdf import time_dtype
    assert time_dtype(getattr(torch, dtype)) == torch.float64
    assert jtd(getattr(jnp, dtype)) == jnp.float64
