"""The double-ramp and sawtooth profiles and the Lindemann calculator
against the JAX package's classes.

Same constructor arguments on both sides, evaluated on a time grid that
includes every corner and blend edge: values and gradients within 1e-12 of
the profile's scale, tstops (also after ``create_discrete_tstops``)
exactly equal. The batched theta path (``value_theta``, what the
continuous ensemble evaluates) must give each member's own value. The
Lindemann rates across T and P within 1e-12 relative, with and without
``k_max``; ``strict_reference_parity`` raises on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

RAMP = dict(X_start=500.0, t_start_plateau=1.0, rate1=50.0, X_mid=800.0,
            t_mid_plateau=2.0, rate2=-30.0, X_end=650.0, t_end_plateau=1.5)
SAW = dict(amplitude=50.0, period=2.0, X_mid=900.0, n_periods=3)


def _pair(name, **kw):
    from kinetica_tpu.conditions import profiles as jp
    from kinetica_tpu_torch.conditions import profiles as tp
    return getattr(jp, name)(**kw), getattr(tp, name)(**kw)


def _grid(p):
    """A dense grid past both ends, plus every stop and a point either
    side of it."""
    stops = np.asarray(p.tstops, dtype=np.float64)
    t = np.concatenate([np.linspace(-0.5, p.t_end + 1.0, 801), stops,
                        stops - 1e-9, stops + 1e-9])
    return np.sort(t)


def _close(a, b, scale):
    return np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-12 * scale


CASES = {
    "double_ramp": ("DoubleRampGradientProfile", RAMP),
    "double_ramp_blended": ("DoubleRampGradientProfile", dict(RAMP, t_blend=0.4)),
    "sawtooth": ("SawtoothDirectProfile", SAW),
    "sawtooth_x_start": ("SawtoothDirectProfile", dict(SAW, X_start=870.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_values_and_gradients_match_jax(case):
    name, kw = CASES[case]
    pj, pt = _pair(name, **kw)
    t = _grid(pj)
    assert _close(pt.value(t).numpy(), pj.value(jnp.asarray(t)), 1e3)
    if name.startswith("DoubleRamp"):
        assert _close(pt.grad(t).numpy(), pj.grad(jnp.asarray(t)), 50.0)
    np.testing.assert_array_equal(pt.tstops, pj.tstops)
    assert pt.t_end == pj.t_end
    np.testing.assert_array_equal(pt.theta(), pj.theta())
    assert pt.static_key() == pj.static_key()


@pytest.mark.parametrize("case", list(CASES))
def test_discrete_tstops_match_jax(case):
    name, kw = CASES[case]
    pj, pt = _pair(name, **kw)
    for p in (pj, pt):
        p.create_discrete_tstops(0.25)
    np.testing.assert_array_equal(pt.tstops, pj.tstops)
    for p in (pj, pt):
        with pytest.raises(ValueError):
            p.create_discrete_tstops(p.t_end * 2)


@pytest.mark.parametrize("name,variants", [
    ("DoubleRampGradientProfile", [RAMP, dict(RAMP, rate1=75.0, X_end=700.0,
                                              t_mid_plateau=0.5)]),
    ("DoubleRampGradientProfile", [dict(RAMP, t_blend=0.4),
                                   dict(RAMP, rate2=-60.0, t_blend=0.2)]),
    ("SawtoothDirectProfile", [SAW, dict(SAW, period=1.5, X_start=870.0)]),
])
def test_value_theta_is_each_members_value(name, variants):
    from kinetica_tpu_torch.conditions import profiles as tp
    cls = getattr(tp, name)
    profs = [cls(**kw) for kw in variants]
    assert len({p.static_key() for p in profs}) == 1
    theta = torch.as_tensor(np.stack([p.theta() for p in profs]))
    for t in np.linspace(0.0, 16.0, 33):
        tb = torch.full((len(profs),), t, dtype=torch.float64)
        got = cls.value_theta(tb, theta, profs[0].static_key()[1:]).numpy()
        want = [float(p.value(t)) for p in profs]
        assert _close(got, want, 1e3)


def test_impossible_ramp_raises():
    from kinetica_tpu_torch.conditions.profiles import DoubleRampGradientProfile
    with pytest.raises(ValueError, match="Impossible"):
        DoubleRampGradientProfile(**dict(RAMP, rate1=-50.0))


def _lindemann(pkg, **kw):
    import importlib
    mod = importlib.import_module(f"{pkg}.calculators.builtin")
    rng = np.random.default_rng(4)
    nr = 40
    Ea = rng.uniform(1.5e5, 3.5e5, nr)
    A_0 = 10.0 ** rng.uniform(-12, -6, nr)
    A_inf = 10.0 ** rng.uniform(12, 16, nr)
    if pkg == "kinetica_tpu_torch":
        kw["device"] = "cpu"
    return mod.PrecalculatedLindemannCalculator(Ea, A_0, A_inf, **kw)


@pytest.mark.parametrize("k_max", [None, 1e8])
def test_lindemann_matches_jax(k_max):
    cj = _lindemann("kinetica_tpu", k_max=k_max)
    ct = _lindemann("kinetica_tpu_torch", k_max=k_max)
    T, P = np.meshgrid(np.linspace(500.0, 2000.0, 16),
                       10.0 ** np.linspace(2.0, 8.0, 13))
    T, P = T.ravel(), P.ravel()
    kt = ct(torch.as_tensor(T), torch.as_tensor(P)).numpy()
    kj = np.asarray(cj(jnp.asarray(T), jnp.asarray(P)))
    assert kt.shape == (T.size, 40)
    np.testing.assert_allclose(kt, kj, rtol=1e-12, atol=0.0)
    # scalar conditions, and the falloff limits: k_inf at high P
    np.testing.assert_allclose(ct(900.0, 101325.0).numpy(),
                               np.asarray(cj(900.0, 101325.0)), rtol=1e-12)
    if k_max is not None:
        assert kt.max() < k_max


def test_lindemann_splice_setup_and_parity():
    from kinetica_tpu_torch.core.network import RxData  # noqa: F401
    cj = _lindemann("kinetica_tpu")
    ct = _lindemann("kinetica_tpu_torch")
    for c in (cj, ct):
        c.splice([0, 5, 39])
    np.testing.assert_array_equal(ct.A_inf, np.asarray(cj.A_inf))
    kt = ct(torch.tensor([800.0]), torch.tensor([1e5])).numpy()
    kj = np.asarray(cj(jnp.asarray([800.0]), jnp.asarray([1e5])))
    assert kt.shape == (1, 37)
    np.testing.assert_allclose(kt, kj, rtol=1e-12)

    class _Rd:
        nr = 36
    with pytest.raises(ValueError, match="does not match"):
        ct.setup_network(None, _Rd())
    _Rd.nr = 37
    ct.setup_network(None, _Rd())
    assert ct.has_conditions(["T", "P"]) and not ct.has_conditions(["X"])
    for pkg in ("kinetica_tpu", "kinetica_tpu_torch"):
        strict = _lindemann(pkg, strict_reference_parity=True)
        with pytest.raises(NotImplementedError):
            strict(900.0, 1e5)
