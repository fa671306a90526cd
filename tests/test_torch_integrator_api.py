"""The port's integrator API against the JAX package's.

``docs/api.md`` lists ``ops.bdf.bdf_solve``, ``ops.linalg.newton_factor`` /
``newton_solve`` and ``ops.rk45.rk45_solve`` as public. Their parameters
(names and order) and the fields of ``BDFResults`` and ``RK45Results``
must be the reference's, read by ``inspect.signature``; the port's own
extra parameters and fields may only follow the reference's.

Behaviour: a 600-species linear decay (wider than the 512-species inverse,
so "auto" must pick the LU) solved with the defaults of both packages,
each within 1e-8 of the exact answer; ``rhs_and_jac`` equal to ``(rhs,
jac)`` bit for bit; ``newton_factor(J, c, torch.float32)`` (the reference's
positional ``lu_dtype``) solving the same system as the JAX package's call
within 1e-5 relative, the f32-Jacobian tolerance of
``tests/test_torch_linalg.py``.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# the port's parameters / fields beyond the reference's
PORT_EXTRA = {
    "bdf_solve": ("on_chunk",),
    "newton_factor": ("prev",),
    "newton_solve": (),
    "rk45_solve": (),
    "BDFResults": (),
    "RK45Results": ("n_fev",),
}


def _functions():
    from kinetica_tpu.ops import bdf as jbdf, linalg as jlinalg, rk45 as jrk45
    from kinetica_tpu_torch.ops import bdf, linalg, rk45
    return {"bdf_solve": (jbdf.bdf_solve, bdf.bdf_solve),
            "newton_factor": (jlinalg.newton_factor, linalg.newton_factor),
            "newton_solve": (jlinalg.newton_solve, linalg.newton_solve),
            "rk45_solve": (jrk45.rk45_solve, rk45.rk45_solve)}


def _params(fn):
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("name", ["bdf_solve", "newton_factor",
                                  "newton_solve", "rk45_solve"])
def test_parameters_in_the_reference_order(name):
    ref, port = _functions()[name]
    assert _params(port) == _params(ref) + list(PORT_EXTRA[name])


@pytest.mark.parametrize("name", ["BDFResults", "RK45Results"])
def test_result_fields_in_the_reference_order(name):
    import importlib
    mod = "bdf" if name == "BDFResults" else "rk45"
    ref = getattr(importlib.import_module(f"kinetica_tpu.ops.{mod}"), name)
    port = getattr(importlib.import_module(f"kinetica_tpu_torch.ops.{mod}"),
                   name)
    assert list(port._fields) == list(ref._fields) + list(PORT_EXTRA[name])


def test_defaults_of_the_shared_parameters():
    """Every shared parameter has the reference's default, except the two
    kept on purpose: ``newton_factor`` / ``newton_solve`` default to
    "inv_gated" where the reference's is "lu" (ROADMAP, Queue 3)."""
    kept = {("newton_factor", "method"), ("newton_solve", "method")}
    for name, (ref, port) in _functions().items():
        rp = inspect.signature(ref).parameters
        pp = inspect.signature(port).parameters
        for p in rp:
            d_ref, d_port = rp[p].default, pp[p].default
            if (name, p) in kept:
                assert (d_ref, d_port) == ("lu", "inv_gated")
            elif d_ref is jnp.float32:
                assert d_port is torch.float32, (name, p)
            else:
                assert d_port == d_ref, (name, p, d_port, d_ref)


N_DECAY, TF_DECAY = 600, 1.0


def _decay_rates():
    return np.logspace(-1.0, 1.0, N_DECAY)


def test_linear_decay_600_species_with_defaults():
    """Above 512 species "auto" is the LU in both packages; the port's old
    default ("inv_gated") raised here."""
    from kinetica_tpu.ops.bdf import bdf_solve as jax_bdf
    from kinetica_tpu_torch.ops.bdf import DONE, bdf_solve
    k = _decay_rates()
    saveat = np.array([0.5, TF_DECAY])
    exact = np.exp(-np.outer(saveat, k))

    kj = jnp.asarray(k)
    res_j = jax_bdf(lambda t, y: -kj * y, lambda t, y: jnp.diag(-kj),
                    jnp.ones(N_DECAY), 0.0, TF_DECAY, jnp.asarray(saveat))
    assert int(res_j.status) == DONE
    assert np.abs(np.asarray(res_j.ys) - exact).max() <= 1e-8

    kt = torch.as_tensor(k)
    res_t = bdf_solve(lambda t, y, pre: -kt * y,
                      lambda t, y, pre: torch.diag(-kt).expand(
                          y.shape[0], -1, -1),
                      torch.ones(1, N_DECAY, dtype=torch.float64), 0.0,
                      TF_DECAY, saveat)
    assert int(res_t.status[0]) == DONE
    assert np.abs(res_t.ys[0].numpy() - exact).max() <= 1e-8
    assert res_t.trace is None


def test_positional_call_binds_the_reference_parameters():
    """``first_step`` is the eleventh parameter in both packages: a call
    that passes it by position starts the solve from that step."""
    from kinetica_tpu_torch.ops.bdf import DONE, bdf_solve
    kt = torch.tensor([1.0, 2.0], dtype=torch.float64)

    def rhs(t, y, pre):
        return -kt * y

    def jac(t, y, pre):
        return torch.diag(-kt).expand(y.shape[0], -1, -1)

    y0 = torch.ones(1, 2, dtype=torch.float64)
    res = bdf_solve(rhs, jac, y0, 0.0, 1.0, [1.0], 1e-8, 1e-10, None, 5000,
                    torch.tensor([1e-7], dtype=torch.float64))
    auto = bdf_solve(rhs, jac, y0, 0.0, 1.0, [1.0])
    assert int(res.status[0]) == DONE
    assert int(res.n_steps[0]) != int(auto.n_steps[0])
    np.testing.assert_allclose(res.ys[0, 0].numpy(), np.exp(-kt.numpy()),
                               rtol=1e-7)


def test_lu_precision_and_refine():
    from kinetica_tpu_torch.ops.bdf import DONE, bdf_solve
    kt = torch.tensor([1.0, 50.0, 2.0], dtype=torch.float64)

    def rhs(t, y, pre):
        return -kt * y

    def jac(t, y, pre):
        return torch.diag(-kt).expand(y.shape[0], -1, -1)

    y0 = torch.ones(2, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="lu_precision='full'"):
        bdf_solve(rhs, jac, y0, 0.0, 1.0, [1.0], lu_precision="full")
    with pytest.raises(ValueError, match="lu_precision must be"):
        bdf_solve(rhs, jac, y0, 0.0, 1.0, [1.0], lu_precision="half")
    full = bdf_solve(rhs, jac, y0, 0.0, 1.0, [1.0], lu_precision="full",
                     linsolve="lu")
    mixed = bdf_solve(rhs, jac, y0, 0.0, 1.0, [1.0], linsolve="lu")
    assert bool((full.status == DONE).all())
    # "lu" is the f64 LU under either precision, and no sweep refines it
    assert torch.equal(full.ys, mixed.ys)
    # "inv_gated" runs its fixed two sweeps whatever ``refine`` is
    a = bdf_solve(rhs, jac, y0, 0.0, 1.0, [1.0], refine=1)
    b = bdf_solve(rhs, jac, y0, 0.0, 1.0, [1.0], refine=3)
    assert torch.equal(a.ys, b.ys)


def test_rhs_and_jac_is_rhs_and_jac():
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.models.mass_action import build_mass_action
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(6)
    net = build_mass_action(rd, sd.n, device="cpu")
    rng = np.random.default_rng(7)
    u = torch.as_tensor(10.0 ** rng.uniform(-10, 0, (3, sd.n)))
    k = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device="cpu")(
        torch.as_tensor(rng.uniform(700, 1300, 3)))
    du, J = net.rhs_and_jac(u, k)
    assert torch.equal(du, net.rhs(u, k))
    assert torch.equal(J, net.jac(u, k))


def _newton_case(B=4, seed=11):
    """Newton systems from the nc=6 mass-action Jacobian (f32, the main
    path's) at random states, as ``tests/test_torch_linalg.py``."""
    from kinetica_tpu.calculators.builtin import PrecalculatedArrheniusCalculator
    from kinetica_tpu.models.mass_action import build_mass_action
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(6)
    net = build_mass_action(rd, sd.n)
    rng = np.random.default_rng(seed)
    u = 10.0 ** rng.uniform(-10, -1, (B, sd.n))
    k = np.asarray(PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12)(
        jnp.asarray(rng.uniform(700, 1300, B))))
    J = np.asarray(jax.vmap(net.jac)(jnp.asarray(u), jnp.asarray(k)))
    return (J.astype(np.float32), 10.0 ** rng.uniform(-10, -8, B),
            rng.standard_normal((B, sd.n)))


def test_newton_factor_positional_lu_dtype():
    """The reference's call ``newton_factor(J, c, jnp.float32)`` (its "lu"
    with refinement) and the port's ``newton_factor(J, c, torch.float32)``
    (its "inv_gated") solve the same f32-Jacobian system to 1e-5."""
    from kinetica_tpu.ops import linalg as jl
    from kinetica_tpu_torch.ops import linalg
    J, c, b = _newton_case()

    def one(J1, c1, b1):
        return jl.newton_solve(jl.newton_factor(J1, c1, jnp.float32), b1)

    dy_ref = np.asarray(jax.vmap(one)(jnp.asarray(J), jnp.asarray(c),
                                      jnp.asarray(b)))
    f = linalg.newton_factor(torch.as_tensor(J), torch.as_tensor(c),
                             torch.float32)
    assert f.lu.dtype == torch.float32
    dy = linalg.newton_solve(f, torch.as_tensor(b), 1).numpy()
    for i in range(len(c)):
        assert (np.abs(dy[i] - dy_ref[i]).max()
                / np.abs(dy_ref[i]).max()) <= 1e-5
    # an f64 factor is the LU's only
    with pytest.raises(ValueError, match="f32 inverse"):
        linalg.newton_factor(torch.as_tensor(J), torch.as_tensor(c),
                             torch.float64)
    f64 = linalg.newton_factor(torch.as_tensor(J), torch.as_tensor(c),
                               torch.float64, "lu")
    dy_lu = linalg.newton_solve(f64, torch.as_tensor(b), 1, "lu").numpy()
    for i in range(len(c)):
        assert (np.abs(dy_lu[i] - dy_ref[i]).max()
                / np.abs(dy_ref[i]).max()) <= 1e-5
