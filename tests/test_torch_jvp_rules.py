"""The four forward-mode rules of the port's kernel wrappers against
``jax.jvp`` of the JAX package's functions, on the same numpy-seeded
primals and tangents.

The Pallas kernels run as the JAX package's own tests run them on the
CPU: ``pallas_linalg._gj_call`` forced to interpret mode (rules 1-2 reach
it through the registered ``custom_jvp``), ``interpret=True`` for the
fused solve and the DD contraction. Bounds, the reference tests':

* rules 1 and 2 (-M dA M on the Gauss-Jordan / Schur inverse and on the
  refined factor): rtol 1e-3, atol 1e-4 of the tangent's scale;
* rule 3 (one more solve on db + dc J dy + c dJ dy): atol 1e-5 relative
  to the tangent's scale;
* rule 4 (``dr @ N``): 1e-12 relative to sum_j |N_js dr_j|.

A gated factor rebuild leaves the lanes it skips with zero tangents (no
``prev``) or their old ones, and a dual tensor into the fused RHS or the
grid probe raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad as fwAD

torch.set_num_threads(1)


@pytest.fixture
def gj_interpret(monkeypatch):
    """The Pallas GJ kernel through the interpreter, as
    ``tests/test_pallas_linalg.py::test_gj_inverse_jvp_registered_rule``."""
    from kinetica_tpu.ops import pallas_linalg as plg
    real = plg._gj_call
    monkeypatch.setattr(plg, "_gj_call", lambda A, interpret: real(A, True))
    return plg


def _jvp_port(fn, primals, tangents):
    with fwAD.dual_level():
        duals = [fwAD.make_dual(p, t) if t is not None else p
                 for p, t in zip(primals, tangents)]
        out = fn(*duals)
        p, t = fwAD.unpack_dual(out)
        return p.numpy(), (None if t is None else t.numpy())


def _well_conditioned(B, n, seed):
    rng = np.random.default_rng(seed)
    A = np.eye(n) + 0.3 / np.sqrt(n) * rng.standard_normal((B, n, n))
    dA = rng.standard_normal((B, n, n))
    return A.astype(np.float32), dA.astype(np.float32)


def _assert_rule12(dM, dM_ref):
    scale = np.abs(dM_ref).max()
    np.testing.assert_allclose(dM, dM_ref, rtol=1e-3, atol=1e-4 * scale)


@pytest.mark.parametrize("n", [6, 73])
def test_rule1_gj_inverse(gj_interpret, n):
    from kinetica_tpu_torch.ops.gj_inverse import gj_inverse
    A, dA = _well_conditioned(3, n, seed=n)
    _, dM_ref = jax.jvp(jax.vmap(gj_interpret.gj_inverse),
                        (jnp.asarray(A),), (jnp.asarray(dA),))
    M, dM = _jvp_port(gj_inverse, [torch.as_tensor(A)], [torch.as_tensor(dA)])
    assert dM.dtype == np.float32
    _assert_rule12(dM, np.asarray(dM_ref))
    # the rule's own algebra on the port's primal
    np.testing.assert_allclose(dM, -(M @ dA @ M), rtol=1e-5,
                               atol=1e-6 * np.abs(dM).max())


def test_rule1_schur_inverse(gj_interpret):
    """n = 181 (128 + 53): the reference's tangent is its rule composed
    with the Schur matmuls; the port's Schur carries the rule itself."""
    from kinetica_tpu_torch.ops.gj_inverse import (schur_inverse,
                                                   schur_inverse_plain)
    A, dA = _well_conditioned(2, 181, seed=5)
    _, dM_ref = jax.jvp(jax.vmap(gj_interpret.schur_inverse),
                        (jnp.asarray(A),), (jnp.asarray(dA),))
    for fn in (schur_inverse, schur_inverse_plain):
        _, dM = _jvp_port(fn, [torch.as_tensor(A)], [torch.as_tensor(dA)])
        _assert_rule12(dM, np.asarray(dM_ref))


def _newton_batch(B, n, seed):
    """Stiff Newton matrices A = I - c J as the solver builds them (f64)."""
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((B, n, n)) * 10.0 ** rng.uniform(-2, 3, (B, n, 1))
    J -= np.eye(n) * (np.abs(J).sum(axis=2, keepdims=True) + 1.0)
    c = 10.0 ** rng.uniform(-4, -2, B)
    return J, c, rng.standard_normal((B, n, n)), rng.standard_normal(B)


@pytest.mark.parametrize("n", [7, 73])
def test_rule2_factor(n):
    """``linalg._inv_factor`` on a dual A against the reference's gated
    factor ``_inv_factor_diff`` (every lane needing), differentiated by
    ``jax.jvp``."""
    from kinetica_tpu.ops.linalg import _inv_factor_diff
    from kinetica_tpu_torch.ops.linalg import _inv_factor
    J, c, dJ, _ = _newton_batch(4, n, seed=n)
    A = np.eye(n) - c[:, None, None] * J
    dA = -c[:, None, None] * dJ
    need = jnp.ones(4, bool)
    _, dM_ref = jax.jvp(
        lambda a: jax.vmap(_inv_factor_diff, in_axes=(0, 0))(a, need),
        (jnp.asarray(A),), (jnp.asarray(dA),))
    _, dM = _jvp_port(_inv_factor, [torch.as_tensor(A)], [torch.as_tensor(dA)])
    assert dM.dtype == np.float32
    _assert_rule12(dM, np.asarray(dM_ref))


def test_rule2_gated_lanes():
    """``newton_factor(need=...)``: the rebuilt lanes carry -M dA M with
    dA = -(dc J + c dJ) (the reference's, through ``jax.jvp``), the
    skipped lanes zero without ``prev`` and their old tangent with it."""
    from kinetica_tpu.ops.linalg import _inv_factor_diff
    from kinetica_tpu_torch.ops.linalg import NewtonFactors, newton_factor
    B, n = 8, 9
    J, c, dJ, dc = _newton_batch(B, n, seed=3)
    need = np.zeros(B, bool)
    need[[1, 4, 6]] = True
    A = np.eye(n) - c[:, None, None] * J
    dA = -(dc[:, None, None] * J + c[:, None, None] * dJ)
    _, dM_ref = jax.jvp(
        lambda a: jax.vmap(_inv_factor_diff, in_axes=(0, 0))(
            a, jnp.ones(B, bool)), (jnp.asarray(A),), (jnp.asarray(dA),))
    dM_ref = np.asarray(dM_ref)
    mask = torch.as_tensor(need)
    old = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (B, n, n)), dtype=torch.float32)
    d_old = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (B, n, n)), dtype=torch.float32)
    with fwAD.dual_level():
        Jd = fwAD.make_dual(torch.as_tensor(J), torch.as_tensor(dJ))
        cd = fwAD.make_dual(torch.as_tensor(c), torch.as_tensor(dc))
        cold = newton_factor(Jd, cd, need=mask)
        prev = NewtonFactors(lu=fwAD.make_dual(old, d_old), piv=None, J=Jd,
                             c=cd)
        warm = newton_factor(Jd, cd, need=mask, prev=prev)
        t_cold = fwAD.unpack_dual(cold.lu).tangent.numpy()
        t_warm = fwAD.unpack_dual(warm.lu).tangent.numpy()
    for t in (t_cold, t_warm):
        _assert_rule12(t[need], dM_ref[need])
    assert np.all(t_cold[~need] == 0.0)
    np.testing.assert_array_equal(t_warm[~need], d_old.numpy()[~need])


def _solve_batch(B, n, seed):
    """As ``tests/test_pallas_linalg.py::TestFusedNewtonSolve._mk``, with
    tangents for every input."""
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((B, n, n)).astype(np.float32)
    c = np.full(B, 0.05)
    b = rng.standard_normal((B, n))
    A = np.eye(n)[None] - c[:, None, None] * J.astype(np.float64)
    M = np.linalg.inv(A).astype(np.float32)
    tangents = (rng.standard_normal((B, n, n)).astype(np.float32),
                rng.standard_normal((B, n, n)).astype(np.float32),
                rng.standard_normal((B, n)), 0.01 * rng.standard_normal(B))
    return (M, J, b, c), tangents


@pytest.mark.parametrize("B", [1, 4])
def test_rule3_fused_newton_solve(B):
    from kinetica_tpu.ops import pallas_linalg as plg
    from kinetica_tpu_torch.ops.newton_solve import (fused_newton_solve,
                                                     fused_newton_solve_plain)
    n = 12
    primals, tangents = _solve_batch(B, n, seed=B)
    _, ddy_ref = jax.jvp(
        jax.vmap(lambda *t: plg.fused_newton_solve(*t, interpret=True)),
        tuple(map(jnp.asarray, primals)), tuple(map(jnp.asarray, tangents)))
    ddy_ref = np.asarray(ddy_ref)
    scale = np.abs(ddy_ref).max()
    tp = [torch.as_tensor(x) for x in primals]
    tt = [torch.as_tensor(x) for x in tangents]
    for fn in (fused_newton_solve, fused_newton_solve_plain):
        _, ddy = _jvp_port(fn, tp, tt)
        np.testing.assert_allclose(ddy / scale, ddy_ref / scale, rtol=0,
                                   atol=1e-5)
    # dM is dropped: a tangent on M alone leaves dy's tangent zero
    _, ddy_m = _jvp_port(fused_newton_solve, tp, [tt[0], None, None, None])
    assert np.all(ddy_m == 0.0)


def test_rule4_dd_contract():
    from kinetica_tpu.models.mass_action import build_mass_action
    from kinetica_tpu.ops.pallas_matmul import DDContraction as JaxDD
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    from kinetica_tpu_torch.ops.dd_contract import DDContraction
    sd, rd, _, _ = synthetic_pyrolysis_network(5)
    N = np.asarray(build_mass_action(rd, sd.n).N)
    rng = np.random.default_rng(4)
    r = 10.0 ** rng.uniform(-14, 1, (3, rd.nr))
    dr = rng.standard_normal((3, rd.nr)) * r
    _, ddu_ref = jax.jvp(JaxDD(N, interpret=True), (jnp.asarray(r),),
                         (jnp.asarray(dr),))
    dd = DDContraction(N, "cpu")
    bound = 1e-12 * (np.abs(dr) @ np.abs(N))
    for fn in (dd, dd.plain):
        du, ddu = _jvp_port(fn, [torch.as_tensor(r)], [torch.as_tensor(dr)])
        assert np.all(np.abs(ddu - np.asarray(ddu_ref)) <= bound)
        np.testing.assert_array_equal(du, dd(torch.as_tensor(r)).numpy())


def test_rules_without_tangent_are_the_plain_call():
    """No dual input: every wrapper returns the untouched primal."""
    from kinetica_tpu_torch.ops.gj_inverse import gj_inverse, gj_inverse_plain
    A, _ = _well_conditioned(2, 5, seed=0)
    At = torch.as_tensor(A)
    with fwAD.dual_level():
        out = gj_inverse(At)
        assert fwAD.unpack_dual(out).tangent is None
    np.testing.assert_array_equal(out.numpy(), gj_inverse_plain(At).numpy())


def test_kernels_without_rule_refuse_dual_inputs():
    from kinetica_tpu.models.mass_action import build_mass_action
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    from kinetica_tpu_torch.ops.grid_probe import grid_probe
    sd, rd, _, _ = synthetic_pyrolysis_network(4)
    net = build_mass_action(rd, sd.n)
    rhs = FusedMassActionRHS(np.asarray(net.N), np.asarray(net.reac_slots),
                             "cpu")
    u_aug = torch.rand(2, sd.n + 1, dtype=torch.float64)
    k = torch.rand(2, rd.nr, dtype=torch.float64)
    with fwAD.dual_level():
        with pytest.raises(RuntimeError, match="fused_rhs"):
            rhs(u_aug, fwAD.make_dual(k, torch.ones_like(k)))
        with pytest.raises(RuntimeError, match="fused_rhs"):
            rhs(fwAD.make_dual(u_aug, torch.ones_like(u_aug)), k)
        x = torch.ones(8, 128)
        with pytest.raises(RuntimeError, match="grid_probe"):
            grid_probe(fwAD.make_dual(x, torch.ones_like(x)))
        # the primal path is untouched
        assert rhs(u_aug, k).shape == (2, sd.n)
