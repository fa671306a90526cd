"""The port's mass-action model against ``kinetica_tpu.models.mass_action``.

Both packages get the JAX package's own network arrays (through
``MassActionNetwork.from_numpy``) and the same numpy-seeded states: u
spans 1e-14..1 with exact zeros and small negatives, k comes from the
Arrhenius calculator at 700-1300 K.

Tolerances: f64 quantities to 1e-12 relative to the sum of the absolute
terms of each entry (the two packages sum in different orders); the f32
Jacobian to 1e-5 relative to each column's largest entry (f32 products
summed in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

B = 5


def _case(nc, seed):
    from kinetica_tpu.calculators.builtin import PrecalculatedArrheniusCalculator
    from kinetica_tpu.models.mass_action import build_mass_action
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    from kinetica_tpu_torch.models.mass_action import MassActionNetwork
    sd, rd, Ea, A = synthetic_pyrolysis_network(nc)
    jnet = build_mass_action(rd, sd.n, clip_delta=1e-12)
    tnet = MassActionNetwork.from_numpy(np.asarray(jnet.reac_slots),
                                        np.asarray(jnet.N), delta=jnet.delta,
                                        device="cpu")
    rng = np.random.default_rng(seed)
    u = 10.0 ** rng.uniform(-14, 0, (B, sd.n))
    u[rng.random((B, sd.n)) < 0.15] = 0.0
    neg = rng.random((B, sd.n)) < 0.1
    u[neg] = -10.0 ** rng.uniform(-16, -11, neg.sum())
    T = rng.uniform(700.0, 1300.0, B)
    k = np.array(PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12)(
        jnp.asarray(T)))
    return jnet, tnet, u, k


def _terms_bound(N, r):
    """Per-entry sum of |N_js r_j| over reactions: (B, ns)."""
    return np.abs(r) @ np.abs(N)


@pytest.mark.parametrize("nc", [6, 24])
def test_rates_and_rhs(nc):
    jnet, tnet, u, k = _case(nc, seed=nc)
    r0 = np.asarray(jax.vmap(jnet.rates)(jnp.asarray(u), jnp.asarray(k)))
    du0 = np.asarray(jax.vmap(jnet.rhs)(jnp.asarray(u), jnp.asarray(k)))
    ut, kt = torch.as_tensor(u), torch.as_tensor(k)
    r1 = tnet.rates(ut, kt).numpy()
    du1 = tnet.rhs(ut, kt).numpy()
    np.testing.assert_allclose(r1, r0, rtol=1e-12, atol=0)
    bound = _terms_bound(np.asarray(jnet.N), r0)
    assert np.all(np.abs(du1 - du0) <= 1e-12 * bound + 1e-300)


@pytest.mark.parametrize("nc", [6, 24])
def test_jac_f64(nc):
    jnet, tnet, u, k = _case(nc, seed=100 + nc)
    J0 = np.asarray(jax.vmap(jnet.jac)(jnp.asarray(u), jnp.asarray(k)))
    J1 = tnet.jac(torch.as_tensor(u), torch.as_tensor(k)).numpy()
    assert J1.shape == (B, tnet.ns, tnet.ns) and J1.dtype == np.float64
    # sum of |terms| of J[i, m], bounded above by the same contraction
    # with |N| and |u| (clip and chain factors only grow under |u|)
    Nabs = jnet.__class__(jnet.reac_slots, jnp.abs(jnet.N), delta=jnet.delta)
    bound = np.asarray(jax.vmap(Nabs.jac)(jnp.asarray(np.abs(u)),
                                          jnp.asarray(k)))
    assert np.all(np.abs(J1 - J0) <= 1e-12 * bound + 1e-300)


@pytest.mark.parametrize("nc", [6, 24])
def test_jac_matmul_f32(nc):
    from kinetica_tpu.models.mass_action import MassActionNetwork as JNet
    jnet, tnet, u, k = _case(nc, seed=200 + nc)
    jnet32 = JNet(jnet.reac_slots, jnet.N.astype(jnp.float32), delta=jnet.delta)
    J0 = np.asarray(jax.vmap(jnet32.jac_matmul)(
        jnp.asarray(u, jnp.float32), jnp.asarray(k, jnp.float32)))
    tnet32 = tnet.to_dtype(torch.float32)
    J1 = tnet32.jac_matmul(torch.as_tensor(u).float(),
                           torch.as_tensor(k).float()).numpy()
    assert J1.dtype == np.float32
    colmax = np.abs(J0).max(axis=1, keepdims=True)
    assert np.all(np.abs(J1 - J0) <= 1e-5 * colmax)


def test_clip_pos_matches():
    from kinetica_tpu.models.mass_action import _clip_pos, _clip_pos_grad
    from kinetica_tpu_torch.models.mass_action import _clip_pos as c1
    from kinetica_tpu_torch.models.mass_action import _clip_pos_grad as g1
    x = np.concatenate([-np.logspace(-16, 0, 9), [0.0], np.logspace(-16, 0, 9)])
    np.testing.assert_allclose(c1(torch.as_tensor(x), 1e-12).numpy(),
                               np.asarray(_clip_pos(jnp.asarray(x), 1e-12)),
                               rtol=1e-15, atol=0)
    np.testing.assert_allclose(g1(torch.as_tensor(x), 1e-12).numpy(),
                               np.asarray(_clip_pos_grad(jnp.asarray(x), 1e-12)),
                               rtol=1e-15, atol=0)


def test_pad_reactions_is_inert():
    from kinetica_tpu_torch.models.mass_action import pad_reactions
    _, tnet, u, k = _case(6, seed=7)
    padded = pad_reactions(tnet, tnet.nr + 5)
    kp = torch.cat([torch.as_tensor(k), torch.zeros(B, 5, dtype=torch.float64)], 1)
    ut = torch.as_tensor(u)
    assert padded.nr == tnet.nr + 5
    torch.testing.assert_close(padded.rhs(ut, kp), tnet.rhs(ut, torch.as_tensor(k)),
                               rtol=0, atol=0)
    torch.testing.assert_close(padded.jac(ut, kp), tnet.jac(ut, torch.as_tensor(k)),
                               rtol=0, atol=0)
