"""The frozen yardstick: the network generator, the plain reference and
the work functions of the rooflines."""
import numpy as np
import pytest
from scipy.integrate import solve_ivp

from benchmark import reference, roofline
from benchmark.network import synthetic_pyrolysis_network


@pytest.mark.parametrize("nc", [6, 24])
def test_generator_matches_the_programs(nc):
    from kinetica_tpu_torch.testing.synthetic import (
        synthetic_pyrolysis_network as program_generator)
    net = synthetic_pyrolysis_network(nc)
    sd, rd, Ea, A = program_generator(nc)
    assert (net.nr, net.ns) == (rd.nr, sd.n)
    assert list(net.species) == [sd.toStr[i] for i in range(sd.n)]
    np.testing.assert_array_equal(net.Ea, Ea)
    np.testing.assert_array_equal(net.A, A)

    def expand(ids, stoic):
        return sorted(i for i, s in zip(ids, stoic) for _ in range(s))
    assert [sorted(r) for r in net.reactants] == [
        expand(i, s) for i, s in zip(rd.id_reacs, rd.stoic_reacs)]
    assert [sorted(p) for p in net.products] == [
        expand(i, s) for i, s in zip(rd.id_prods, rd.stoic_prods)]


@pytest.mark.parametrize("nc,nr,ns", [(24, 1095, 73), (60, 4473, 181)])
def test_configuration_sizes(nc, nr, ns):
    net = synthetic_pyrolysis_network(nc)
    assert (net.nr, net.ns) == (nr, ns)


def _dense_rhs(net, k_of_t):
    N = net.stoichiometry()
    slots = net.slots()

    def f(t, y):
        u = np.append(y, 1.0)
        s = np.where(slots < 0, net.ns, slots)
        return (k_of_t(t) * u[s].prod(axis=1)) @ N
    return f


def test_reference_agrees_with_a_tight_plain_solve():
    net = synthetic_pyrolysis_network(6)
    u0 = np.zeros(net.ns)
    u0[net.species.index("C6")] = 1.0
    saves = np.array([0.0, 0.5, 1.0])
    k_of_t = reference.ramp_k(net, 1e12, 500.0, 50.0, 1.0)
    ref = reference.solve_ramp(net, u0, 50.0, 500.0, 1.0, saves, 1e12,
                               1e-11, 1e-14)
    tight = solve_ivp(_dense_rhs(net, k_of_t), (0.0, 1.0), u0,
                      method="Radau", t_eval=saves, rtol=1e-12, atol=1e-15)
    assert tight.success
    assert np.max(np.abs(ref - tight.y.T)) < 1e-9


def test_reference_jacobian_is_the_rhs_derivative():
    net = synthetic_pyrolysis_network(6)
    ma = reference.MassAction(net)
    rng = np.random.default_rng(0)
    u, k = rng.random(net.ns), rng.random(net.nr) * 10
    J = ma.jac(k, u)
    eps = 1e-3  # the rates are at most quadratic: central differences are exact
    fd = np.stack([(ma.rhs(k, u + eps * e) - ma.rhs(k, u - eps * e)) / (2 * eps)
                   for e in np.eye(net.ns)], axis=1)
    np.testing.assert_allclose(J, fd, rtol=1e-6, atol=1e-8)


def test_work_functions_by_hand():
    # 2 lanes, 3 species, 4 reactions, arity 2, 5 nonzeros
    nbytes, flops = roofline.rhs_work(2, 3, 4, 2, 5)
    assert nbytes == (2 * 4 + 2 * 4 + 2 * 3) * 8 + (4 * 2 * 4 + 4 * 4 + 5 * 12)
    assert flops == 2 * (2 * 4 + 2 * 5)
    nbytes, flops = roofline.inverse_work(3, 4)
    assert (nbytes, flops) == (2 * 3 * 16 * 4, 2.0 * 3 * 64)
    nbytes, flops = roofline.solve_work(1, 2)
    assert (nbytes, flops) == (2 * 4 * 4 + (4 + 1) * 8, 2.0 * 4 * 9)
    # bytes bound the inverse at n = 73: 2 x 73^2 x 4 B / 3.35e12 B/s
    assert roofline.bound_s(*roofline.inverse_work(1, 73), "f32") == \
        pytest.approx(max(2 * 73 ** 2 * 4 / 3.35e12, 2 * 73 ** 3 / 67e12))


def test_gj_roofline_counts_the_blocks_gauss_jordan_inverts():
    from benchmark.harness import Spec
    from conftest import REPO
    gj = Spec(REPO).module("metrics", "gj_inverse_roofline")
    assert gj.blocks(73) == [73] and gj.blocks(128) == [128]
    assert gj.blocks(181) == [128, 53]
    assert gj.blocks(512) == [128] * 4
    # 181 species: the two diagonal blocks' flops, not the whole inverse's
    assert sum(roofline.inverse_work(1, b)[1] for b in gj.blocks(181)) == \
        2.0 * (128 ** 3 + 53 ** 3)
