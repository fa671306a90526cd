"""Kernel 3 (f64 contraction du = r @ N): its plain version against the
reference.

The reference is ``kinetica_tpu.ops.pallas_matmul.DDContraction`` with
``interpret=True`` (the sliced, TwoSum-compensated Pallas kernel run by
the interpreter on the CPU) at one DD_CHUNK of reactions, and its pure-XLA
counterpart ``dd_reference`` at the flagship width. Inputs are numpy-
seeded rates spanning 15 decades. Tolerance: |du_port - du_ref| <= 1e-12 *
sum_j |N_js r_j| per entry (the reference is ~1e-13 relative to the
largest term; the port sums native f64 in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _network(nc):
    from kinetica_tpu.models.mass_action import build_mass_action
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, _, _ = synthetic_pyrolysis_network(nc)
    net = build_mass_action(rd, sd.n)
    return np.asarray(net.N), np.asarray(net.reac_slots)


def _rates(nr, B, seed):
    rng = np.random.default_rng(seed)
    r = 10.0 ** rng.uniform(-14, 1, (B, nr))
    r[rng.random((B, nr)) < 0.1] = 0.0
    return r


def _port(N, r):
    from kinetica_tpu_torch.ops.dd_contract import DDContraction
    return DDContraction(N, "cpu")(torch.as_tensor(r)).numpy()


def _within(du, ref, N, r):
    return np.all(np.abs(du - ref) <= 1e-12 * (np.abs(r) @ np.abs(N)) + 1e-300)


def test_matches_pallas_interpret_one_chunk():
    from kinetica_tpu.ops.pallas_matmul import DD_CHUNK, DDContraction
    N, _ = _network(6)                  # 108 reactions: one DD_CHUNK
    assert N.shape[0] <= DD_CHUNK
    r = _rates(N.shape[0], 4, seed=1)
    ref = np.asarray(DDContraction(N, interpret=True)(jnp.asarray(r)))
    assert _within(_port(N, r), ref, N, r)


@pytest.mark.parametrize("nc,B", [(6, 3), (24, 8)])
def test_matches_dd_reference(nc, B):
    from kinetica_tpu.ops.pallas_matmul import dd_reference
    N, _ = _network(nc)
    r = _rates(N.shape[0], B, seed=nc)
    ref = np.asarray(dd_reference(jnp.asarray(r), jnp.asarray(N)))
    assert _within(_port(N, r), ref, N, r)


def test_equals_fused_rhs_on_the_same_rates():
    """The contraction of the rates equals the fused RHS bit for bit: the
    plain versions sum the same CSR rows in the same order."""
    from kinetica_tpu_torch.models.mass_action import MassActionNetwork
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    N, slots = _network(6)
    net = MassActionNetwork.from_numpy(slots, N, device="cpu")
    rng = np.random.default_rng(2)
    u = torch.as_tensor(10.0 ** rng.uniform(-12, 0, (5, N.shape[1])))
    k = torch.as_tensor(10.0 ** rng.uniform(-3, 12, (5, N.shape[0])))
    from kinetica_tpu_torch.models.mass_action import augment
    from kinetica_tpu_torch.ops.dd_contract import DDContraction
    du_dd = DDContraction(N, "cpu")(net.rates(u, k))
    du_fused = FusedMassActionRHS(N, slots, "cpu")(augment(u, net.delta), k)
    assert torch.equal(du_dd, du_fused)


def test_large_and_fractional_stoichiometry_accepted():
    """The reference rejects |N| > 7 and non-integer N; native f64 takes
    any real N, so the port accepts them."""
    from kinetica_tpu.ops.pallas_matmul import DDContraction as Ref
    N, _ = _network(6)
    N = N.copy()
    N[0, 3] = 9.0
    N[5, 1] = -0.5
    with pytest.raises(ValueError):
        Ref(N, interpret=True)
    r = _rates(N.shape[0], 3, seed=4)
    assert _within(_port(N, r), r @ N, N, r)


def test_rejects_per_lane_stoichiometry():
    from kinetica_tpu_torch.ops.dd_contract import DDContraction
    N, _ = _network(6)
    with pytest.raises(ValueError, match="per-lane"):
        DDContraction(np.stack([N, N]), "cpu")


@pytest.mark.parametrize("what", ["f32", "width", "noncontig", "rank"])
def test_guard_rejects_bad_inputs(what):
    from kinetica_tpu_torch.ops.dd_contract import DDContraction
    N, _ = _network(6)
    nr = N.shape[0]
    dd = DDContraction(N, "cpu")
    bad = {"f32": torch.ones(2, nr), "width": torch.ones(2, nr + 1,
                                                           dtype=torch.float64),
           "noncontig": torch.ones(nr, 2, dtype=torch.float64).T,
           "rank": torch.ones(nr, dtype=torch.float64)}[what]
    with pytest.raises((TypeError, ValueError)):
        dd(bad)


def test_cpu_call_launches_nothing():
    from kinetica_tpu_torch.ops import dd_contract, grid_probe
    dd_contract.launches = grid_probe.launches = 0
    N, _ = _network(6)
    _port(N, _rates(N.shape[0], 2, seed=3))
    assert dd_contract.launches == 0 and grid_probe.launches == 0
