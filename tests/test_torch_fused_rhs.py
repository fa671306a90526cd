"""Kernel 1 (fused mass-action RHS): its plain version against the reference.

The reference is ``FusedMassActionRHS(..., interpret=True, mode="scan")``
of the JAX package, fed the double-f32 pairs of the same u_aug and k, and
the JAX network's plain f64 ``rhs``. Tolerance: |du_port - du_ref| <=
1e-12 * sum_j |N_js r_j| per entry (the reference is ~2^-45 relative to
the largest term; the port sums native f64 in another order).

The wrapper guards run here too: they reject what the CUDA kernel does not
take before any device code runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _pairs(x):
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def _inputs(N, slots, B, seed):
    rng = np.random.default_rng(seed)
    nr, ns = N.shape
    u = 10.0 ** rng.uniform(-12, 0, (B, ns))
    u[rng.random((B, ns)) < 0.2] = 0.0
    u_aug = np.concatenate([u, np.ones((B, 1))], axis=1)
    k = 10.0 ** rng.uniform(-3, 12, (B, nr))
    return u_aug, k


def _bound(N, slots, u_aug, k):
    r = k * np.prod(u_aug[:, slots], axis=2)
    return np.abs(r) @ np.abs(N)


def _port_rhs(N, slots, u_aug, k):
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    fused = FusedMassActionRHS(N, slots, "cpu")
    return fused(torch.as_tensor(u_aug), torch.as_tensor(k)).numpy()


def _network(nc):
    from kinetica_tpu.models.mass_action import build_mass_action
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, _, _ = synthetic_pyrolysis_network(nc)
    net = build_mass_action(rd, sd.n)
    return np.asarray(net.N), np.asarray(net.reac_slots), net


def test_matches_pallas_interpret_b8():
    from kinetica_tpu.ops.pallas_matmul import FusedMassActionRHS as Ref
    N, slots, _ = _network(6)
    u_aug, k = _inputs(N, slots, 8, seed=1)
    ref = Ref(N, slots, interpret=True, mode="scan")
    uh, ul = _pairs(u_aug)
    kh, kl = _pairs(k)
    du_ref = np.asarray(jax.vmap(ref.rhs_pair)(uh, ul, kh, kl))
    du = _port_rhs(N, slots, u_aug, k)
    bound = _bound(N, slots, u_aug, k)
    assert np.all(np.abs(du - du_ref) <= 1e-12 * bound + 1e-300)


@pytest.mark.parametrize("nc", [6, 24])
def test_matches_jax_f64_rhs(nc):
    N, slots, net = _network(nc)
    u_aug, k = _inputs(N, slots, 4, seed=nc)
    ns = N.shape[1]
    # the JAX rhs clips u itself; feed it states already >= 0 (clip ~ id)
    u = u_aug[:, :ns]
    du_ref = np.asarray(jax.vmap(net.rhs)(jnp.asarray(u), jnp.asarray(k)))
    from kinetica_tpu.models.mass_action import _clip_pos
    u_aug_c = np.concatenate([np.asarray(_clip_pos(jnp.asarray(u))),
                              np.ones((u.shape[0], 1))], axis=1)
    du = _port_rhs(N, slots, u_aug_c, k)
    bound = _bound(N, slots, u_aug_c, k)
    assert np.all(np.abs(du - du_ref) <= 1e-12 * bound + 1e-300)


def test_padding_reactions_are_inert():
    from kinetica_tpu.ops.pallas_matmul import FusedMassActionRHS as Ref
    N, slots, _ = _network(6)
    nr, ns = N.shape
    pad = 21
    Np = np.concatenate([N, np.zeros((pad, ns))])
    sp = np.concatenate([slots, np.full((pad, slots.shape[1]), ns)])
    u_aug, k = _inputs(N, slots, 3, seed=5)
    kp = np.concatenate([k, np.zeros((3, pad))], axis=1)
    du_pad = _port_rhs(Np, sp, u_aug, kp)
    np.testing.assert_array_equal(du_pad, _port_rhs(N, slots, u_aug, k))
    ref = Ref(Np, sp, interpret=True, mode="scan")
    du_ref = np.asarray(jax.vmap(ref.rhs_pair)(*_pairs(u_aug), *_pairs(kp)))
    assert np.all(np.abs(du_pad - du_ref)
                  <= 1e-12 * _bound(N, slots, u_aug, k) + 1e-300)


def test_large_stoichiometry_accepted():
    """|N| > 7: the reference rejects it (its exact sliced products need
    small integers); native f64 handles it, so the port accepts it."""
    from kinetica_tpu.ops.pallas_matmul import FusedMassActionRHS as Ref
    N, slots, _ = _network(6)
    N = N.copy()
    N[0, 3] = 9.0
    N[5, 1] = -12.5
    with pytest.raises(ValueError):
        Ref(N, slots, interpret=True, mode="scan")
    u_aug, k = _inputs(N, slots, 4, seed=9)
    r = k * np.prod(u_aug[:, slots], axis=2)
    du_np = r @ N
    du = _port_rhs(N, slots, u_aug, k)
    assert np.all(np.abs(du - du_np) <= 1e-12 * _bound(N, slots, u_aug, k)
                  + 1e-300)


@pytest.mark.parametrize("B", [1, 64])
def test_edge_network_matches_pallas_interpret(B):
    """A species row with no entries and one with 700 (the kernel's warp
    strides it 22 times), at one lane and at 64: the plain version against
    the reference in interpret mode, to the tolerance above; the empty
    row's du is exactly 0."""
    from kinetica_tpu.ops.pallas_matmul import FusedMassActionRHS as Ref
    from kinetica_tpu_torch.testing.kernel_cases import rhs_edge_network
    N, slots, empty, long = rhs_edge_network()
    assert np.count_nonzero(N[:, long]) == 700
    u_aug, k = _inputs(N, slots, B, seed=B)
    ref = Ref(N, slots, interpret=True, mode="scan")
    du_ref = np.asarray(jax.vmap(ref.rhs_pair)(*_pairs(u_aug), *_pairs(k)))
    du = _port_rhs(N, slots, u_aug, k)
    assert np.all(np.abs(du - du_ref) <= 1e-12 * _bound(N, slots, u_aug, k)
                  + 1e-300)
    assert np.all(du[:, empty] == 0.0) and np.all(du[:, long] != 0.0)


# ---- wrapper guards (checked before any device code) ----

def _fused():
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    N, slots, _ = _network(6)
    return FusedMassActionRHS(N, slots, "cpu"), N.shape


@pytest.mark.parametrize("what", ["u_f32", "k_f32", "u_noncontig",
                                  "k_noncontig", "u_width", "k_width",
                                  "batch_mismatch"])
def test_guard_rejects_bad_inputs(what):
    fused, (nr, ns) = _fused()
    u = torch.ones(4, ns + 1, dtype=torch.float64)
    k = torch.ones(4, nr, dtype=torch.float64)
    bad = {
        "u_f32": (u.float(), k),
        "k_f32": (u, k.float()),
        "u_noncontig": (torch.ones(ns + 1, 4, dtype=torch.float64).T, k),
        "k_noncontig": (u, torch.ones(nr, 4, dtype=torch.float64).T),
        "u_width": (torch.ones(4, ns, dtype=torch.float64), k),
        "k_width": (u, torch.ones(4, nr + 1, dtype=torch.float64)),
        "batch_mismatch": (u[:3].contiguous(), k),
    }[what]
    with pytest.raises((TypeError, ValueError)):
        fused(*bad)


def test_guard_rejects_per_lane_stoichiometry():
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    N, slots, _ = _network(6)
    with pytest.raises(ValueError, match="per-lane"):
        FusedMassActionRHS(np.stack([N, N]), slots, "cpu")


def test_cpu_call_launches_nothing():
    from kinetica_tpu_torch.ops import fused_rhs
    fused, (nr, ns) = _fused()
    fused_rhs.launches = 0
    fused(torch.ones(2, ns + 1, dtype=torch.float64),
          torch.ones(2, nr, dtype=torch.float64))
    assert fused_rhs.launches == 0
