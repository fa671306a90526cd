"""The port's batched BDF against ``kinetica_tpu.ops.bdf.bdf_solve`` under
``jax.vmap``.

The JAX side runs the accelerator algorithm on the CPU (``inv_gated`` with
the interpret-mode Gauss-Jordan kernel, ``KINETICA_REFINE=unroll:2``,
``KINETICA_NS_RESIDUAL=f64dot``), the port its own with the kernels' plain
versions. Cases: the 3-species linear stiff system of
``test_pallas_linalg.py`` at 16 stiffnesses, and a 2-chunk async run of a
time-dependent version of it with an interior stop.

Tolerances: the same status per lane; saved states 1e-8 relative to the
lane's largest state over the run (rtol 1e-8 solves whose controllers
take the same steps up to round-off); step counts within 5%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

BASE = np.array([[-1.0, 0.2, 0.0], [0.3, -2.0, 0.1], [0.0, 0.5, -0.5]])
RATES = np.linspace(1.0, 40.0, 16)


@pytest.fixture(autouse=True)
def accelerator_algorithm(monkeypatch):
    monkeypatch.setenv("KINETICA_REFINE", "unroll:2")
    monkeypatch.setenv("KINETICA_NS_RESIDUAL", "f64dot")


def _torch_linear():
    base = torch.as_tensor(BASE)

    def rhs(t, y, a):
        return ((a[:, None, None] * base) @ y[..., None])[..., 0]

    def jac(t, y, a):
        return a[:, None, None] * base

    return rhs, jac


def _compare(res_j, res_t, ys_j, ys_t):
    np.testing.assert_array_equal(res_t.status.numpy(), np.asarray(res_j.status))
    assert np.all(res_t.status.numpy() == 1)
    ys_t = ys_t.numpy()
    # relative to each lane's largest state over the run (y0 = 1): the
    # solves control their error against rtol * |y| + atol at every step
    scale = np.maximum(np.abs(ys_j).reshape(len(ys_j), -1).max(axis=1), 1.0)
    scale = scale.reshape((-1,) + (1,) * (ys_j.ndim - 1))
    assert np.all(np.abs(ys_t - ys_j) <= 1e-8 * scale)
    s_t = res_t.n_steps.numpy().astype(float)
    s_j = np.asarray(res_j.n_steps, float)
    assert np.all(np.abs(s_t - s_j) <= 0.05 * s_j), (s_t, s_j)


def test_linear_stiff_system_matches_vmapped_reference():
    from kinetica_tpu.ops import bdf as jbdf
    from kinetica_tpu_torch.ops import bdf
    base = jnp.asarray(BASE)
    saveat = np.array([0.5, 1.0])

    def one(a):
        return jbdf.bdf_solve(lambda t, y, a: (a * base) @ y,
                              lambda t, y, a: a * base, jnp.ones(3), 0.0, 1.0,
                              jnp.asarray(saveat), rtol=1e-8, atol=1e-10,
                              linsolve="inv_gated", lu_drift_tol=0.3, args=a)

    res_j = jax.vmap(one)(jnp.asarray(RATES))
    rhs, jac = _torch_linear()
    res_t = bdf.bdf_solve(rhs, jac, torch.ones(16, 3, dtype=torch.float64),
                          0.0, 1.0, saveat, rtol=1e-8, atol=1e-10,
                          linsolve="inv_gated", lu_drift_tol=0.3,
                          args=torch.as_tensor(RATES))
    assert res_t.ys.shape == (16, 2, 3)
    _compare(res_j, res_t, np.asarray(res_j.ys), res_t.ys)


def test_two_chunk_async_run_matches_vmapped_reference():
    """Chunk-local time, a rate that grows with global time, and a stop
    inside the second chunk: exercises the per-lane chunk transition, the
    stop clamp and the per-chunk save rows."""
    from kinetica_tpu.ops import bdf as jbdf
    from kinetica_tpu_torch.ops import bdf
    base = jnp.asarray(BASE)
    saveat = np.array([0.25, 0.5])
    offsets = np.array([0.0, 0.5])
    stops = np.array([[np.inf], [0.3]])

    def jprep(t_stage, t_start, a):
        off, rate = a
        return rate * (1.0 + t_stage + off)

    def one(a):
        return jbdf.bdf_solve(lambda t, y, p: (p * base) @ y,
                              lambda t, y, p: p * base, jnp.ones(3), 0.0, 0.5,
                              jnp.asarray(saveat), rtol=1e-8, atol=1e-10,
                              linsolve="inv_gated", lu_drift_tol=0.3,
                              prepare=jprep, args=a, chunks=2,
                              chunk_offsets=jnp.asarray(offsets),
                              stops=jnp.asarray(stops))

    res_j = jax.vmap(one)(jnp.asarray(RATES))

    def tprep(t_stage, t_start, a):
        off, rate = a
        return rate * (1.0 + t_stage + off)

    rhs, jac = _torch_linear()
    res_t = bdf.bdf_solve(rhs, jac, torch.ones(16, 3, dtype=torch.float64),
                          0.0, 0.5, saveat, rtol=1e-8, atol=1e-10,
                          linsolve="inv_gated", lu_drift_tol=0.3,
                          prepare=tprep, args=torch.as_tensor(RATES), chunks=2,
                          chunk_offsets=offsets, stops=stops)
    assert res_t.ys.shape == (16, 2, 2, 3)
    _compare(res_j, res_t, np.asarray(res_j.ys), res_t.ys)


def test_change_D_matches_reference():
    from kinetica_tpu.ops.bdf import _change_D as ref
    from kinetica_tpu_torch.ops.bdf import _change_D
    rng = np.random.default_rng(3)
    D = rng.standard_normal((6, 8, 5))
    order = np.array([1, 2, 3, 4, 5, 3])
    factor = rng.uniform(0.2, 10.0, 6)
    out = _change_D(torch.as_tensor(D), torch.as_tensor(order),
                    torch.as_tensor(factor)).numpy()
    for b in range(6):
        np.testing.assert_allclose(
            out[b], np.asarray(ref(jnp.asarray(D[b]), order[b], factor[b])),
            rtol=1e-13, atol=1e-13)


def test_failure_status_codes():
    """A lane that cannot finish within max_steps reports FAIL_MAX_STEPS,
    and the others still finish."""
    from kinetica_tpu_torch.ops import bdf
    rhs, jac = _torch_linear()
    a = torch.tensor([1.0, 1e6], dtype=torch.float64)

    def rhs_osc(t, y, a):
        return rhs(t, y, a) * torch.cos(1e3 * t)[:, None]

    res = bdf.bdf_solve(rhs_osc, jac, torch.ones(2, 3, dtype=torch.float64),
                        0.0, 1.0, [1.0], max_steps=60, args=a)
    assert res.status.tolist()[1] == bdf.FAIL_MAX_STEPS
    assert set(res.status.tolist()) <= {bdf.DONE, bdf.FAIL_MAX_STEPS}
