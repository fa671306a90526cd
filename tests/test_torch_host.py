"""The port's host layer against the JAX package's.

The copied host modules must build the same networks, the torch profiles
must give the same condition values, and the calculator the same k(T).
Host data is compared exactly; k(T) to 1e-14 relative (both use native
f64 ``exp``, in different libraries). A subprocess check shows that the
port never imports jax.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.mark.parametrize("nc", [6, 24])
def test_synthetic_network_identical(nc):
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network as ref
    from kinetica_tpu_torch.testing.synthetic import (
        synthetic_pyrolysis_network as port)
    sd0, rd0, Ea0, A0 = ref(nc)
    sd1, rd1, Ea1, A1 = port(nc)
    assert sd1.toInt == sd0.toInt and sd1.n == sd0.n
    for name in ("nr", "id_reacs", "id_prods", "stoic_reacs", "stoic_prods",
                 "rhash"):
        assert getattr(rd1, name) == getattr(rd0, name), name
    np.testing.assert_array_equal(Ea1, Ea0)
    np.testing.assert_array_equal(A1, A0)


def test_build_mass_action_identical():
    from kinetica_tpu.models.mass_action import build_mass_action as ref
    from kinetica_tpu_torch.models.mass_action import build_mass_action
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, _, _ = synthetic_pyrolysis_network(6)
    net0 = ref(rd, sd.n)
    net1 = build_mass_action(rd, sd.n, device="cpu")
    np.testing.assert_array_equal(net1.reac_slots.numpy(),
                                  np.asarray(net0.reac_slots))
    np.testing.assert_array_equal(net1.N.numpy(), np.asarray(net0.N))
    assert net1.N.dtype == torch.float64


T_GRID = np.array([0.0, 0.3, 1.0, 2.5, 7.0, 13.9, 14.0, 20.0])


@pytest.mark.parametrize("kind", ["linear_gradient", "linear_direct", "static",
                                  "null_gradient", "null_direct"])
def test_profile_values_match(kind):
    import kinetica_tpu.conditions.profiles as P0
    import kinetica_tpu_torch.conditions.profiles as P1
    make = {
        "linear_gradient": lambda P: P.LinearGradientProfile(45.0, 500.0, 1130.0),
        "linear_direct": lambda P: P.LinearDirectProfile(45.0, 500.0, 1130.0),
        "static": lambda P: P.StaticConditionProfile(812.5),
        "null_gradient": lambda P: P.NullGradientProfile(640.0, 14.0),
        "null_direct": lambda P: P.NullDirectProfile(640.0, 14.0),
    }[kind]
    p0, p1 = make(P0), make(P1)
    theta0, theta1 = p0.theta(), p1.theta()
    np.testing.assert_array_equal(theta1, theta0)
    assert p1.static_key() == p0.static_key()
    v0 = np.asarray(type(p0).value_theta(jnp.asarray(T_GRID),
                                         jnp.asarray(theta0)))
    # batched form: one theta row per time point
    thetas = torch.as_tensor(np.tile(theta1, (T_GRID.size, 1)))
    v1 = type(p1).value_theta(torch.as_tensor(T_GRID), thetas).numpy()
    np.testing.assert_array_equal(v1, v0)
    if not p0.is_static:
        np.testing.assert_array_equal(p1.value(T_GRID).numpy(),
                                      np.asarray(p0.value(T_GRID)))
        np.testing.assert_array_equal(p1.tstops, p0.tstops)


def test_condition_set_host_machinery():
    from kinetica_tpu.conditions.condition_set import ConditionSet as CS0
    from kinetica_tpu.conditions.profiles import LinearGradientProfile as L0
    from kinetica_tpu.solving.params import ODESimulationParams as Par0
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet as CS1
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile as L1
    from kinetica_tpu_torch.solving.params import ODESimulationParams as Par1
    cs0 = CS0({"T": L0(50.0, 500.0, 1200.0), "P": 1e5}, ts_update=0.5)
    cs1 = CS1({"T": L1(50.0, 500.0, 1200.0), "P": 1e5}, ts_update=0.5)
    np.testing.assert_array_equal(cs1.get_tstops(), cs0.get_tstops())
    assert cs1.get_initial_conditions() == cs0.get_initial_conditions()
    assert cs1.get_t_final() == cs0.get_t_final()
    kw = dict(tspan=(0.0, 14.0), u0={"C6": 1.0}, save_interval=0.5,
              solve_chunkstep=0.5)
    cs0.solve_variable_conditions(Par0(**kw))
    cs1.solve_variable_conditions(Par1(**kw))
    s0, s1 = cs0.get_profile("T").sol, cs1.get_profile("T").sol
    np.testing.assert_array_equal(s1.t, s0.t)
    np.testing.assert_array_equal(s1.u, s0.u)


@pytest.mark.parametrize("k_max", [None, 1e12])
def test_arrhenius_rates_match(k_max):
    from kinetica_tpu.calculators.builtin import (
        PrecalculatedArrheniusCalculator as C0)
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator as C1)
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    _, _, Ea, A = synthetic_pyrolysis_network(24)
    T = np.linspace(700.0, 1300.0, 7)
    k0 = np.asarray(C0(Ea, A, k_max=k_max)(jnp.asarray(T)))
    k1 = C1(Ea, A, k_max=k_max, device="cpu")(torch.as_tensor(T)).numpy()
    assert k1.shape == (T.size, A.size)
    np.testing.assert_allclose(k1, k0, rtol=1e-14, atol=0)
    # scalar T gives the (nr,) vector
    k_s = C1(Ea, A, k_max=k_max, device="cpu")(900.0).numpy()
    np.testing.assert_allclose(k_s, np.asarray(C0(Ea, A, k_max=k_max)(900.0)),
                               rtol=1e-14, atol=0)


def test_dummy_calculator_matches():
    from kinetica_tpu.calculators.builtin import DummyKineticCalculator as D0
    from kinetica_tpu_torch.calculators.builtin import (
        DummyKineticCalculator as D1)
    rates = np.array([1.0, 2.5e3, 7e11, 0.0])
    np.testing.assert_array_equal(
        D1(rates, k_max=1e12, t_unit="ms", device="cpu")(T=800.0).numpy(),
        np.asarray(D0(rates, k_max=1e12, t_unit="ms")(T=800.0)))


def test_params_validation_copied():
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    with pytest.raises(ValueError):
        ODESimulationParams(tspan=(1.0, 0.0), u0={"A": 1.0})
    with pytest.raises(ValueError):
        ODESimulationParams(tspan=(0.0, 1.0), u0={"A": 1.0},
                            solve_chunkstep=0.3)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import kinetica_tpu_torch\n"
            "import kinetica_tpu_torch.ops.fused_rhs, "
            "kinetica_tpu_torch.ops.gj_inverse, kinetica_tpu_torch.ops.linalg\n"
            "import kinetica_tpu_torch.ops.bdf, "
            "kinetica_tpu_torch.parallel.batching, "
            "kinetica_tpu_torch.parallel.sharding, "
            "kinetica_tpu_torch.utils.profiling, "
            "kinetica_tpu_torch.testing.sharded_ranks\n"
            "import kinetica_tpu_torch.ops.dd_contract, "
            "kinetica_tpu_torch.ops.newton_solve, "
            "kinetica_tpu_torch.ops.grid_probe, kinetica_tpu_torch.ops.interp\n"
            "import kinetica_tpu_torch.solving.methods, "
            "kinetica_tpu_torch.solving.solve_utils, "
            "kinetica_tpu_torch.analysis.io\n"
            "import kinetica_tpu_torch.testing.cpu_reference\n"
            "import kinetica_tpu_torch.ops.rk45, "
            "kinetica_tpu_torch.solving.steady_state, "
            "kinetica_tpu_torch.solving.adjoint\n"
            "import kinetica_tpu_torch.ops.jvp, "
            "kinetica_tpu_torch.solving.sensitivity\n"
            "import kinetica_tpu_torch.analysis.flux, "
            "kinetica_tpu_torch.analysis.screening, "
            "kinetica_tpu_torch.analysis.sobol, "
            "kinetica_tpu_torch.analysis.reduction, "
            "kinetica_tpu_torch.analysis.graph, "
            "kinetica_tpu_torch.analysis.bson_compat, "
            "kinetica_tpu_torch.analysis.plotting\n"
            "import kinetica_tpu_torch.chem, kinetica_tpu_torch.chem.native, "
            "kinetica_tpu_torch.ase, kinetica_tpu_torch.ase.calculator, "
            "kinetica_tpu_torch.ase.thermo_check, "
            "kinetica_tpu_torch.exploration, "
            "kinetica_tpu_torch.exploration.cde_lite, "
            "kinetica_tpu_torch.calculators.tst, "
            "kinetica_tpu_torch.calculators.kpm, "
            "kinetica_tpu_torch.testing.fake_ase, "
            "kinetica_tpu_torch.testing.explore_config, "
            "kinetica_tpu_torch.testing.tst_bounds\n"
            "import kinetica_tpu_torch.examples, "
            "kinetica_tpu_torch.examples.mock_cde, "
            "kinetica_tpu_torch.examples.getting_started, "
            "kinetica_tpu_torch.examples.pyrolysis_sweep, "
            "kinetica_tpu_torch.examples.analysis_pipeline, "
            "kinetica_tpu_torch.examples.iterative_exploration, "
            "kinetica_tpu_torch.examples.full_product, "
            "kinetica_tpu_torch.testing.tutorials, "
            "kinetica_tpu_torch.testing.example_records\n"
            "import kinetica_tpu_torch.scripts.bench, "
            "kinetica_tpu_torch.scripts.bench_bsweep, "
            "kinetica_tpu_torch.scripts.bench_longhorizon, "
            "kinetica_tpu_torch.scripts.bench_explore, "
            "kinetica_tpu_torch.scripts.step_count_audit\n"
            "from kinetica_tpu_torch.testing import fake_ase\n"
            "fake_ase.install(); fake_ase.uninstall()\n"
            "kinetica_tpu_torch.solve_network, "
            "kinetica_tpu_torch.find_steady_state_ensemble, "
            "kinetica_tpu_torch.solve_adjoint_gradient, "
            "kinetica_tpu_torch.solve_network_sensitivities, "
            "kinetica_tpu_torch.morris_screening, "
            "kinetica_tpu_torch.reduce_network_drgep, "
            "kinetica_tpu_torch.save_output, "
            "kinetica_tpu_torch.explore_network, "
            "kinetica_tpu_torch.ASENEBCalculator, "
            "kinetica_tpu_torch.KPMCollisionCalculator\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'kinetica_tpu' or m.startswith('kinetica_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
