"""The port's TST thermochemistry and Eyring rates against the JAX package.

``entropy``/``enthalpy`` on the cases of ``tests/test_tst.py`` and the
``TSTCalculator`` on seeded tables over the nc=6 synthetic network
(``testing.synthetic.synthetic_thermo_tables``): scalar and batched T
and P, ``k_max``, ``splice``, all within 1e-12 relative of the JAX
package; the port's thermo against ``thermo_check``'s independent numpy
formulas to 1e-12. On the CPU both packages use native f64 ``exp`` and
``log``; the rates differ by ~3e-13 where a reaction's dH/RT is ~20.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CASES = [
    # (mass, inertias, geometry, symmetry, mult, energy, vibs)
    (16.04, [3.1, 3.1, 3.1], 2, 12, 1, -24.0,
     [0.38, 0.38, 0.38, 0.19, 0.19, 0.17, 0.17, 0.17, 0.39]),
    (2.016, [0.277, 0.277, 0.0], 1, 2, 1, -6.7, [0.546]),
    (1.008, [0.0, 0.0, 0.0], 0, 1, 2, -1.1, []),
]
RTOL = 1e-12


def _tables(case):
    from kinetica_tpu.calculators.tst import ThermoTable as T0
    from kinetica_tpu_torch.calculators.tst import ThermoTable as T1
    mass, inertias, geom, sym, mult, energy, vibs = case
    args = ([mass], [inertias], [geom], [sym], [mult], [energy], [vibs])
    return T0.from_lists(*args), T1.from_lists(*args)


@pytest.mark.parametrize("case", CASES, ids=["CH4", "H2", "H"])
@pytest.mark.parametrize("T,P", [(300.0, 1e5), (1000.0, 2e5), (550.0, 5e4)])
def test_thermo_matches_jax(case, T, P):
    from kinetica_tpu.calculators import tst as J
    from kinetica_tpu_torch.calculators import tst as Pt
    t0, t1 = _tables(case)
    S0 = np.asarray(J.entropy(t0.mass, t0.inertias, t0.geometry, t0.symmetry,
                              t0.mult, t0.vib_energies, t0.vib_mask, T, P))
    S1 = Pt.entropy(t1.mass, t1.inertias, t1.geometry, t1.symmetry, t1.mult,
                    t1.vib_energies, t1.vib_mask, T, P).numpy()
    H0 = np.asarray(J.enthalpy(t0.energy, t0.vib_energies, t0.vib_mask,
                               t0.geometry, T))
    H1 = Pt.enthalpy(t1.energy, t1.vib_energies, t1.vib_mask, t1.geometry,
                     T).numpy()
    np.testing.assert_allclose(S1, S0, rtol=RTOL, atol=0)
    np.testing.assert_allclose(H1, H0, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", CASES, ids=["CH4", "H2", "H"])
def test_thermo_check_numpy_cross_check(case):
    """The port's cross_check: its torch thermo against the independent
    numpy formulas (the JAX package's check, on the port's core)."""
    from kinetica_tpu_torch.ase.thermo_check import cross_check
    mass, inertias, geom, sym, mult, energy, vibs = case
    if not vibs:
        vibs = [0.2]
    rep = cross_check(mass=mass, inertias=inertias, geometry=geom,
                      symmetry=sym, mult=mult, energy=energy,
                      vib_energies=vibs, T=450.0, P=2.1e5)
    assert rep["dS_numpy"] <= RTOL * abs(rep["S_numpy"])
    assert rep["dH_numpy"] <= RTOL * abs(rep["H_numpy"])


def _calculators(k_max=None, seed=3):
    from kinetica_tpu.calculators.tst import ThermoTable as T0
    from kinetica_tpu.calculators.tst import TSTCalculator as C0
    from kinetica_tpu_torch.calculators.tst import TSTCalculator as C1
    from kinetica_tpu_torch.testing.synthetic import (
        synthetic_pyrolysis_network, synthetic_thermo_tables)
    sd, rd, _, _ = synthetic_pyrolysis_network(6)
    sp, ts, ids, sts = synthetic_thermo_tables(sd, rd, seed)
    c0 = C0(T0(**vars(sp)), T0(**vars(ts)), ids, sts, k_max=k_max)
    c1 = C1(sp, ts, ids, sts, k_max=k_max, device="cpu")
    return c0, c1, rd


@pytest.mark.parametrize("k_max", [None, 1e8])
@pytest.mark.parametrize("conditions", ["scalar", "batched_T", "batched_TP",
                                        "batched_P"])
def test_tst_rates_match_jax(conditions, k_max):
    c0, c1, rd = _calculators(k_max)
    T = np.linspace(600.0, 1400.0, 8)
    P = np.geomspace(2e4, 5e5, 8)
    T, P = {"scalar": (812.5, 1.3e5), "batched_T": (T, 1e5),
            "batched_TP": (T, P), "batched_P": (950.0, P)}[conditions]
    k0 = np.asarray(c0(T=jnp.asarray(T), P=jnp.asarray(P)))
    k1 = c1(T=torch.as_tensor(T), P=torch.as_tensor(P)).numpy()
    assert k1.shape == k0.shape == np.broadcast_shapes(
        np.shape(T), np.shape(P)) + (rd.nr,)
    assert np.all(np.isfinite(k1)) and np.all(k1 > 0)
    np.testing.assert_allclose(k1, k0, rtol=RTOL, atol=0)
    if k_max is not None:
        assert np.all(k1 <= k_max)
    # a float condition gives the same rates as a tensor one
    if conditions == "scalar":
        np.testing.assert_array_equal(c1(T=812.5, P=1.3e5).numpy(), k1)


def test_tst_splice_matches_jax():
    c0, c1, rd = _calculators()
    rids = [0, 3, 7, rd.nr - 1]
    c0.splice(rids)
    c1.splice(rids)
    assert c1.nr == c0.nr == rd.nr - len(rids)
    # the device copies were rebuilt
    assert c1._reac_ids.shape[0] == c1.nr == c1._ts["mass"].shape[0]
    T = np.linspace(700.0, 1200.0, 5)
    np.testing.assert_allclose(
        c1(T=torch.as_tensor(T), P=1e5).numpy(),
        np.asarray(c0(T=jnp.asarray(T), P=1e5)), rtol=RTOL, atol=0)


def test_tst_calls_copy_nothing_from_the_host(monkeypatch):
    """The tables reach the device at construction; a call builds no
    tensor from host data (the continuous ensemble calls once per RHS)."""
    _, c1, _ = _calculators()
    T = torch.linspace(700.0, 1200.0, 4, dtype=torch.float64)
    ref = c1(T=T, P=1e5)
    made = []
    real = torch.as_tensor

    def counting(x, *a, **kw):
        if isinstance(x, np.ndarray) and x.size > 1:
            made.append(x.shape)
        return real(x, *a, **kw)
    monkeypatch.setattr(torch, "as_tensor", counting)
    out = c1(T=T, P=1e5)
    assert made == []
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _continuous_sweep(pkg):
    """A 2-member continuous ensemble with TST rates in ``pkg``: CH4 and
    CH4 + H on 300 -> 1300 K ramps (k_max 1/s keeps every lane resolved)."""
    import importlib
    mod = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "conditions.condition_set", "conditions.profiles", "core.network",
        "parallel.batching", "solving.methods", "solving.params",
        "calculators.tst")}
    tst = mod["calculators.tst"]
    net = mod["core.network"]
    sd = net.SpeciesData(["C", "[H][H]", "[H]"])
    rd = net.RxData.from_reactions(sd, [["C"], ["C", "[H]"]],
                                   [["[H][H]", "[H]"], ["[H][H]", "[H]"]])
    species = tst.ThermoTable.from_lists(*[[c[i] for c in CASES]
                                           for i in range(7)])
    ts = tst.ThermoTable.from_lists(
        [16.04, 17.05], [[3.5, 3.6, 3.8], [4.0, 4.1, 4.5]], [2, 2], [1, 1],
        [1, 2], [-22.0, -24.6],
        [[0.35, 0.2, 0.18, 0.17, 0.15, 0.30, 0.28, 0.25],
         [0.36, 0.21, 0.19, 0.18, 0.16, 0.31, 0.29, 0.26, 0.1]])
    kw = {"device": "cpu"} if pkg.endswith("torch") else {}
    calc = tst.TSTCalculator(species, ts, [[0], [0, 2]], [[1], [1, 1]],
                             k_max=1.0, **kw)
    LG = mod["conditions.profiles"].LinearGradientProfile
    CS = mod["conditions.condition_set"].ConditionSet

    def cs(r):
        return CS({"T": LG(rate=r, X_start=300.0, X_end=300.0 + 10.0 * r),
                   "P": 1e5})
    pars = mod["solving.params"].ODESimulationParams(
        tspan=(0.0, 10.0), u0={"C": 1.0}, solve_chunks=True,
        solve_chunkstep=2.5, low_k_cutoff="none")
    method = mod["solving.methods"].VariableODESolve(pars, cs(100.0), calc)
    prob = mod["parallel.batching"].EnsembleProblem(
        method, sd, rd, rate_mode="continuous", **kw)
    return prob.solve(conditions_list=[cs(80.0), cs(100.0)])


def test_tst_continuous_ensemble_matches_jax():
    """TST rates embedded per lane in the port's continuous ensemble,
    against the JAX package's ensemble on the same sweep."""
    ens1 = _continuous_sweep("kinetica_tpu_torch")
    ens0 = _continuous_sweep("kinetica_tpu")
    assert ens1.success and ens0.success
    u0, u1 = np.asarray(ens0.u), np.asarray(ens1.u)
    assert u1.shape == u0.shape
    assert np.all(u1[:, -1, 0] < 0.5)                 # methane consumed
    assert np.max(np.abs(u1 - u0)) <= 1e-6
