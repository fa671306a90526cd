"""The fake-ASE ``ASENEBCalculator`` pipeline in both packages.

CC <-> C=C + H2 (the network of ``tests/test_fake_ase_pipeline.py``):
species properties, geometry optimisation, endpoint systems, NEB, TS
extraction, finite-difference vibrations and Eyring TST rates. Each
package's fake ``ase`` registers the same ``ase.*`` names in
``sys.modules``, so one fake is installed at a time: the JAX package's
runs its pipeline and is uninstalled, then the port's. Each pipeline has
its own ``calcdir`` (a shared cache would let the second read the first's
results and make the comparison empty). The NEB and vibrations are the
same numpy code in both, and give the same tables bit for bit. The
rates agree within 1e-10 relative beyond the conditioning of the
vibrational entropy: the pipeline's toy potential leaves modes of ~1e-11
eV, where the JAX form ``log1p(-exp(-x))`` turns one ulp of ``exp`` into
~1e-6 of the rate (``testing.tst_bounds``; XLA's ``exp`` and the CPU's
part there by 3e-7). The enthalpies, which have no such term, agree to
1e-12. The port's TST thermo of every species and TS agrees with
``thermo_check``'s numpy formulas.
"""
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SMILES = ["CC", "C=C", "[H][H]"]
CALC_KW = dict(n_images=5, neb_optimiser="fire", climb=False, ftol=0.3,
               geom_fmax=0.05, maxiters=400, interpolation="linear",
               remove_unconverged=False)
T_GRID = np.linspace(800.0, 1400.0, 7)


def _run(pkg, calcdir):
    """Install ``pkg``'s fake ase, run its pipeline, uninstall; returns
    (rates at 1000 K, rates on T_GRID at 1e5 Pa, calculator, sd, rd)."""
    import importlib
    fake = importlib.import_module(f"{pkg}.testing.fake_ase")
    net = importlib.import_module(f"{pkg}.core.network")
    chem = importlib.import_module(f"{pkg}.chem")
    fake.install()
    try:
        calcmod = importlib.import_module(f"{pkg}.ase.calculator")
        sd = net.SpeciesData(SMILES, [chem.frame_from_smiles(s) for s in SMILES])
        rd = net.RxData()
        rd.push(sd, [["CC"]], [["C=C", "[H][H]"]])
        rd.push(sd, [["C=C", "[H][H]"]], [["CC"]])
        kw = {"device": "cpu"} if pkg.endswith("torch") else {}
        calc = calcmod.ASENEBCalculator(calc_builder=fake.ToyMorseBuilder(),
                                        calcdir=str(calcdir), **CALC_KW, **kw)
        calc.setup_network(sd, rd)
        if pkg.endswith("torch"):
            k1 = calc(T=1000.0, P=1e5).numpy()
            kT = calc(T=torch.as_tensor(T_GRID), P=1e5).numpy()
        else:
            import jax.numpy as jnp
            k1 = np.asarray(calc(T=1000.0, P=1e5))
            kT = np.asarray(calc(T=jnp.asarray(T_GRID), P=1e5))
        return k1, kT, calc, sd, rd
    finally:
        fake.uninstall()


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    jax_run = _run("kinetica_tpu", tmp_path_factory.mktemp("calc_jax"))
    assert not any(m == "ase" or m.startswith("ase.") for m in sys.modules
                   if getattr(sys.modules[m], "__kinetica_fake__", False))
    port_run = _run("kinetica_tpu_torch", tmp_path_factory.mktemp("calc_port"))
    return jax_run, port_run


def test_fakes_one_at_a_time():
    """Installing one package's fake flips only that package's flag, and
    uninstalling restores both (no real ase on this machine)."""
    import kinetica_tpu.chem as c0
    import kinetica_tpu_torch.chem as c1
    from kinetica_tpu.testing import fake_ase as f0
    from kinetica_tpu_torch.testing import fake_ase as f1
    base0, base1 = c0.HAS_ASE, c1.HAS_ASE
    f1.install()
    try:
        assert c1.HAS_ASE and c1.backends.HAS_ASE
        assert c0.HAS_ASE == base0
        assert sys.modules["ase"].__kinetica_fake__
    finally:
        f1.uninstall()
    assert (c0.HAS_ASE, c1.HAS_ASE) == (base0, base1)


def test_pipelines_run_the_same_chemistry(pipelines):
    (_, _, c0, sd0, rd0), (_, _, c1, sd1, rd1) = pipelines
    assert c1.ts_cache["conv"] == c0.ts_cache["conv"] == {0: True, 1: True}
    assert sd1.toInt == sd0.toInt and rd1.rhash == rd0.rhash
    for key in ("mult", "geometry", "symmetry"):
        assert sd1.cache[key] == sd0.cache[key], key
    for sid in range(sd0.n):
        np.testing.assert_allclose(sd1.cache["vib_energies"][sid],
                                   sd0.cache["vib_energies"][sid],
                                   rtol=1e-12, atol=0)
    for rid in range(rd0.nr):
        np.testing.assert_allclose(c1.ts_cache["vib_energies"][rid],
                                   c0.ts_cache["vib_energies"][rid],
                                   rtol=1e-12, atol=0)


def test_rates_match_jax(pipelines):
    from kinetica_tpu_torch.testing.tst_bounds import rate_rel_bound
    (k0, kT0, c0, *_), (k1, kT1, c1, *_) = pipelines
    assert k1.shape == (2,) and kT1.shape == (T_GRID.size, 2)
    assert np.all(np.isfinite(kT1)) and np.all(kT1 > 0)
    assert c1._tst.device == torch.device("cpu")
    for name in ("species", "ts"):
        for f, v in vars(getattr(c1._tst, name)).items():
            np.testing.assert_array_equal(v, getattr(getattr(c0._tst, name), f))
    bound = 1e-10 + rate_rel_bound(c1._tst, np.append(T_GRID, 1000.0))
    rel = np.abs(np.vstack([kT1, k1]) / np.vstack([kT0, k0]) - 1.0)
    assert np.all(rel <= bound), (rel, bound)
    # the parts without the ill-conditioned term: dH to 1e-12
    dH0 = np.stack([np.asarray(c0._tst.calculate_entropy_enthalpy(T, 1e5)[1])
                    for T in T_GRID])
    _, dH1 = c1._tst.calculate_entropy_enthalpy(torch.as_tensor(T_GRID), 1e5)
    np.testing.assert_allclose(dH1.numpy(), dH0, rtol=1e-12,
                               atol=0)


def test_thermo_check_on_the_pipeline_tables(pipelines):
    """Every species and TS of the port's TST tables against the numpy
    cross-check at 1000 K, 1e5 Pa."""
    from kinetica_tpu_torch.ase.thermo_check import cross_check
    *_, (_, _, c1, _, _) = pipelines
    for tab in (c1._tst.species, c1._tst.ts):
        for i in range(tab.mass.shape[0]):
            vibs = tab.vib_energies[i][tab.vib_mask[i]]
            rep = cross_check(tab.mass[i], tab.inertias[i], tab.geometry[i],
                              tab.symmetry[i], tab.mult[i], tab.energy[i],
                              vibs, 1000.0, 1e5)
            assert rep["dS_numpy"] <= 1e-12 * abs(rep["S_numpy"]), rep
            assert rep["dH_numpy"] <= 1e-12 * abs(rep["H_numpy"]), rep
