"""The port's KPM calculators against the JAX package's.

The same network (built in each package from the same SMILES), the same
seeded MLP ensemble (``testing.synthetic.seeded_kpm_params``, as an
``.npz`` file and as the JAX ``KPMRun.params`` dict) and the same T go
through both packages: descriptors equal, Ea within 1e-12 relative
(the port stacks the members into one batched matmul), the three
calculators' rates, uncertainty, ``insert_inert`` rewrite and ``splice``
within 1e-12. ``insert_inert`` and ``splice_network_and_calc`` are also
held to the JAX package's on their own.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL = 1e-12
SMILES = ["CC", "[CH3]", "[H]", "[CH2]C", "C=C", "[H][H]", "C"]
REACS = [["CC"], ["CC", "[H]"], ["[CH2]C"], ["[CH3]", "[CH3]"],
         ["C", "[H]"], ["[CH3]", "[H]"]]
PRODS = [["[CH3]", "[CH3]"], ["[CH2]C", "[H][H]"], ["C=C", "[H]"], ["CC"],
         ["[CH3]", "[H][H]"], ["C"]]
DH = [3.8, -0.2, 1.6, -3.8, 0.1, -4.5]


def _network(pkg, frames=True):
    net = importlib.import_module(f"{pkg}.core.network")
    chem = importlib.import_module(f"{pkg}.chem")
    xyz = [chem.frame_from_smiles(s, seed=11) for s in SMILES] if frames else None
    sd = net.SpeciesData(SMILES, xyz)
    rd = net.RxData.from_reactions(sd, REACS, PRODS, dH=DH)
    return sd, rd


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    from kinetica_tpu_torch.testing.synthetic import (seeded_kpm_params,
                                                      write_kpm_npz)
    path = tmp_path_factory.mktemp("kpm") / "model.npz"
    write_kpm_npz(path, seeded_kpm_params(seed=3))
    return str(path)


@pytest.mark.parametrize("frames", [True, False])
def test_descriptors_equal(frames):
    from kinetica_tpu.calculators.kpm import reaction_descriptors as d0
    from kinetica_tpu_torch.calculators.kpm import reaction_descriptors as d1
    X0 = d0(*_network("kinetica_tpu", frames))
    X1 = d1(*_network("kinetica_tpu_torch", frames))
    assert X1.shape == (len(REACS), 16)
    np.testing.assert_array_equal(X1, X0)


@pytest.mark.parametrize("source", ["npz", "from_numpy", "params"])
def test_ensemble_ea_matches_jax(model, source):
    from kinetica_tpu.calculators.kpm import KPMRun as R0
    from kinetica_tpu_torch.calculators.kpm import KPMEnsemble
    from kinetica_tpu_torch.calculators.kpm import KPMRun as R1
    from kinetica_tpu_torch.calculators.kpm import reaction_descriptors
    sd0, rd0 = _network("kinetica_tpu")
    sd1, rd1 = _network("kinetica_tpu_torch")
    r0 = R0(model)
    Ea0, std0 = r0(sd0, rd0, uncertainty=True)
    jax_params = {k: ([[np.asarray(a) for a in m] for m in v]
                      if isinstance(v, list) else np.asarray(v))
                  for k, v in r0.params.items()}
    if source == "npz":
        Ea1, std1 = R1(model, device="cpu")(sd1, rd1, uncertainty=True)
    elif source == "params":
        Ea1, std1 = R1(params=jax_params, device="cpu")(sd1, rd1,
                                                        uncertainty=True)
    else:
        ens = KPMEnsemble.from_numpy(jax_params)
        assert ens.n_members == 5
        X = torch.as_tensor(reaction_descriptors(sd1, rd1))
        E = ens(X)
        assert E.shape == (5, rd1.nr) and E.dtype == torch.float64
        from kinetica_tpu_torch import constants
        Ea1 = E.mean(0).numpy() * constants.eV_to_J_per_mol
        std1 = E.std(0, correction=0).numpy() * constants.eV_to_J_per_mol
    ev = Ea1 / 96485.33212
    assert np.all((ev > 0.8) & (ev < 2.0)), ev
    np.testing.assert_allclose(Ea1, Ea0, rtol=RTOL, atol=0)
    np.testing.assert_allclose(std1, std0, rtol=RTOL, atol=0)


def test_predict_fn_and_fallback_match_jax():
    from kinetica_tpu.calculators.kpm import KPMRun as R0
    from kinetica_tpu_torch.calculators.kpm import KPMRun as R1
    sd0, rd0 = _network("kinetica_tpu")
    sd1, rd1 = _network("kinetica_tpu_torch")
    for kw in ({}, {"ep_alpha": 0.5, "ep_dh_ref": -1.0}):
        np.testing.assert_array_equal(R1(device="cpu", **kw)(sd1, rd1),
                                      R0(**kw)(sd0, rd0))

    def fn(X):
        return np.stack([1.0 + 0.01 * X[:, 0], 1.2 + 0.02 * X[:, 1]])
    for a, b in zip(R1(predict_fn=fn, device="cpu")(sd1, rd1, True),
                    R0(predict_fn=fn)(sd0, rd0, True)):
        np.testing.assert_array_equal(a, b)


CALCS = [("KPMBasicCalculator", {}),
         ("KPMCollisionCalculator", {}),
         ("KPMCollisionCalculator", {"inert_species": ["[Ar]"]}),
         ("KPMCollisionCalculator", {"steric_factor": "basic"}),
         ("KPMCollisionEntropyCalculator", {"inert_species": ["[Ar]", "[He]"]})]


def _calc(pkg, name, kw, model, sd, rd):
    mod = importlib.import_module(f"{pkg}.calculators.kpm")
    dev = {"device": "cpu"} if pkg.endswith("torch") else {}
    calc = getattr(mod, name)(mod.KPMRun(model, **dev), uncertainty=True,
                              k_max=1e12, **kw, **dev)
    calc.setup_network(sd, rd)
    return calc


@pytest.mark.parametrize("name,kw", CALCS,
                         ids=["basic", "collision", "collision_inert",
                              "collision_basic_steric", "entropy_two_inert"])
def test_calculators_match_jax(model, name, kw):
    sd0, rd0 = _network("kinetica_tpu")
    sd1, rd1 = _network("kinetica_tpu_torch")
    c0 = _calc("kinetica_tpu", name, kw, model, sd0, rd0)
    c1 = _calc("kinetica_tpu_torch", name, kw, model, sd1, rd1)
    # the insert_inert rewrite (one channel per extra partner)
    assert rd1.nr == rd0.nr and sd1.toInt == sd0.toInt
    for attr in ("id_reacs", "id_prods", "stoic_reacs", "stoic_prods",
                 "rhash", "dH"):
        assert getattr(rd1, attr) == getattr(rd0, attr), attr
    for attr in ("Ea", "Ea_std", "mu", "sigma", "rho"):
        if hasattr(c0, attr):
            v1 = getattr(c1, attr)
            assert isinstance(v1, torch.Tensor) and v1.dtype == torch.float64
            np.testing.assert_allclose(v1.numpy(), np.asarray(getattr(c0, attr)),
                                       rtol=RTOL,
                                       atol=0)
    for T in (875.0, np.linspace(600.0, 1400.0, 64)):
        k0 = np.asarray(c0(T=jnp.asarray(T)))
        k1 = c1(T=torch.as_tensor(T)).numpy()
        assert k1.shape == k0.shape == np.shape(T) + (rd1.nr,)
        np.testing.assert_allclose(k1, k0, rtol=RTOL, atol=0)
        s0 = np.asarray(c0.k_uncertainty(jnp.asarray(k0), jnp.asarray(T)))
        s1 = c1.k_uncertainty(torch.as_tensor(k1), torch.as_tensor(T)).numpy()
        np.testing.assert_allclose(s1, s0, rtol=RTOL, atol=0)
    # splice: network and calculator together
    from kinetica_tpu.calculators.base import splice_network_and_calc as sp0
    from kinetica_tpu_torch.calculators.base import (
        splice_network_and_calc as sp1)
    rids = [0, rd0.nr - 1]
    sp0(rd0, c0, rids)
    sp1(rd1, c1, rids)
    assert rd1.id_reacs == rd0.id_reacs and c1.Ea.shape == (rd1.nr,)
    T = np.linspace(700.0, 1100.0, 3)
    np.testing.assert_allclose(c1(T=torch.as_tensor(T)).numpy(),
                               np.asarray(c0(T=jnp.asarray(T))), rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("inert", [["[Ar]"], ["[Ar]", "[He]"], ["[H][H]"]])
def test_insert_inert_matches_jax(inert):
    from kinetica_tpu.solving.solve_utils import insert_inert as i0
    from kinetica_tpu_torch.solving.solve_utils import insert_inert as i1
    sd0, rd0 = _network("kinetica_tpu")
    sd1, rd1 = _network("kinetica_tpu_torch")
    i0(rd0, sd0, list(inert))
    i1(rd1, sd1, list(inert))
    assert sd1.toInt == sd0.toInt and rd1.nr == rd0.nr
    for attr in ("mapped_rxns", "id_reacs", "id_prods", "stoic_reacs",
                 "stoic_prods", "dH", "rhash", "level_found"):
        assert getattr(rd1, attr) == getattr(rd0, attr), attr
    for sid in range(sd0.n):
        assert sd1.xyz[sid] == sd0.xyz[sid]


def test_splice_network_and_calc_matches_jax():
    from kinetica_tpu.calculators.base import splice_network_and_calc as sp0
    from kinetica_tpu.calculators.builtin import (
        PrecalculatedArrheniusCalculator as C0)
    from kinetica_tpu_torch.calculators.base import (
        splice_network_and_calc as sp1)
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator as C1)
    sd0, rd0 = _network("kinetica_tpu", frames=False)
    sd1, rd1 = _network("kinetica_tpu_torch", frames=False)
    Ea = np.linspace(1e5, 2e5, rd0.nr)
    A = np.linspace(1e-13, 5e-13, rd0.nr)
    c0, c1 = C0(Ea, A), C1(Ea, A, device="cpu")
    sp0(rd0, c0, [1, 4])
    sp1(rd1, c1, [1, 4])
    assert rd1.nr == rd0.nr == len(REACS) - 2
    assert rd1.rhash == rd0.rhash
    np.testing.assert_array_equal(c1.Ea, np.asarray(c0.Ea))
    np.testing.assert_allclose(c1(900.0).numpy(), np.asarray(c0(900.0)),
                               rtol=1e-14, atol=0)
