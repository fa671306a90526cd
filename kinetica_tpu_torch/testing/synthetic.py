"""Synthetic pyrolysis-style CRN generator for benchmarks and solver tests.

Builds a radical-chain hydrocarbon cracking network of tunable size
(~10^3 reactions at the JCTC-paper scale targeted by BASELINE.md) with
physically plausible Arrhenius parameters, so the stiffness structure
(fast radical recombination against slow initiation) matches what the real
exploration pipeline produces. Species names are schematic SMILES-like
labels ("C12" = C12 alkane, "C5r" = pentyl radical, "C3e" = propene).

Units follow the reference's PrecalculatedArrheniusCalculator convention
(calculator.jl:223-232): k = A * exp(-Ea / R T) * N_A, so bimolecular A
values here are divided by N_A to land at physical rate constants in
mol dm^-3 s^-1.
"""
from __future__ import annotations

import numpy as np

from .. import constants
from ..core.network import RxData, SpeciesData


def synthetic_pyrolysis_network(n_carbons: int = 16, seed: int = 12345,
                                target_reactions: int | None = None):
    """Generate (sd, rd, Ea, A) for a radical-chain cracking CRN.

    ``n_carbons=16`` yields ~50 species and ~900-1100 reactions.
    """
    rng = np.random.default_rng(seed)
    species = []
    alk = {n: f"C{n}" for n in range(1, n_carbons + 1)}          # alkanes
    rad = {n: f"C{n}r" for n in range(1, n_carbons + 1)}         # radicals
    alke = {n: f"C{n}e" for n in range(2, n_carbons + 1)}        # alkenes
    species += list(alk.values()) + list(rad.values()) + list(alke.values())
    species += ["Hr", "H2"]
    sd = SpeciesData(species)

    reacs, prods, Eas, As = [], [], [], []

    def add(r, p, Ea, A_per_s, bimolecular):
        reacs.append(r)
        prods.append(p)
        Eas.append(Ea)
        As.append(A_per_s / constants.N_A if bimolecular else A_per_s)

    # 1. Initiation: C-C homolysis  A_n -> R_i + R_{n-i}
    for n in range(2, n_carbons + 1):
        for i in range(1, n // 2 + 1):
            add([alk[n]], [rad[i], rad[n - i]],
                Ea=rng.uniform(3.30e5, 3.75e5), A_per_s=10 ** rng.uniform(15.5, 16.5),
                bimolecular=False)
    # 2. C-H homolysis: A_n -> R_n + H
    for n in range(1, n_carbons + 1):
        add([alk[n]], [rad[n], "Hr"],
            Ea=rng.uniform(3.9e5, 4.2e5), A_per_s=10 ** rng.uniform(15.0, 16.0),
            bimolecular=False)
    # 3. H-abstraction: R_m + A_n -> A_m + R_n  (m != n)
    pairs = [(m, n) for m in range(1, n_carbons + 1)
             for n in range(1, n_carbons + 1) if m != n]
    rng.shuffle(pairs)
    for m, n in pairs[: min(len(pairs), 14 * n_carbons)]:
        add([rad[m], alk[n]], [alk[m], rad[n]],
            Ea=rng.uniform(2.5e4, 6.0e4), A_per_s=10 ** rng.uniform(8.0, 9.5),
            bimolecular=True)
    # 3b. H radical abstraction: H + A_n -> H2 + R_n
    for n in range(1, n_carbons + 1):
        add(["Hr", alk[n]], ["H2", rad[n]],
            Ea=rng.uniform(2.0e4, 4.5e4), A_per_s=10 ** rng.uniform(9.0, 10.0),
            bimolecular=True)
    # 4. Beta-scission: R_n -> E_m + R_{n-m}
    for n in range(3, n_carbons + 1):
        for m in range(2, n - 1):
            add([rad[n]], [alke[m], rad[n - m]],
                Ea=rng.uniform(1.15e5, 1.55e5), A_per_s=10 ** rng.uniform(12.8, 13.8),
                bimolecular=False)
    # 4b. R_2 -> E_2 + H, R_n -> E_n + H
    for n in range(2, n_carbons + 1):
        add([rad[n]], [alke[n], "Hr"],
            Ea=rng.uniform(1.45e5, 1.65e5), A_per_s=10 ** rng.uniform(12.8, 13.5),
            bimolecular=False)
    # 5. Recombination: R_m + R_n -> A_{m+n}
    rpairs = [(m, n) for m in range(1, n_carbons + 1)
              for n in range(m, n_carbons + 1) if m + n <= n_carbons]
    rng.shuffle(rpairs)
    for m, n in rpairs[: min(len(rpairs), 8 * n_carbons)]:
        add([rad[m], rad[n]], [alk[m + n]],
            Ea=0.0, A_per_s=10 ** rng.uniform(9.0, 10.0), bimolecular=True)
    # 5b. H + R_n -> A_n; H + H -> H2
    for n in range(1, n_carbons + 1):
        add(["Hr", rad[n]], [alk[n]],
            Ea=0.0, A_per_s=10 ** rng.uniform(9.5, 10.5), bimolecular=True)
    add(["Hr", "Hr"], ["H2"], Ea=0.0, A_per_s=1e10, bimolecular=True)
    # 6. Disproportionation: R_m + R_n -> A_m + E_n
    dpairs = [(m, n) for m in range(1, n_carbons + 1)
              for n in range(2, n_carbons + 1)]
    rng.shuffle(dpairs)
    for m, n in dpairs[: min(len(dpairs), 6 * n_carbons)]:
        add([rad[m], rad[n]], [alk[m], alke[n]],
            Ea=rng.uniform(0.0, 8.0e3), A_per_s=10 ** rng.uniform(8.5, 9.5),
            bimolecular=True)

    if target_reactions is not None and len(reacs) > target_reactions:
        keep = rng.choice(len(reacs), target_reactions, replace=False)
        keep.sort()
        reacs = [reacs[i] for i in keep]
        prods = [prods[i] for i in keep]
        Eas = [Eas[i] for i in keep]
        As = [As[i] for i in keep]

    rd = RxData.from_reactions(sd, reacs, prods, dH=[0.0] * len(reacs),
                               unique_rxns=True)
    # unique_rxns dedup may drop some: rebuild param arrays aligned by hash
    if rd.nr != len(reacs):
        from ..core.network import stable_species_hash
        hmap = {}
        for r, p, e, a in zip(reacs, prods, Eas, As):
            h = stable_species_hash(sorted(r), sorted(p))
            hmap.setdefault(h, (e, a))
        Eas = [hmap[h][0] for h in rd.rhash]
        As = [hmap[h][1] for h in rd.rhash]
    return sd, rd, np.asarray(Eas, dtype=np.float64), np.asarray(As, dtype=np.float64)


def synthetic_thermo_tables(sd, rd, seed: int = 0):
    """Seeded TST inputs for a network: ``(species, ts, id_reacs,
    stoic_reacs)``, the tables as numpy :class:`~kinetica_tpu_torch.
    calculators.tst.ThermoTable` s.

    Species take every geometry class and 0-30 vibrational modes (so the
    padded, masked modes are exercised). A transition state carries its
    reactants' summed mass and their modes less one (jittered by up to
    10%; at most 30), so its entropy stays near theirs, and lies 0.6-1.6
    eV above them once the zero-point energies are counted.
    """
    from ..calculators.tst import ThermoTable

    rng = np.random.default_rng(seed)
    n = sd.n
    geometry = rng.integers(0, 3, n)
    inertias = rng.uniform(0.5, 80.0, (n, 3))
    inertias[geometry == 0] = 0.0
    inertias[geometry == 1, 0] = 0.0
    vibs = [rng.uniform(0.01, 0.45, 0 if g == 0 else rng.integers(1, 31))
            for g in geometry]
    mass = rng.uniform(2.0, 120.0, n)
    energy = rng.uniform(-60.0, -5.0, n)
    species = ThermoTable.from_lists(
        mass, inertias, geometry, rng.integers(1, 13, n).astype(float),
        rng.integers(1, 3, n).astype(float), energy, vibs)

    ts_mass, ts_vibs, ts_energy = [], [], []
    for ids, sts in zip(rd.id_reacs, rd.stoic_reacs):
        parts = [sid for sid, st in zip(ids, sts) for _ in range(st)]
        v = np.concatenate([vibs[sid] for sid in parts])[1:31]
        v = v * rng.uniform(0.9, 1.1, v.size)
        e_reac = sum(energy[sid] + 0.5 * vibs[sid].sum() for sid in parts)
        ts_mass.append(sum(mass[sid] for sid in parts))
        ts_vibs.append(v)
        ts_energy.append(e_reac - 0.5 * v.sum() + rng.uniform(0.6, 1.6))
    nr = rd.nr
    ts_geom = np.full(nr, 2)
    ts = ThermoTable.from_lists(
        ts_mass, rng.uniform(5.0, 200.0, (nr, 3)), ts_geom,
        np.ones(nr), rng.integers(1, 3, nr).astype(float), ts_energy, ts_vibs)
    return species, ts, list(rd.id_reacs), list(rd.stoic_reacs)


def seeded_kpm_params(seed: int = 0, members: int = 5, in_dim: int = 16,
                      hidden=(64, 64), target_mean: float = 1.4,
                      target_std: float = 0.15) -> dict:
    """A seeded MLP ensemble (``in_dim`` -> ``hidden`` -> 1, tanh) in the
    JAX package's ``KPMRun.params`` layout, as numpy arrays. Weights are
    N(0, 1/fan_in); inputs are scaled by 1/4; with the default target
    mean and std (eV) the activation energies lie within 1.4 +- 0.4 eV for
    descriptors of small hydrocarbon networks."""
    rng = np.random.default_rng(seed)
    dims = (in_dim, *hidden, 1)
    W, b = [], []
    for _ in range(members):
        W.append([rng.standard_normal((i, o)) / np.sqrt(i)
                  for i, o in zip(dims[:-1], dims[1:])])
        b.append([0.1 * rng.standard_normal(o) for o in dims[1:]])
    return {"W": W, "b": b, "feat_mean": np.zeros(in_dim),
            "feat_std": np.full(in_dim, 4.0),
            "target_mean": np.asarray(target_mean),
            "target_std": np.asarray(target_std)}


def write_kpm_npz(path, params: dict) -> None:
    """Write ``params`` (the layout of :func:`seeded_kpm_params`) as the
    ``.npz`` model file both packages' ``KPMRun(model_path)`` read."""
    arrs = {f"{kind}{m}_{l}": a
            for kind in ("W", "b")
            for m, member in enumerate(params[kind])
            for l, a in enumerate(member)}
    for key in ("feat_mean", "feat_std", "target_mean", "target_std"):
        arrs[key] = params[key]
    np.savez(path, **arrs)
