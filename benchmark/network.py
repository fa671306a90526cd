"""The benchmark's networks, made from a configuration's numbers alone.

Frozen copy of ``kinetica_tpu_torch/testing/synthetic.py::
synthetic_pyrolysis_network`` and of the reaction store's rules in
``kinetica_tpu_torch/core/network.py::RxData.push`` (duplicates dropped by
sorted reactants and products, the first kept; conformational no-ops and
molecularity above 2 refused), both at commit
55f0abe3ef2893a2eb2dbb1a91147263e5f51748, rewritten to return plain NumPy
arrays. The constants are those of ``kinetica_tpu_torch/constants.py`` at
that commit. It imports nothing of the program, so a later change to the
program's generator cannot change what the benchmark measures.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

R = 8.314462618          # gas constant, J / (K mol)
N_A = 6.02214076e23      # Avogadro constant, 1 / mol


@dataclass(frozen=True)
class Network:
    """A mass-action network as arrays.

    ``species``: names, index = species id. ``reactants`` / ``products``:
    per reaction, the species ids with repeats (``["Hr", "Hr"]`` is
    ``[k, k]``), in the order of the sorted names. ``Ea`` (J/mol) and
    ``A`` (per-molecule units, as the calculator takes them) per reaction.
    """
    species: tuple[str, ...]
    reactants: tuple[tuple[int, ...], ...]
    products: tuple[tuple[int, ...], ...]
    Ea: np.ndarray
    A: np.ndarray

    @property
    def ns(self) -> int:
        return len(self.species)

    @property
    def nr(self) -> int:
        return len(self.reactants)

    def stoichiometry(self) -> np.ndarray:
        """(nr, ns) net stoichiometry: products minus reactants."""
        N = np.zeros((self.nr, self.ns))
        for j, (rs, ps) in enumerate(zip(self.reactants, self.products)):
            for s in rs:
                N[j, s] -= 1.0
            for s in ps:
                N[j, s] += 1.0
        return N

    def slots(self) -> np.ndarray:
        """(nr, 2) reactant ids, a unimolecular reaction's second slot -1."""
        out = np.full((self.nr, 2), -1, dtype=np.int64)
        for j, rs in enumerate(self.reactants):
            out[j, :len(rs)] = rs
        return out


def synthetic_pyrolysis_network(n_carbons: int, seed: int = 12345) -> Network:
    """The radical-chain cracking network of ``n_carbons`` carbons: alkanes
    C1..Cn, their radicals, alkenes C2..Cn, H radical and H2 (species), and
    initiation, C-H homolysis, H abstraction, beta scission, recombination
    and disproportionation (reactions) with seeded Arrhenius parameters."""
    rng = np.random.default_rng(seed)
    alk = {n: f"C{n}" for n in range(1, n_carbons + 1)}
    rad = {n: f"C{n}r" for n in range(1, n_carbons + 1)}
    alke = {n: f"C{n}e" for n in range(2, n_carbons + 1)}
    species = (list(alk.values()) + list(rad.values()) + list(alke.values())
               + ["Hr", "H2"])
    reacs, prods, Eas, As = [], [], [], []

    def add(r, p, Ea, A_per_s, bimolecular):
        reacs.append(r)
        prods.append(p)
        Eas.append(Ea)
        As.append(A_per_s / N_A if bimolecular else A_per_s)

    # 1. initiation: C-C homolysis A_n -> R_i + R_{n-i}
    for n in range(2, n_carbons + 1):
        for i in range(1, n // 2 + 1):
            add([alk[n]], [rad[i], rad[n - i]],
                Ea=rng.uniform(3.30e5, 3.75e5),
                A_per_s=10 ** rng.uniform(15.5, 16.5), bimolecular=False)
    # 2. C-H homolysis: A_n -> R_n + H
    for n in range(1, n_carbons + 1):
        add([alk[n]], [rad[n], "Hr"], Ea=rng.uniform(3.9e5, 4.2e5),
            A_per_s=10 ** rng.uniform(15.0, 16.0), bimolecular=False)
    # 3. H abstraction: R_m + A_n -> A_m + R_n (m != n)
    pairs = [(m, n) for m in range(1, n_carbons + 1)
             for n in range(1, n_carbons + 1) if m != n]
    rng.shuffle(pairs)
    for m, n in pairs[: min(len(pairs), 14 * n_carbons)]:
        add([rad[m], alk[n]], [alk[m], rad[n]], Ea=rng.uniform(2.5e4, 6.0e4),
            A_per_s=10 ** rng.uniform(8.0, 9.5), bimolecular=True)
    # 3b. H + A_n -> H2 + R_n
    for n in range(1, n_carbons + 1):
        add(["Hr", alk[n]], ["H2", rad[n]], Ea=rng.uniform(2.0e4, 4.5e4),
            A_per_s=10 ** rng.uniform(9.0, 10.0), bimolecular=True)
    # 4. beta scission: R_n -> E_m + R_{n-m}
    for n in range(3, n_carbons + 1):
        for m in range(2, n - 1):
            add([rad[n]], [alke[m], rad[n - m]],
                Ea=rng.uniform(1.15e5, 1.55e5),
                A_per_s=10 ** rng.uniform(12.8, 13.8), bimolecular=False)
    # 4b. R_n -> E_n + H
    for n in range(2, n_carbons + 1):
        add([rad[n]], [alke[n], "Hr"], Ea=rng.uniform(1.45e5, 1.65e5),
            A_per_s=10 ** rng.uniform(12.8, 13.5), bimolecular=False)
    # 5. recombination: R_m + R_n -> A_{m+n}
    rpairs = [(m, n) for m in range(1, n_carbons + 1)
              for n in range(m, n_carbons + 1) if m + n <= n_carbons]
    rng.shuffle(rpairs)
    for m, n in rpairs[: min(len(rpairs), 8 * n_carbons)]:
        add([rad[m], rad[n]], [alk[m + n]], Ea=0.0,
            A_per_s=10 ** rng.uniform(9.0, 10.0), bimolecular=True)
    # 5b. H + R_n -> A_n; H + H -> H2
    for n in range(1, n_carbons + 1):
        add(["Hr", rad[n]], [alk[n]], Ea=0.0,
            A_per_s=10 ** rng.uniform(9.5, 10.5), bimolecular=True)
    add(["Hr", "Hr"], ["H2"], Ea=0.0, A_per_s=1e10, bimolecular=True)
    # 6. disproportionation: R_m + R_n -> A_m + E_n
    dpairs = [(m, n) for m in range(1, n_carbons + 1)
              for n in range(2, n_carbons + 1)]
    rng.shuffle(dpairs)
    for m, n in dpairs[: min(len(dpairs), 6 * n_carbons)]:
        add([rad[m], rad[n]], [alk[m], alke[n]], Ea=rng.uniform(0.0, 8.0e3),
            A_per_s=10 ** rng.uniform(8.5, 9.5), bimolecular=True)
    return _store(species, reacs, prods, Eas, As)


def _store(species, reacs, prods, Eas, As) -> Network:
    """The reaction store's rules: no-ops and molecularity > 2 refused,
    duplicates (same sorted reactants and products) dropped, the first
    kept with its parameters."""
    sid = {s: i for i, s in enumerate(species)}
    seen = set()
    R_, P_, E_, A_ = [], [], [], []
    for r, p, e, a in zip(reacs, prods, Eas, As):
        if Counter(r) == Counter(p) or len(r) > 2 or len(p) > 2:
            continue
        key = (tuple(sorted(r)), tuple(sorted(p)))
        if key in seen:
            continue
        seen.add(key)
        R_.append(tuple(sid[s] for s in key[0]))
        P_.append(tuple(sid[s] for s in key[1]))
        E_.append(e)
        A_.append(a)
    return Network(tuple(species), tuple(R_), tuple(P_),
                   np.asarray(E_, dtype=np.float64),
                   np.asarray(A_, dtype=np.float64))


GENERATORS = {"synthetic_pyrolysis_network": synthetic_pyrolysis_network}


def from_config(config: dict) -> Network:
    """The network a configuration file names (``network`` with
    ``generator``, ``n_carbons`` and ``seed``), checked against the sizes
    the file states."""
    spec = config["network"]
    net = GENERATORS[spec["generator"]](spec["n_carbons"], spec["seed"])
    if (net.nr, net.ns) != (config["reactions"], config["species"]):
        raise ValueError(f"{config['name']}: the generator gives {net.nr} "
                         f"reactions / {net.ns} species, the file states "
                         f"{config['reactions']} / {config['species']}")
    return net
