"""autodE glue: conformer searches, symmetry numbers, graph checks (gated).

Capability parity with Julia reference src/autode/: frame <-> autodE
Molecule conversion (conversion.jl:11-48), molecular-graph isomorphism
(utils.jl:8-28), symmetry number + geometry classification (utils.jl:30-39),
lowest-energy conformer search per species and NCI-complex conformer search
for multi-molecule reaction endpoints (conformers.jl:19-103, xTB-driven).

Without autodE installed, :func:`frame_symmetry` falls back to a
first-party implementation: geometry classification from the perceived
bond graph (exact — independent of embedding sloppiness), and the
rotational symmetry number counted as the graph automorphisms that are
realizable as PROPER rotations of the embedded geometry (Kabsch fit
with det(R)=+1). Reference goldens reproduced: ethene -> (4, 2), C#C
-> geometry class 1 (test/Python/autode.jl:40, 56-58).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from ..utils.logging import logger
from . import backends
from .xyz import frame_positions, frame_to_xyz, xyz_to_frame

LINEAR_INERTIA_TOL = 1e-2  # amu Å^2: smallest principal moment ~ 0 => linear
# Proper-rotation RMSD acceptance for the automorphism -> rotation test.
# With the VSEPR + pi-planarity embedder, true rotations fit at
# <= ~0.12 Å while improper-only permutations sit at >= ~0.29 Å (NH3's
# H swaps — reflections through the shallow pyramid — are the closest
# impostors); 0.2 splits the distributions. Distorted embeddings can
# only UNDERcount (methyl-torsion misalignment drops isobutane's C3),
# which is the conservative direction the sigma=1 fallback already had.
SYMMETRY_RMSD_TOL = 0.2
MAX_SYMMETRY_ATOMS = 30        # automorphism enumeration guard
MAX_SYMMETRY_MAPS = 20000


def frame_geometry_class(frame, mol=None) -> int:
    """0 = monoatomic, 1 = linear, 2 = nonlinear (utils.jl:30-39).

    Decided from the perceived bond graph when possible: linear iff no
    atom has more than two neighbours and every internal (2-neighbour)
    atom is an sp centre (total bond order to its neighbours >= 4 —
    C#C, O=C=O, HCN...). Diatomics are linear by construction. Falls
    back to the principal-moments test when perception fails (e.g.
    distorted TS geometries)."""
    n = int(frame["N_atoms"])
    if n == 1:
        return 0
    if n == 2:
        return 1
    if mol is None:
        try:
            from .graphmol import mol_from_frame
            mol = mol_from_frame(frame)
        except Exception:
            mol = None
    if mol is not None:
        degrees = [len(mol.neighbors(i)) for i in range(mol.n_atoms)]
        if max(degrees) <= 2:
            internal = [i for i in range(mol.n_atoms) if degrees[i] == 2]
            if all(sum(mol.bond_order(i, j) for j in mol.neighbors(i)) >= 4
                   for i in internal):
                return 1
        return 2
    from ..ase.properties import moments_of_inertia
    moments = moments_of_inertia(frame)
    return 1 if moments[0] < max(LINEAR_INERTIA_TOL,
                                 5e-2 * moments[2]) else 2


def _proper_kabsch_rmsd(x: np.ndarray, q: np.ndarray) -> float:
    """RMSD of the best PROPER rotation (det +1) mapping x onto q, both
    centred on their centroids."""
    xc = x - x.mean(axis=0)
    qc = q - q.mean(axis=0)
    H = xc.T @ qc
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    return float(np.sqrt(np.mean(np.sum((xc @ R.T - qc) ** 2, axis=1))))


def rotational_symmetry_number(frame, mol=None,
                               tol: float = SYMMETRY_RMSD_TOL) -> float:
    """External rotational symmetry number sigma from the embedded
    geometry: the number of bond-graph automorphisms realizable as
    proper rotations (det(R) = +1 Kabsch fit under ``tol`` RMSD).

    Linear molecules are special-cased from the graph (sigma = 2 iff the
    atom/bond chain is palindromic — C#C, O=C=O, [H][H]; else 1), so
    bent embeddings of genuinely linear species cannot undercount.
    Enumeration is capped (MAX_SYMMETRY_ATOMS / MAX_SYMMETRY_MAPS); on
    overflow the count found so far is returned — a valid lower bound,
    erring on the reference fallback's sigma = 1 side."""
    n = int(frame["N_atoms"])
    if n == 1:
        return 1.0
    if mol is None:
        try:
            from .graphmol import mol_from_frame
            mol = mol_from_frame(frame)
        except Exception:
            return 1.0
    if frame_geometry_class(frame, mol=mol) == 1:
        # chain order: walk from one terminal
        ends = [i for i in range(mol.n_atoms) if len(mol.neighbors(i)) <= 1]
        if len(ends) != 2:
            return 1.0
        chain = [ends[0]]
        while len(chain) < mol.n_atoms:
            nxt = [j for j in mol.neighbors(chain[-1]) if j not in chain]
            if not nxt:
                break
            chain.append(nxt[0])
        if len(chain) != mol.n_atoms:
            return 1.0
        syms = [mol.species[i] for i in chain]
        orders = [mol.bond_order(chain[k], chain[k + 1])
                  for k in range(len(chain) - 1)]
        return 2.0 if (syms == syms[::-1]
                       and orders == orders[::-1]) else 1.0
    if n > MAX_SYMMETRY_ATOMS:
        return 1.0
    import networkx as nx
    g = mol.to_nx()
    matcher = nx.algorithms.isomorphism.GraphMatcher(
        g, g,
        # chem-lite Molecule.to_nx labels nodes "element"/"charge"
        node_match=lambda a, b: (a.get("element") == b.get("element")
                                 and a.get("charge") == b.get("charge")),
        edge_match=lambda a, b: a.get("order") == b.get("order"))
    pos = np.asarray(frame_positions(frame), float)
    count, seen = 0, 0
    for mapping in matcher.isomorphisms_iter():
        seen += 1
        if seen > MAX_SYMMETRY_MAPS:
            logger.debug("rotational_symmetry_number: automorphism cap hit "
                         "(%d); returning lower bound %d", seen - 1, count)
            break
        perm = np.asarray([mapping[i] for i in range(n)])
        if _proper_kabsch_rmsd(pos, pos[perm]) < tol:
            count += 1
    return float(max(1, count))


def frame_to_autode(frame, mult: int = 1, chg: int = 0):
    """frame -> ade.Molecule via tempfile (reference conversion.jl:42-48)."""
    backends.require("autode", backends.HAS_AUTODE, "autodE conversion")
    import autode as ade
    with tempfile.NamedTemporaryFile("w", suffix=".xyz", delete=False) as fh:
        fh.write(frame_to_xyz(frame))
        path = fh.name
    try:
        return ade.Molecule(path, mult=mult, charge=chg)
    finally:
        os.unlink(path)


def autode_to_frame(mol) -> dict:
    """ade.Molecule -> frame (reference conversion.jl:11)."""
    backends.require("autode", backends.HAS_AUTODE, "autodE conversion")
    with tempfile.NamedTemporaryFile("w", suffix=".xyz", delete=False) as fh:
        path = fh.name
    try:
        mol.print_xyz_file(filename=path)
        with open(path) as f2:
            return xyz_to_frame(f2.read())
    finally:
        os.unlink(path)


def autode_is_isomorphic(graph1, graph2) -> bool:
    """Molecular-graph isomorphism (reference utils.jl:18-28)."""
    backends.require("autode", backends.HAS_AUTODE, "graph isomorphism")
    import networkx as nx
    return nx.is_isomorphic(
        graph1, graph2,
        node_match=lambda a, b: a.get("atom_label") == b.get("atom_label"))


def frame_symmetry(frame, mult: int = 1, chg: int = 0) -> tuple[float, int]:
    """(symmetry number, geometry class) of a frame (utils.jl:30-39).

    Uses autodE's symmetry detection when available, else the inertia
    fallback with sigma = 1.
    """
    if backends.HAS_AUTODE:
        mol = frame_to_autode(frame, mult=mult, chg=chg)
        sigma = float(mol.symmetry_number)
        if frame["N_atoms"] == 1:
            geom = 0
        elif bool(mol.is_linear()):
            geom = 1
        else:
            geom = 2
        return sigma, geom
    try:
        from .graphmol import mol_from_frame
        mol = mol_from_frame(frame)
    except Exception:
        mol = None
    return (rotational_symmetry_number(frame, mol=mol),
            frame_geometry_class(frame, mol=mol))


def autode_conformer_search(sd, sid, calcdir: str = "./") -> None:
    """Find a species' lowest-energy conformer via autodE/xTB, caching
    symmetry/geometry and updating the geometry (conformers.jl:19-49)."""
    backends.require("autode", backends.HAS_AUTODE, "conformer searches")
    import autode as ade
    mol = frame_to_autode(sd.xyz[sid], mult=sd.cache["mult"][sid],
                          chg=sd.cache["charge"][sid])
    method = ade.methods.XTB()
    cwd = os.getcwd()
    os.makedirs(calcdir, exist_ok=True)
    try:
        os.chdir(calcdir)
        mol.find_lowest_energy_conformer(lmethod=method)
    finally:
        os.chdir(cwd)
    frame = autode_to_frame(mol)
    frame["info"]["energy"] = float(mol.energy.to("ev"))
    sd.xyz[sid] = frame
    sd.cache.setdefault("symmetry", {})[sid] = float(mol.symmetry_number)
    geom = 0 if frame["N_atoms"] == 1 else (1 if mol.is_linear() else 2)
    sd.cache.setdefault("geometry", {})[sid] = geom


def autode_nci_conformer_search(frames: list, mults: list[int],
                                chgs: list[int], calcdir: str = "./") -> dict:
    """Lowest-energy NCI complex of several molecules (conformers.jl:75-103);
    returns the combined system frame."""
    backends.require("autode", backends.HAS_AUTODE, "NCI conformer searches")
    import autode as ade
    mols = [frame_to_autode(f, mult=m, chg=c)
            for f, m, c in zip(frames, mults, chgs)]
    nci = ade.NCIComplex(*mols)
    method = ade.methods.XTB()
    cwd = os.getcwd()
    os.makedirs(calcdir, exist_ok=True)
    try:
        os.chdir(calcdir)
        nci._generate_conformers()
        nci.conformers.optimise(method=method)
        nci.conformers.prune()
        nci._set_lowest_energy_conformer()
    finally:
        os.chdir(cwd)
    frame = autode_to_frame(nci)
    frame["info"]["energy"] = float(nci.energy.to("ev"))
    return frame
