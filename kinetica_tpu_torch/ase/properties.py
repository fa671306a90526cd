"""Spin/charge bookkeeping and geometry alignment utilities.

Capability parity with Julia reference src/ase/optimise.jl's pure parts:

* :func:`get_mult` / :func:`get_charge` / :func:`get_formal_charges` /
  :func:`get_initial_magmoms` (+ caching variants) — derived here from
  chem-lite's radical/charge perception instead of RDKit/OpenBabel
  (optimise.jl:6-96),
* :func:`correct_magmoms_for_mult` — spin-flip reconciliation across a
  reaction so single-reference NEB paths keep one electronic state
  (optimise.jl:118-186),
* :func:`kabsch_rmsd` / :func:`kabsch_fit` — optimal rotation alignment
  (optimise.jl:319-324; the reference defers to the 'rmsd' package, here
  implemented directly with numpy SVD),
* :func:`get_hydrogen_idxs` / :func:`permute_hydrogens` — RMSD-reducing
  hydrogen permutation fixing ambiguous atom maps (optimise.jl:332-414),
* :func:`moments_of_inertia` — principal moments (amu Å^2), needed for
  rotational thermochemistry (ASE provides these when present).
"""
from __future__ import annotations

import numpy as np

from ..chem import atom_map_smiles, from_smiles
from ..chem.elements import atomic_mass
from ..chem.xyz import frame_positions, frame_species
from ..utils.logging import logger


# ---------------------------------------------------------------------------
# Species spin/charge properties (chem-lite based)
# ---------------------------------------------------------------------------

def get_mult(sd, sid) -> int:
    """Spin multiplicity = unpaired electrons + 1 (optimise.jl:6-15)."""
    mol = from_smiles(sd.toStr[sid])
    n_rad = sum(mol.radical_electrons(i) for i in range(mol.n_atoms))
    return n_rad + 1


def get_mult_cached(sd, sid) -> int:
    sd.cache.setdefault("mult", {})[sid] = get_mult(sd, sid)
    return sd.cache["mult"][sid]


def get_charge(sd, sid) -> int:
    mol = from_smiles(sd.toStr[sid])
    return int(sum(mol.charges))


def get_charge_cached(sd, sid) -> int:
    sd.cache.setdefault("charge", {})[sid] = get_charge(sd, sid)
    return sd.cache["charge"][sid]


def get_formal_charges(amsmi_or_sd, sid=None) -> np.ndarray:
    """Per-atom formal charges in atom-map order (optimise.jl:43-66)."""
    if sid is None:
        amsmi = amsmi_or_sd
    else:
        sd = amsmi_or_sd
        amsmi = atom_map_smiles(sd.xyz[sid], sd.toStr[sid])
    mol = from_smiles(amsmi)
    mapnums = getattr(mol, "_map_numbers", {})
    out = np.zeros(mol.n_atoms)
    for i in range(mol.n_atoms):
        slot = mapnums.get(i, i + 1) - 1
        out[slot] = mol.charges[i]
    return out


def get_formal_charges_cached(sd, sid) -> np.ndarray:
    sd.cache.setdefault("formal_charges", {})[sid] = get_formal_charges(sd, sid)
    return sd.cache["formal_charges"][sid]


def get_initial_magmoms(amsmi_or_sd, sid=None) -> np.ndarray:
    """Per-atom initial magnetic moments = radical electron counts in
    atom-map order (optimise.jl:70-96)."""
    if sid is None:
        amsmi = amsmi_or_sd
    else:
        sd = amsmi_or_sd
        amsmi = atom_map_smiles(sd.xyz[sid], sd.toStr[sid])
    mol = from_smiles(amsmi)
    mapnums = getattr(mol, "_map_numbers", {})
    out = np.zeros(mol.n_atoms)
    for i in range(mol.n_atoms):
        slot = mapnums.get(i, i + 1) - 1
        out[slot] = mol.radical_electrons(i)
    return out


def get_initial_magmoms_cached(sd, sid) -> np.ndarray:
    sd.cache.setdefault("initial_magmoms", {})[sid] = get_initial_magmoms(sd, sid)
    return sd.cache["initial_magmoms"][sid]


def correct_magmoms_for_mult(reac_magmoms: np.ndarray, prod_magmoms: np.ndarray,
                             mult: int) -> tuple[np.ndarray, np.ndarray]:
    """Flip radical spins so both endpoint magmom sets match ``mult``.

    Prefers flipping lone radical electrons (+1 -> -1); falls back to
    pairing flips (2 <-> 0, e.g. singlet <-> triplet carbene). Raises when
    no consistent assignment exists. Mirrors optimise.jl:118-186 exactly;
    returns corrected copies instead of mutating.
    """
    r = np.asarray(reac_magmoms, dtype=int).copy()
    p = np.asarray(prod_magmoms, dtype=int).copy()

    def mdiff(m):
        return (int(m.sum()) + 1) - mult

    rdiff, pdiff = mdiff(r), mdiff(p)
    if rdiff == 0 and pdiff == 0:
        return r.astype(float), p.astype(float)

    reactive = [i for i in range(len(r)) if r[i] != p[i]]
    lone_r = [i for i in reactive if r[i] == 1]
    lone_p = [i for i in reactive if p[i] == 1]
    dbl_r = [i for i in reactive if r[i] == 2]
    dbl_p = [i for i in reactive if p[i] == 2]
    if rdiff != 0 and not (lone_r or dbl_r):
        raise ValueError("Reactant magmoms cannot be corrected to match "
                         "reaction multiplicity (no lone radical electrons).")
    if pdiff != 0 and not (lone_p or dbl_p):
        raise ValueError("Product magmoms cannot be corrected to match "
                         "reaction multiplicity (no lone radical electrons).")

    while rdiff != 0:
        if len(lone_r) >= abs(rdiff):
            idx = lone_r.pop()
            r[idx] *= -1
        elif dbl_r:
            idx = dbl_r.pop()
            r[idx] = 2 if r[idx] == 0 else 0
        else:
            raise ValueError("Reactant magmoms cannot be corrected to match "
                             "reaction multiplicity.")
        rdiff = mdiff(r)
    while pdiff != 0:
        if len(lone_p) >= abs(pdiff):
            idx = lone_p.pop()
            p[idx] *= -1
        elif dbl_p:
            idx = dbl_p.pop()
            p[idx] = 2 if p[idx] == 0 else 0
        else:
            raise ValueError("Product magmoms cannot be corrected to match "
                             "reaction multiplicity.")
        pdiff = mdiff(p)
    return r.astype(float), p.astype(float)


# ---------------------------------------------------------------------------
# Kabsch alignment + hydrogen permutation
# ---------------------------------------------------------------------------

def _kabsch_rotation(P: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """Optimal rotation matrix mapping centred P onto centred Q (SVD)."""
    H = P.T @ Q
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    return Vt.T @ D @ U.T


def kabsch_fit(P: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """Rotate+translate P for maximum overlap with Q."""
    P = np.asarray(P, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    Pc, Qc = P.mean(axis=0), Q.mean(axis=0)
    R = _kabsch_rotation(P - Pc, Q - Qc)
    return (P - Pc) @ R.T + Qc


def kabsch_rmsd(P: np.ndarray, Q: np.ndarray) -> float:
    fitted = kabsch_fit(P, Q)
    return float(np.sqrt(np.mean(np.sum((fitted - np.asarray(Q)) ** 2, axis=1))))


def kabsch_fit_frame(frame1, frame2) -> dict:
    """Return frame1 with positions Kabsch-fitted onto frame2
    (optimise.jl:319-324)."""
    from ..chem.xyz import make_frame
    pos = kabsch_fit(frame_positions(frame1), frame_positions(frame2))
    return make_frame(frame_species(frame1), pos, frame1.get("info", {}))


def get_hydrogen_idxs(amsmi: str) -> list[list[int]]:
    """Map numbers of H atoms per fragment of an atom-mapped SMILES
    (optimise.jl:332-357). 1-based map numbers, grouped by '.'-fragments."""
    mol = from_smiles(amsmi)
    mapnums = getattr(mol, "_map_numbers", {})
    # group atoms by connected fragment in SMILES order
    from ..chem.graphmol import split_fragments
    frags = split_fragments(mol)
    out = []
    for frag, idx in frags:
        # SMILES-string appearance order, NOT sorted — the reference's
        # parser (optimise.jl:332-357) collects H map numbers in the
        # order they appear in the string (golden ase.jl:41:
        # "[C:1](=[C:2]([H:5])[H:6])([H:3])[H:4]" -> [[5, 6, 3, 4]])
        # and downstream bookkeeping indexes into that order.
        hs = [mapnums[i] for i in sorted(idx)
              if mol.species[i] == "H" and i in mapnums]
        out.append(hs)
    return out


def permute_hydrogens(frame1, hidxs: list[list[int]], frame2) -> dict:
    """Swap same-fragment hydrogens in frame1 whenever that lowers the
    Kabsch RMSD to frame2; repeat to convergence (optimise.jl:366-414)."""
    from ..chem.xyz import make_frame
    c1 = frame_positions(frame1)
    c2 = frame_positions(frame2)
    all_h = [h for grp in hidxs for h in grp]
    if len(all_h) > 1:
        best = c1.copy()
        best_rmsd = kabsch_rmsd(best, c2)
        swapping = True
        while swapping:
            swapping = False
            for grp in hidxs:
                if len(grp) < 2:
                    continue
                for a in range(len(grp) - 1):
                    for b in range(a + 1, len(grp)):
                        i, j = grp[a] - 1, grp[b] - 1
                        swap = best.copy()
                        swap[[i, j]] = best[[j, i]]
                        r = kabsch_rmsd(swap, c2)
                        if r < best_rmsd:
                            best, best_rmsd = swap, r
                            swapping = True
        c1 = kabsch_fit(best, c2)
    return make_frame(frame_species(frame1), c1, frame1.get("info", {}))


def moments_of_inertia(frame) -> np.ndarray:
    """Principal moments of inertia in amu Å^2 (ascending)."""
    species = frame_species(frame)
    pos = frame_positions(frame)
    masses = np.array([atomic_mass(s) for s in species])
    com = (masses[:, None] * pos).sum(axis=0) / masses.sum()
    r = pos - com
    x, y, z = r[:, 0], r[:, 1], r[:, 2]
    Ixx = np.sum(masses * (y ** 2 + z ** 2))
    Iyy = np.sum(masses * (x ** 2 + z ** 2))
    Izz = np.sum(masses * (x ** 2 + y ** 2))
    Ixy = -np.sum(masses * x * y)
    Ixz = -np.sum(masses * x * z)
    Iyz = -np.sum(masses * y * z)
    I = np.array([[Ixx, Ixy, Ixz], [Ixy, Iyy, Iyz], [Ixz, Iyz, Izz]])
    return np.sort(np.linalg.eigvalsh(I))
