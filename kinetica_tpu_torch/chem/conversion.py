"""Chemistry conversion API — the reference's L2 glue, backend-pluggable.

Mirrors the public surface of Julia reference src/{openbabel,rdkit}/ and
src/ase/conversion.jl:

* :func:`ingest_xyz_system` — split a (multi-molecule) XYZ into fragment
  canonical SMILES + geometry frames, with radical fix-up
  (openbabel/conversion.jl:12-33),
* :func:`xyz_to_frame` / :func:`frame_to_xyz` / :func:`xyz_file_to_str`,
* :func:`xyz_from_smiles` / :func:`frame_from_smiles` — 3D geometry from
  SMILES (conversion.jl:104-138; rdkit.jl:1-29),
* :func:`atom_map_smiles` — map frame atom indices onto canonical SMILES
  (rdkit.jl:87-127, after ard_gsm),
* :func:`atom_map_frame` — reorder a frame's atoms to match an atom-mapped
  SMILES (rdkit.jl:146-191),
* :func:`get_species_stats` — cache per-species molecular weights and
  average COM-atom radii (+vdW correction) (openbabel/properties.jl:17-75).

Backend selection: RDKit/OpenBabel are used when importable (their
canonical SMILES and 3D embedding are higher quality); otherwise the
self-contained chem-lite implementations run the entire pipeline.
"""
from __future__ import annotations

import numpy as np

from ..utils.logging import logger
from . import backends
from .elements import atomic_mass, vdw_radius
from .graphmol import (Molecule, find_isomorphism, from_smiles,
                       mol_from_frame, split_fragments, to_smiles)
from .xyz import (Frame, frame_positions, frame_species, frame_to_xyz,
                  make_frame, read_xyz_file, xyz_file_to_str, xyz_to_frame,
                  xyz_to_frames)

__all__ = [
    "ingest_xyz_system", "xyz_to_frame", "frame_to_xyz", "xyz_file_to_str",
    "xyz_from_smiles", "frame_from_smiles", "smiles_from_frame",
    "atom_map_smiles", "atom_map_frame", "get_species_stats",
    "canonical_smiles",
]


def canonical_smiles(smiles: str) -> str:
    """Canonicalise a SMILES string through the active backend."""
    if backends.HAS_RDKIT:
        from rdkit import Chem
        mol = Chem.MolFromSmiles(smiles, sanitize=True)
        if mol is not None:
            return Chem.MolToSmiles(mol)
    return to_smiles(from_smiles(smiles))


def smiles_from_frame(frame: Frame, fix_radicals: bool = True) -> str:
    """Canonical SMILES of one (single-fragment) frame.

    With OpenBabel installed this is its perception + canonical "can"
    output (the reference's tool for geometry->SMILES); chem-lite's
    valence-based perception otherwise.
    """
    if backends.HAS_OPENBABEL:
        from .openbabel_glue import ingest_xyz_system as _ob_ingest
        smis, _ = _ob_ingest(frame_to_xyz(frame), fix_radicals=fix_radicals)
        if len(smis) == 1:
            return smis[0]
        return ".".join(sorted(smis))
    mol = mol_from_frame(frame)
    return to_smiles(mol)


def ingest_xyz_system(xyz: str, fix_radicals: bool = True
                      ) -> tuple[list[str], list[Frame]]:
    """Split an XYZ (string or file path) into fragment SMILES + frames.

    Returns parallel lists: one canonical SMILES and one geometry frame
    per connected molecular fragment (openbabel/conversion.jl:12-33).
    With OpenBabel installed, perception, fragment separation, canonical
    SMILES and the OBCanonicalRadicals ``fix_radicals`` repair run through
    it exactly as in the reference (chem.openbabel_glue); the chem-lite
    path below is the self-contained fallback, whose valence-based
    perception produces canonical radicals natively (no fixup needed).
    """
    import os
    if os.path.exists(xyz):
        xyz_str = xyz_file_to_str(xyz)
    else:
        xyz_str = xyz

    if backends.HAS_OPENBABEL:
        from .openbabel_glue import ingest_xyz_system as _ob_ingest
        return _ob_ingest(xyz_str, fix_radicals=fix_radicals)

    frame = xyz_to_frame(xyz_str)
    mol = mol_from_frame(frame)
    smis, sub_frames = [], []
    pos = frame_positions(frame)
    species = frame_species(frame)
    for frag, idx in split_fragments(mol):
        smis.append(to_smiles(frag))
        sub_frames.append(make_frame([species[i] for i in idx], pos[idx],
                                     frame.get("info", {})))
    return smis, sub_frames


def frame_from_smiles(smiles: str, seed: int = 10) -> Frame:
    """3D geometry frame from SMILES.

    With RDKit: seeded ETKDG embedding + MMFF/UFF cleanup (the reference's
    rdkit variant, rdkit.jl:1-29, uses seed=10 for reproducibility). With
    chem-lite: crude force-relaxed embedding (adequate as a geometry seed
    for downstream optimisers, not as a final geometry).
    """
    if backends.HAS_RDKIT:
        from rdkit import Chem
        from rdkit.Chem import AllChem
        mol = Chem.AddHs(Chem.MolFromSmiles(smiles))
        AllChem.EmbedMolecule(mol, randomSeed=seed)
        try:
            AllChem.MMFFOptimizeMolecule(mol)
        except Exception:
            pass
        conf = mol.GetConformer()
        species = [a.GetSymbol() for a in mol.GetAtoms()]
        pos = [[conf.GetAtomPosition(i).x, conf.GetAtomPosition(i).y,
                conf.GetAtomPosition(i).z] for i in range(mol.GetNumAtoms())]
        return make_frame(species, pos)
    return _embed_3d_lite(from_smiles(smiles), seed=seed)


def xyz_from_smiles(smiles: str, seed: int = 10) -> str:
    """XYZ string from SMILES (conversion.jl:104-125)."""
    return frame_to_xyz(frame_from_smiles(smiles, seed=seed))


def _lone_pairs(mol: Molecule, i: int) -> int:
    """Lone pairs from main-group valence-electron count (for VSEPR)."""
    from .elements import atomic_number
    z = atomic_number(mol.species[i])
    ve = z if z <= 2 else (z - 2 if z <= 10 else (z - 10 if z <= 18 else 4))
    ve -= mol.charges[i]
    spare = ve - mol.total_bond_order(i) - mol.radical_electrons(i)
    return max(0, spare) // 2


def _embed_3d_lite(mol: Molecule, seed: int = 10, n_steps: int = 400) -> Frame:
    """Spring-relaxation 3D embedding: bonds at covalent lengths, VSEPR
    1-3 angle springs (lone-pair aware: NH3 pyramidalises, H2O bends,
    sp carbons straighten), nonbonded pairs repelled — a
    distance-geometry-flavoured fallback."""
    from .elements import covalent_radius
    rng = np.random.default_rng(seed)
    n = mol.n_atoms
    pos = rng.normal(scale=1.5 + 0.1 * n ** (1 / 3), size=(n, 3))
    if n == 1:
        return make_frame(mol.species, np.zeros((1, 3)))
    bond_len = {}
    for (a, b), o in mol.bonds.items():
        r = covalent_radius(mol.species[a]) + covalent_radius(mol.species[b])
        bond_len[(a, b)] = r * (1.0 - 0.08 * (o - 1))

    def blen(a, b):
        return bond_len.get((a, b)) or bond_len.get((b, a)) or 1.5

    # VSEPR 1-3 rest distances: steric number = neighbours + lone pairs
    # picks the ideal angle; law of cosines gives the neighbour-pair
    # separation each angle spring targets.
    # In small rings two different centres can produce the same 1-3 pair
    # with different rest distances — accumulate and average instead of
    # letting the last writer win (r4 advisor finding).
    angle_d0_acc: dict[tuple[int, int], list[float]] = {}
    for c in range(n):
        nb = mol.neighbors(c)
        if len(nb) < 2:
            continue
        sn = len(nb) + _lone_pairs(mol, c)
        theta = {2: np.pi}.get(sn, 2.0 * np.pi / 3.0 if sn == 3
                               else np.deg2rad(109.47) if sn == 4
                               else np.pi / 2.0)
        for x in range(len(nb)):
            for y in range(x + 1, len(nb)):
                a, b = nb[x], nb[y]
                ra, rb = blen(c, a), blen(c, b)
                d0 = np.sqrt(ra * ra + rb * rb
                             - 2.0 * ra * rb * np.cos(theta))
                angle_d0_acc.setdefault((min(a, b), max(a, b)),
                                        []).append(d0)
    angle_d0 = {p: float(np.mean(v)) for p, v in angle_d0_acc.items()}

    # pi-system planarity: atoms of a double bond between two SN-3
    # centres plus all their neighbours are restrained to a common
    # best-fit plane (flattens C=C torsions and aromatic rings — needed
    # for the rotational-symmetry detection in chem.autode_glue).
    planar_groups = []
    for (a, b), o in mol.bonds.items():
        if o != 2:
            continue
        sn_a = len(mol.neighbors(a)) + _lone_pairs(mol, a)
        sn_b = len(mol.neighbors(b)) + _lone_pairs(mol, b)
        if sn_a == 3 and sn_b == 3:
            grp = sorted({a, b, *mol.neighbors(a), *mol.neighbors(b)})
            if len(grp) > 3:
                planar_groups.append(np.asarray(grp))

    lr = 0.05
    for _ in range(n_steps):
        forces = np.zeros_like(pos)
        for (a, b), r0 in bond_len.items():
            d = pos[b] - pos[a]
            dist = np.linalg.norm(d) + 1e-12
            f = 2.0 * (dist - r0) * d / dist
            forces[a] += f
            forces[b] -= f
        for (a, b), r0 in angle_d0.items():
            d = pos[b] - pos[a]
            dist = np.linalg.norm(d) + 1e-12
            f = 1.0 * (dist - r0) * d / dist
            forces[a] += f
            forces[b] -= f
        for grp in planar_groups:
            pts = pos[grp]
            centred = pts - pts.mean(axis=0)
            # smallest principal direction = plane normal
            _, _, vt = np.linalg.svd(centred, full_matrices=False)
            normal = vt[-1]
            dev = centred @ normal
            forces[grp] -= 1.5 * dev[:, None] * normal[None, :]
        # soft repulsion between non-bonded pairs (1-3 pairs are governed
        # by their angle spring instead)
        for a in range(n):
            for b in range(a + 1, n):
                if ((a, b) in bond_len or (b, a) in bond_len
                        or (a, b) in angle_d0):
                    continue
                d = pos[b] - pos[a]
                dist = np.linalg.norm(d) + 1e-12
                if dist < 2.2:
                    f = 0.6 * (2.2 - dist) * d / dist
                    forces[a] -= f
                    forces[b] += f
        pos += lr * forces
    pos -= pos.mean(axis=0)
    return make_frame(mol.species, pos)


def atom_map_smiles(frame: Frame, smiles: str) -> str:
    """Atom-mapped SMILES: map numbers = 1-based frame atom indices.

    Matches the frame's perceived molecular graph onto the given SMILES and
    emits every atom (including H) with its frame position as the map
    number (reference rdkit.jl:87-127; golden form for ethene:
    ``[C:1](=[C:2]([H:5])[H:6])([H:3])[H:4]``).

    With RDKit installed this runs the reference's raw-connectivity
    substructure algorithm (chem.rdkit_glue, after ard_gsm) — robust for
    aromatic/charged species; chem-lite VF2 handles the organic subset
    otherwise.
    """
    if backends.HAS_RDKIT:
        from . import rdkit_glue
        return rdkit_glue.atom_map_smiles(frame, smiles)
    mol_frame = mol_from_frame(frame)
    mol_smi = from_smiles(smiles)
    mapping = find_isomorphism(mol_smi, mol_frame)
    if mapping is None:
        raise ValueError("Frame does not match SMILES for atom mapping "
                         f"({smiles} vs {mol_frame.formula()})")
    map_numbers = [mapping[i] + 1 for i in range(mol_smi.n_atoms)]
    return to_smiles(mol_smi, map_numbers=map_numbers)


def _parse_mapped(mapped_smiles: str) -> tuple[Molecule, dict[int, int]]:
    mol = from_smiles(mapped_smiles)
    mapnums = getattr(mol, "_map_numbers", {})
    if len(mapnums) != mol.n_atoms:
        raise ValueError("SMILES is not fully atom-mapped")
    return mol, mapnums


def atom_map_frame(mapped_smiles: str, frame: Frame) -> Frame:
    """Reorder ``frame`` atoms to match an atom-mapped SMILES
    (reference rdkit.jl:146-191).

    Output frame atom i corresponds to map number i+1 in the SMILES.
    Dispatches to the RDKit substructure algorithm when available
    (chem.rdkit_glue); chem-lite VF2 otherwise.
    """
    if backends.HAS_RDKIT:
        from . import rdkit_glue
        return rdkit_glue.atom_map_frame(mapped_smiles, frame)
    mol_smi, mapnums = _parse_mapped(mapped_smiles)
    mol_frame = mol_from_frame(frame)
    iso = find_isomorphism(mol_smi, mol_frame)
    if iso is None:
        raise ValueError("Frame does not match mapped SMILES")
    pos = frame_positions(frame)
    species = frame_species(frame)
    n = mol_smi.n_atoms
    new_pos = np.zeros((n, 3))
    new_species = [""] * n
    for smi_idx, frame_idx in iso.items():
        slot = mapnums[smi_idx] - 1
        new_pos[slot] = pos[frame_idx]
        new_species[slot] = species[frame_idx]
    return make_frame(new_species, new_pos, frame.get("info", {}))


def get_species_stats(sd, refresh: bool = False) -> None:
    """Cache per-species molecular weight and average COM-atom radius.

    Same contract as the reference (openbabel/properties.jl:17-75): fills
    ``sd.cache["weights"][sid]`` (amu) and ``sd.cache["radii"][sid]`` (Å,
    mean distance of atoms from the centre of mass plus the largest vdW
    radius as the surface correction).
    """
    weights = sd.cache.setdefault("weights", {})
    radii = sd.cache.setdefault("radii", {})
    for sid in range(sd.n):
        if not refresh and sid in weights and sid in radii:
            continue
        frame = sd.xyz.get(sid)
        smi = sd.toStr[sid]
        if frame is not None:
            species = frame_species(frame)
            pos = frame_positions(frame)
        else:
            mol = from_smiles(smi)
            species = mol.species
            pos = None
        weights[sid] = float(sum(atomic_mass(s) for s in species))
        if pos is not None and len(species) > 1:
            masses = np.array([atomic_mass(s) for s in species])
            com = (masses[:, None] * pos).sum(axis=0) / masses.sum()
            avg_r = float(np.mean(np.linalg.norm(pos - com, axis=1)))
        else:
            avg_r = 0.0
        vdw_corr = max(vdw_radius(s) for s in species)
        radii[sid] = avg_r + vdw_corr
