"""RDKit-backed atom mapping — the reference's production algorithm.

Implements Julia reference src/rdkit/rdkit.jl:30-191 (itself based on
Colin Grambow's ard_gsm): molecules are compared as RAW CONNECTIVITY maps
(every bond forced SINGLE, no bond-order/radical perception), so a
substructure match between the geometry-derived graph and the
SMILES-derived graph transfers atom map numbers exactly, independent of
kekulisation or radical placement — the property the chem-lite VF2
fallback cannot guarantee for aromatic/charged species.

Only imported when RDKit is available (chem.backends.HAS_RDKIT); the
public entry points live in chem.conversion and dispatch here.
"""
from __future__ import annotations

import numpy as np

from .xyz import Frame, frame_positions, frame_species, frame_to_xyz, make_frame


def _element_counts(symbols) -> dict:
    counts: dict = {}
    for s in symbols:
        counts[s] = counts.get(s, 0) + 1
    return counts


def _frame_connectivity(frame: Frame) -> list[tuple[int, int]]:
    """Bond list of the frame's molecular graph.

    The reference derives connectivity through OpenBabel's perception
    (rdkit.jl:44-45: ``pybel.readstring("xyz", ...)``); when OpenBabel is
    importable the same path is used, otherwise chem-lite's
    covalent-radius perception supplies the identical-graph substitute.
    """
    from . import backends
    if backends.HAS_OPENBABEL:
        try:
            from openbabel import pybel
            pbmol = pybel.readstring("xyz", frame_to_xyz(frame))
            bonds = []
            from openbabel import openbabel as ob
            for bond in ob.OBMolBondIter(pbmol.OBMol):
                bonds.append((bond.GetBeginAtomIdx() - 1,
                              bond.GetEndAtomIdx() - 1))
            return bonds
        except Exception:  # pragma: no cover - OB import/runtime quirks
            pass
    from .graphmol import mol_from_frame
    return list(mol_from_frame(frame).bonds.keys())


def frame_to_rdkit(frame: Frame, with_coords: bool = False):
    """ExtXYZ frame -> RDKit Mol as a raw single-bonded connectivity map
    (rdkit.jl:44-66). Atom map numbers are the 1-based frame indices."""
    from rdkit import Chem
    from rdkit.Geometry import Point3D

    species = frame_species(frame)
    em = Chem.RWMol()
    for i, sym in enumerate(species):
        atom = Chem.Atom(sym)
        atom.SetAtomMapNum(i + 1)
        atom.SetNoImplicit(True)
        em.AddAtom(atom)
    for a, b in _frame_connectivity(frame):
        em.AddBond(int(a), int(b), Chem.BondType.SINGLE)
    mol = em.GetMol()
    if with_coords:
        conf = Chem.Conformer(len(species))
        pos = frame_positions(frame)
        for i in range(len(species)):
            conf.SetAtomPosition(i, Point3D(*map(float, pos[i])))
        mol.AddConformer(conf)
    try:
        Chem.SanitizeMol(
            mol, Chem.SanitizeFlags.SANITIZE_FINDRADICALS
            | Chem.SanitizeFlags.SANITIZE_SETAROMATICITY)
    except Exception:
        pass
    return mol


def atom_map_smiles(frame: Frame, smi: str) -> str:
    """Atom-mapped SMILES with map numbers = 1-based frame indices
    (rdkit.jl:87-127). Golden form for ethene:
    ``[C:1](=[C:2]([H:5])[H:6])([H:3])[H:4]``."""
    from rdkit import Chem

    true_counts = _element_counts(frame_species(frame))
    mol_sanitised = Chem.AddHs(Chem.MolFromSmiles(smi))
    sani_counts = _element_counts(
        a.GetSymbol() for a in mol_sanitised.GetAtoms())
    if true_counts != sani_counts:
        raise ValueError(
            f"Unable to match SMILES atoms to XYZ atoms ({smi}: "
            f"{sani_counts} vs frame {true_counts}).")

    mol_with_map = frame_to_rdkit(frame)
    mol_sani_sb = Chem.Mol(mol_sanitised)
    for bond in mol_sani_sb.GetBonds():
        bond.SetBondType(Chem.BondType.SINGLE)

    match = mol_sani_sb.GetSubstructMatch(mol_with_map)
    if mol_with_map.GetNumAtoms() != len(match):
        raise ValueError(
            "Incorrect number of atoms when matching substruct during "
            "atom mapping.")
    for atom in mol_with_map.GetAtoms():
        idx = match[atom.GetIdx()]
        mol_sanitised.GetAtomWithIdx(idx).SetAtomMapNum(atom.GetAtomMapNum())
    return Chem.MolToSmiles(mol_sanitised)


def atom_map_frame(am_smi: str, frame: Frame) -> Frame:
    """Reorder ``frame`` atoms to match an atom-mapped SMILES by raw
    single-bond substructure matching (rdkit.jl:146-191)."""
    from rdkit import Chem

    params = Chem.SmilesParserParams()
    params.removeHs = False
    params.sanitize = False
    mol_template = Chem.MolFromSmiles(am_smi, params)
    for bond in mol_template.GetBonds():
        bond.SetBondType(Chem.BondType.SINGLE)

    mol_target = frame_to_rdkit(frame)
    mol_target_sb = Chem.Mol(mol_target)
    for bond in mol_target_sb.GetBonds():
        bond.SetBondType(Chem.BondType.SINGLE)
    for atom in mol_target_sb.GetAtoms():
        atom.SetAtomMapNum(0)

    match = mol_target_sb.GetSubstructMatch(mol_template)
    if mol_template.GetNumAtoms() != len(match):
        raise ValueError(
            "Incorrect number of atoms when matching substruct during "
            "atom mapping.")
    for atom in mol_template.GetAtoms():
        idx = match[atom.GetIdx()]
        mol_target.GetAtomWithIdx(idx).SetAtomMapNum(atom.GetAtomMapNum())

    n = len(frame_species(frame))
    transfer = np.zeros(n, dtype=int)
    for atom in mol_target.GetAtoms():
        transfer[atom.GetIdx()] = atom.GetAtomMapNum()

    pos = frame_positions(frame)
    species = frame_species(frame)
    new_pos = np.zeros_like(np.asarray(pos, dtype=float))
    new_species = [""] * n
    for i, m in enumerate(transfer):
        new_pos[m - 1] = pos[i]
        new_species[m - 1] = species[i]
    return make_frame(new_species, new_pos, frame.get("info", {}))
