from .backends import HAS_ASE, HAS_AUTODE, HAS_OPENBABEL, HAS_RDKIT
from .conversion import (atom_map_frame, atom_map_smiles, canonical_smiles,
                         frame_from_smiles, get_species_stats,
                         ingest_xyz_system, smiles_from_frame, xyz_file_to_str,
                         xyz_from_smiles)
from .graphmol import (Molecule, from_smiles, is_isomorphic, mol_from_frame,
                       split_fragments, to_smiles)
from .xyz import (frame_positions, frame_species, frame_to_xyz, make_frame,
                  read_xyz_file, write_xyz_file, xyz_to_frame, xyz_to_frames)

__all__ = [
    "HAS_ASE", "HAS_AUTODE", "HAS_OPENBABEL", "HAS_RDKIT",
    "atom_map_frame", "atom_map_smiles", "canonical_smiles",
    "frame_from_smiles", "get_species_stats", "ingest_xyz_system",
    "smiles_from_frame", "xyz_file_to_str", "xyz_from_smiles",
    "Molecule", "from_smiles", "is_isomorphic", "mol_from_frame",
    "split_fragments", "to_smiles",
    "frame_positions", "frame_species", "frame_to_xyz", "make_frame",
    "read_xyz_file", "write_xyz_file", "xyz_to_frame", "xyz_to_frames",
]
