from .builders import EMTBuilder, FHIAimsBuilder, NWChemDFTBuilder
from .conversion import atoms_to_frame, frame_to_atoms, imaginary_ve_tol
from .neb import (get_initial_sys_mult, get_rxn_mult, highest_energy_frame,
                  neb)
from .properties import (correct_magmoms_for_mult, get_charge, get_formal_charges,
                         get_hydrogen_idxs, get_initial_magmoms, get_mult,
                         kabsch_fit, kabsch_fit_frame, kabsch_rmsd,
                         moments_of_inertia, permute_hydrogens)
from .vibrations import (calc_species_vibrations, calc_ts_vibrations,
                         select_modes)

__all__ = [
    "EMTBuilder", "FHIAimsBuilder", "NWChemDFTBuilder",
    "atoms_to_frame", "frame_to_atoms", "imaginary_ve_tol",
    "get_initial_sys_mult", "get_rxn_mult", "highest_energy_frame", "neb",
    "correct_magmoms_for_mult", "get_charge", "get_formal_charges",
    "get_hydrogen_idxs", "get_initial_magmoms", "get_mult",
    "kabsch_fit", "kabsch_fit_frame", "kabsch_rmsd", "moments_of_inertia",
    "permute_hydrogens",
    "calc_species_vibrations", "calc_ts_vibrations", "select_modes",
    "cross_check", "numpy_enthalpy", "numpy_entropy",
]


def __getattr__(name):
    # ASENEBCalculator requires ASE at construction; import lazily so the
    # package imports cleanly everywhere.
    if name == "ASENEBCalculator":
        from .calculator import ASENEBCalculator
        return ASENEBCalculator
    if name in ("cross_check", "numpy_enthalpy", "numpy_entropy",
                "make_idealgas_thermo", "asethermo_entropy",
                "asethermo_enthalpy"):
        from . import thermo_check
        return getattr(thermo_check, name)
    raise AttributeError(name)
