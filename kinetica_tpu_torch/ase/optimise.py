"""ASE-driven geometry optimisation (gated).

Capability parity with the optimiser part of
Julia reference src/ase/optimise.jl:244-324: QuasiNewton/FIRE/BFGS/LBFGS
drivers, an explosion check after 10% of the iteration budget, optional
post-optimisation molecular-graph isomorphism guard (via chem-lite instead
of autodE), and write-back of positions/energy/inertias into the frame.
"""
from __future__ import annotations

import numpy as np

from ..chem import backends, frame_positions, frame_species, make_frame
from ..chem.graphmol import is_isomorphic, mol_from_frame
from ..utils.logging import logger
from .conversion import atoms_to_frame, frame_to_atoms
from .properties import moments_of_inertia

_OPTIMISERS = ("BFGSLineSearch", "fire", "bfgs", "lbfgs")


def geomopt(frame, calc_builder, calcdir: str = "./", mult: int = 1,
            chg: int = 0, formal_charges=None, initial_magmoms=None,
            optimiser: str = "BFGSLineSearch", fmax: float = 0.01,
            maxiters: int = 1000, check_isomorphic: bool = True,
            **kwargs) -> tuple[dict, bool]:
    """Optimise a frame's geometry; returns (updated_frame, converged).

    Mirrors geomopt! (optimise.jl:244-311): runs 10% of ``maxiters`` first
    and aborts if the residual exploded; optionally rejects optimisations
    that change the molecular graph.
    """
    backends.require("ase", backends.HAS_ASE, "geometry optimisation")
    from ase.optimize import BFGS, FIRE, LBFGS, QuasiNewton

    logger.debug("Starting geometry optimisation.")
    atoms = frame_to_atoms(frame, formal_charges, initial_magmoms)
    atoms.calc = calc_builder(calcdir, mult, chg, **kwargs)
    init_energy = float(atoms.get_potential_energy())
    init_inertias = np.asarray(atoms.get_moments_of_inertia())

    if optimiser == "BFGSLineSearch":
        opt = QuasiNewton(atoms)
    elif optimiser == "fire":
        opt = FIRE(atoms)
    elif optimiser == "bfgs":
        opt = BFGS(atoms)
    elif optimiser == "lbfgs":
        opt = LBFGS(atoms)
    else:
        raise ValueError(f"Unknown optimiser, must be one of {_OPTIMISERS}")

    conv = False
    checkiters = max(1, maxiters // 10)
    try:
        conv = bool(opt.run(fmax=fmax, steps=checkiters))
        if not conv:
            residual = float(getattr(opt, "get_residual", lambda: 0.0)() or 0.0)
            if residual > 1e5:
                logger.debug("Optimisation has exploded.")
            else:
                conv = bool(opt.run(fmax=fmax, steps=maxiters - checkiters))
    except Exception as exc:
        logger.debug("Geometry optimisation raised: %s", exc)
        conv = False

    if conv and check_isomorphic:
        post = atoms_to_frame(atoms)
        if not is_isomorphic(mol_from_frame(frame), mol_from_frame(post),
                             use_order=False):
            conv = False
            logger.debug("Geometry optimisation breaks molecular graph.")

    out = make_frame(frame_species(frame), frame_positions(frame),
                     frame.get("info", {}))
    if conv:
        out["arrays"]["pos"] = np.asarray(atoms.get_positions()).tolist()
        out["info"]["energy_ASE"] = float(atoms.get_potential_energy())
        out["arrays"]["inertias"] = np.asarray(
            atoms.get_moments_of_inertia()).tolist()
    else:
        out["info"]["energy_ASE"] = init_energy
        out["arrays"]["inertias"] = init_inertias.tolist()
    return out, conv


def geomopt_species(sd, sid, calc_builder, calcdir: str = "./", **kwargs
                    ) -> bool:
    """Optimise a species in-place using its cached spin/charge data
    (optimise.jl:237-243)."""
    frame, conv = geomopt(
        sd.xyz[sid], calc_builder, calcdir=calcdir,
        mult=sd.cache["mult"][sid], chg=sd.cache["charge"][sid],
        formal_charges=sd.cache["formal_charges"][sid],
        initial_magmoms=sd.cache["initial_magmoms"][sid], **kwargs)
    sd.xyz[sid] = frame
    return conv
