"""(CI-)NEB runner and spin heuristics.

Capability parity with Julia reference src/ase/neb.jl:

* :func:`get_initial_sys_mult` / :func:`get_rxn_mult` — system/reaction
  spin multiplicity heuristics (neb.jl:6-44), pure logic,
* :func:`neb` — image-chain construction (half reactant / half product
  copies), shared vs per-image calculators, linear/IDPP interpolation,
  fire/lbfgs/mdmin/ode optimisers, optional two-stage climbing-image run
  (neb.jl:74-163); requires ASE,
* :func:`highest_energy_frame` — TS extraction from the optimised path
  (neb.jl:166-175).
"""
from __future__ import annotations

import math
import os

import numpy as np

from ..chem import backends
from ..utils.logging import logger
from .conversion import atoms_to_frame, frame_to_atoms


def get_initial_sys_mult(mults) -> int:
    """Combined multiplicity of a system of molecules (neb.jl:6)."""
    mults = list(mults)
    return int(sum(mults) - (len(mults) - 1))


def get_rxn_mult(n_reacs: int, rmult: int, n_prods: int, pmult: int) -> int:
    """Reaction-wide multiplicity heuristic (neb.jl:27-44).

    Dissociations take the product mult, associations the reactant mult,
    balanced reactions the smaller of the two.
    """
    if n_reacs > n_prods:
        return pmult
    if n_reacs < n_prods:
        return rmult
    return min(rmult, pmult)


def get_rxn_mult_from_systems(reacsys, prodsys) -> int:
    return get_rxn_mult(reacsys["info"]["n_species"], reacsys["info"]["mult"],
                        prodsys["info"]["n_species"], prodsys["info"]["mult"])


def neb(reacsys, prodsys, calc, calcdir: str = "./", **kwargs):
    """Interpolate + optimise a (CI-)NEB path between endpoint frames.

    ``calc`` is an :class:`kinetica_tpu_torch.ase.calculator.ASENEBCalculator`
    carrying the NEB configuration (n_images, k, interpolation, optimiser,
    climb flags, tolerances) and the calculator builder. Returns
    ``(images, converged)``.
    """
    backends.require("ase", backends.HAS_ASE, "NEB calculations")
    from ase.mep import NEB
    try:
        from ase.mep.neb import NEBOptimizer
    except ImportError:  # older ASE layouts
        NEBOptimizer = None
    from ase.optimize import FIRE, LBFGS, MDMin

    logger.info("Running %sNEB calculation", "CI-" if calc.climb else "")
    rmult = reacsys["info"]["mult"]
    half = math.ceil(calc.n_images / 2)
    images = []
    for i in range(calc.n_images):
        src = reacsys if i < half else prodsys
        images.append(frame_to_atoms(src, src["info"].get("formal_charges"),
                                     src["info"].get("initial_magmoms")))
    if calc.parallel:
        for image in images:
            image.calc = calc.calc_builder(calcdir, rmult,
                                           reacsys["info"]["chg"], **kwargs)
    else:
        shared = calc.calc_builder(calcdir, rmult, reacsys["info"]["chg"],
                                   **kwargs)
        for image in images:
            image.calc = shared

    band = NEB(images, k=calc.neb_k, parallel=calc.parallel,
               allow_shared_calculator=not calc.parallel)
    if calc.interpolation not in ("linear", "idpp"):
        raise ValueError('Unknown interpolation method, must be one of '
                         '["linear", "idpp"]')
    band.interpolate(method=calc.interpolation)
    try:
        from ase.io import write as ase_write
        ase_write(os.path.join(calcdir, "interp.traj"), images)
    except Exception:
        pass

    if calc.neb_optimiser == "fire":
        opt = FIRE(band)
    elif calc.neb_optimiser == "lbfgs":
        opt = LBFGS(band)
    elif calc.neb_optimiser == "mdmin":
        opt = MDMin(band)
    elif calc.neb_optimiser == "ode" and NEBOptimizer is not None:
        opt = NEBOptimizer(band, verbose=1)
    else:
        raise ValueError('Unknown optimiser, must be one of '
                         '["ode", "fire", "lbfgs", "mdmin"]')

    conv = False
    try:
        if calc.climb:
            conv = bool(opt.run(fmax=calc.climb_ftol, steps=calc.maxiters))
            if conv:
                band.climb = True
                conv = bool(opt.run(fmax=calc.ftol, steps=calc.maxiters))
        else:
            conv = bool(opt.run(fmax=calc.ftol, steps=calc.maxiters))
    except Exception as exc:
        logger.debug("NEB optimisation raised: %s", exc)
        conv = False
    try:
        from ase.io import write as ase_write
        ase_write(os.path.join(calcdir, "neb_final.traj"), images)
    except Exception:
        pass
    logger.info("NEB %s", "converged" if conv else "not converged")
    return images, conv


def highest_energy_frame(images) -> dict:
    """TS = highest-energy image of the path, as a frame (neb.jl:166-175)."""
    energies = [float(img.get_potential_energy()) for img in images]
    ts_idx = int(np.argmax(energies))
    logger.debug("TS found at image %d/%d", ts_idx + 1, len(images))
    ts_atoms = images[ts_idx]
    ts = atoms_to_frame(ts_atoms, energies[ts_idx],
                        np.asarray(ts_atoms.get_moments_of_inertia()))
    ts["info"]["formal_charges"] = [float(x) for x in
                                    ts_atoms.get_initial_charges()]
    ts["info"]["initial_magmoms"] = [float(x) for x in
                                     ts_atoms.get_initial_magnetic_moments()]
    return ts
