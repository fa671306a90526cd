"""Finite-difference vibrational analysis (ASE-gated).

Capability parity with Julia reference src/ase/vibrations.jl: Hessian by
finite differences via ``ase.vibrations.Vibrations``; 3N-5 / 3N-6 mode
selection by geometry class; imaginary-mode tolerance or stripping
(vibrations.jl:23-129). The mode-count/imaginary filtering logic
(:func:`select_modes`) is pure and reusable without ASE.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from ..chem import backends
from ..utils.logging import logger


def select_modes(vib_energies, n_atoms: int, geometry: int,
                 ivetol: float = 0.1) -> list[float]:
    """Keep the top 3N-5 (linear) / 3N-6 (nonlinear) modes and handle
    imaginary components (vibrations.jl:44-66)."""
    ve = np.asarray(vib_energies, dtype=complex)
    if geometry == 1:
        keep = 3 * n_atoms - 5
    elif geometry == 2:
        keep = 3 * n_atoms - 6
    else:
        raise ValueError(f"Unknown geometry class {geometry} for mode selection")
    ve = ve[-keep:] if keep > 0 else ve[:0]
    if ivetol <= 0.0:
        real = [float(z.real) for z in ve if z.real > 0.0]
        n_removed = len(ve) - len(real)
        if n_removed:
            logger.debug("Removed %d imaginary modes.", n_removed)
        return real
    if any(z.imag > ivetol for z in ve):
        raise RuntimeError("Imaginary frequency detected in geometry.")
    return [float(z.real) for z in ve if z.real > 0.0]


def _run_vibrations(frame, mult, chg, calc_builder, calcdir, delta,
                    formal_charges, initial_magmoms, **kwargs):
    backends.require("ase", backends.HAS_ASE, "vibrational analysis")
    from ase.vibrations import Vibrations

    from .conversion import frame_to_atoms
    atoms = frame_to_atoms(frame, formal_charges, initial_magmoms)
    atoms.calc = calc_builder(calcdir, mult, chg, **kwargs)
    vibdir = os.path.join(calcdir, "vib")
    os.makedirs(vibdir, exist_ok=True)
    cwd = os.getcwd()
    try:
        os.chdir(calcdir)
        vib = Vibrations(atoms, delta=delta, name="vib")
        vib.run()
        energies = np.asarray(vib.get_energies())
    finally:
        os.chdir(cwd)
        shutil.rmtree(vibdir, ignore_errors=True)
    return energies


def calc_species_vibrations(sd, sid, calc_builder, calcdir: str = "./",
                            refresh: bool = False, delta: float = 0.01,
                            ivetol: float = 0.1, **kwargs) -> None:
    """Cache a species' vibrational energies in sd.cache["vib_energies"]
    (vibrations.jl:23-71)."""
    cache = sd.cache.setdefault("vib_energies", {})
    if sid in cache and not refresh:
        logger.debug("Species %d has vibrations cached, skipping.", sid)
        return
    geometry = sd.cache["geometry"][sid]
    if geometry == 0:
        logger.debug("Species %d is monoatomic, skipping vibrational "
                     "analysis.", sid)
        cache[sid] = []
        return
    energies = _run_vibrations(
        sd.xyz[sid], sd.cache["mult"][sid], sd.cache["charge"][sid],
        calc_builder, calcdir, delta,
        sd.cache["formal_charges"][sid], sd.cache["initial_magmoms"][sid],
        **kwargs)
    cache[sid] = select_modes(energies, sd.xyz[sid]["N_atoms"], geometry,
                              ivetol)


def calc_ts_vibrations(ts_cache: dict, rid, calc_builder, calcdir: str = "./",
                       delta: float = 0.01, ivetol: float = 0.1,
                       **kwargs) -> None:
    """Append a TS's vibrational energies to ts_cache["vib_energies"]
    (vibrations.jl:92-129)."""
    frame = ts_cache["xyz"][rid]
    energies = _run_vibrations(
        frame, ts_cache["mult"][rid], ts_cache["charge"][rid], calc_builder,
        calcdir, delta, frame["info"].get("formal_charges"),
        frame["info"].get("initial_magmoms"), **kwargs)
    ts_cache["vib_energies"][rid] = select_modes(
        energies, frame["N_atoms"], ts_cache["geometry"][rid], ivetol)
