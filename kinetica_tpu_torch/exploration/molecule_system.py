"""Molecule system packer: place molecules in space with minimum separation.

Same capability as Julia reference src/exploration/molecule_system.jl: a
damped spring-particle system (one particle per molecule COM) is integrated
to rest (molecule_system.jl:20-38, 164-225), molecules are translated to
the relaxed particle positions, then checked for xTB coordinate bounds
(positions must stay within (-100, 1000) Å, molecule_system.jl:113-124) and
pairwise minimum separation; the spring rest length adapts between
attempts. Public API: :func:`system_from_smiles` / :func:`system_from_mols`
(molecule_system.jl:264-312).

The spring relaxation is a tiny damped dynamics; it is integrated here
with plain numpy velocity-Verlet on the host (the system has one particle
per *molecule* — device dispatch would be all overhead).
"""
from __future__ import annotations

import numpy as np

from ..chem import frame_positions, frame_species, make_frame, write_xyz_file
from ..chem.conversion import frame_from_smiles
from ..chem.elements import atomic_mass
from ..utils.logging import logger


def get_mass(frame) -> float:
    return float(sum(atomic_mass(s) for s in frame_species(frame)))


def get_com(frame) -> np.ndarray:
    masses = np.array([atomic_mass(s) for s in frame_species(frame)])
    pos = frame_positions(frame)
    return (masses[:, None] * pos).sum(axis=0) / masses.sum()


def center_mols(mols: list) -> list:
    """Centre each molecule's geometric centre on the origin."""
    out = []
    for mol in mols:
        pos = frame_positions(mol)
        out.append(make_frame(frame_species(mol), pos - pos.mean(axis=0),
                              mol.get("info", {})))
    return out


def transform_mol(mol, vec: np.ndarray):
    return make_frame(frame_species(mol), frame_positions(mol) + vec,
                      mol.get("info", {}))


def position_check(tmols: list) -> bool:
    """True if any coordinate is outside xTB's readable range
    (molecule_system.jl:113-124)."""
    for mol in tmols:
        pos = frame_positions(mol)
        if np.any(pos >= 1000.0) or np.any(pos <= -100.0):
            return True
    return False


def proximity_check(tmols: list, dmin: float) -> bool:
    """True if any inter-molecule atom pair is closer than ``dmin``."""
    for i in range(len(tmols)):
        pi = frame_positions(tmols[i])
        for j in range(i + 1, len(tmols)):
            pj = frame_positions(tmols[j])
            d = np.linalg.norm(pi[:, None] - pj[None, :], axis=-1)
            if np.any(d < dmin):
                return True
    return False


def _relax_springs(masses: np.ndarray, rest: float, seed_pos: np.ndarray,
                   ks: float = 2.0, kd: float = 0.75,
                   dt: float = 0.05, max_steps: int = 20000) -> np.ndarray:
    """Damped spring dynamics to rest (velocity-Verlet, stops at low KE)."""
    np_count = len(masses)
    x = seed_pos.copy()
    v = np.zeros_like(x)

    def accel(x, v):
        a = np.zeros_like(x)
        for i in range(np_count):
            for j in range(i + 1, np_count):
                d = x[i] - x[j]
                n = np.linalg.norm(d) + 1e-12
                don = d / n
                f = -(ks * (n - rest) + kd * float((v[i] - v[j]) @ don)) * don
                a[i] += f / masses[i]
                a[j] -= f / masses[j]
        return a

    a = accel(x, v)
    for _ in range(max_steps):
        x = x + v * dt + 0.5 * a * dt * dt
        a_new = accel(x, v + 0.5 * (a) * dt)
        v = v + 0.5 * (a + a_new) * dt
        a = a_new
        if np.linalg.norm(v) < 1e-5 and np.max(np.abs(a)) < 1e-5:
            break
    return x


def molsys_opt(mols: list, dmin: float, maxiters: int = 200,
               seed: int = 12345) -> list:
    """Translate molecules so all inter-molecule atoms are >= dmin apart
    (molecule_system.jl:164-225), adapting the spring rest length."""
    rng = np.random.default_rng(seed)
    n = len(mols)
    masses = np.array([get_mass(m) for m in mols])
    rest = 40.0
    r_adj = 0.0
    for counter in range(maxiters):
        x0 = rng.random((n, 3))
        px = _relax_springs(masses, rest + r_adj, x0)
        tmols = [transform_mol(m, px[i]) for i, m in enumerate(mols)]
        oob = position_check(tmols)
        close = proximity_check(tmols, dmin)
        if not oob and not close:
            logger.debug("molsys_opt converged after %d iterations", counter + 1)
            return tmols
        if oob and close:
            r_adj -= 5.0
        elif oob:
            r_adj -= 10.0
        else:
            r_adj += 10.0
    raise RuntimeError("Max iterations exceeded in molsys_opt().")


def combine_mols(tmols: list) -> dict:
    species = []
    pos_list = []
    for mol in tmols:
        species += frame_species(mol)
        pos_list.append(frame_positions(mol))
    return make_frame(species, np.vstack(pos_list))


def system_from_mols(mols: list, saveto: str | None = None, dmin: float = 5.0,
                     maxiters: int = 200) -> dict:
    """Pack molecule frames into one system frame (molecule_system.jl:264-290)."""
    if len(mols) == 1:
        system = center_mols(mols)[0]
    else:
        centered = center_mols(mols)
        tmols = molsys_opt(centered, dmin, maxiters)
        system = combine_mols(tmols)
    if saveto:
        write_xyz_file(saveto, system)
    return system


def system_from_smiles(smiles: list[str], saveto: str | None = None,
                       dmin: float = 5.0, maxiters: int = 200,
                       seed: int = 10) -> dict:
    """Pack molecules given by SMILES (molecule_system.jl:292-312)."""
    mols = [frame_from_smiles(smi, seed=seed) for smi in smiles]
    return system_from_mols(mols, saveto=saveto, dmin=dmin, maxiters=maxiters)
