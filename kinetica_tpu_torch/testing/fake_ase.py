"""A minimal in-repo ASE stand-in for end-to-end pipeline testing.

The reference validates its NEB/TST pipeline end-to-end with ASE's cheap
EMT calculator, asserting only that the pipeline *runs* ("EMT is too
terrible to allow for numerical rate constant comparisons",
test/Python/ase.jl:79-102). This module provides the same capability
without requiring ASE at all: :func:`install` registers fake ``ase``
modules (Atoms, optimizers, NEB, Vibrations, io, an EMT-like toy Morse
calculator) into ``sys.modules``, exposing exactly the surface
``kinetica_tpu_torch.ase`` touches, so the full ``ASENEBCalculator`` data
pipeline — conformers/symmetry, geometry optimisation, endpoint systems,
(CI-)NEB, TS extraction, finite-difference vibrations, per-rhash disk
caching, TST rates — exercises in CI on any machine.

The toy potential is a bond-aware Morse: the bond graph is perceived
ONCE from the first geometry a calculator instance evaluates (the same
covalent-radius rule as chem-lite perception), bonded pairs feel the
full Morse well at the covalent radius sum, and non-bonded pairs feel
only the repulsive Morse branch. An all-pairs Morse (the previous form)
has a compact-cluster global minimum — every pair at covalent distance —
which line-search optimisers can reach from VSEPR-embedded starts,
collapsing the molecule; the repulsive-only non-bonded branch removes
that minimum so optimisations preserve the molecular graph, while
stretched bonds still cost energy (finite NEB "barriers"). Like EMT,
the numbers are not chemistry — only the plumbing is under test.
"""
from __future__ import annotations

import re
import sys
import types

import numpy as np

from ..chem.elements import atomic_mass, covalent_radius

_SYMBOL_RE = re.compile(r"[A-Z][a-z]?")

MORSE_D = 3.5      # eV well depth
MORSE_A = 4.0      # 1/Å (short-ranged so nonbonded pairs barely interact)


def _parse_symbols(symbols) -> list[str]:
    if isinstance(symbols, str):
        return _SYMBOL_RE.findall(symbols)
    return [str(s) for s in symbols]


class ToyMorseCalculator:
    """Geometry-only bond-aware Morse potential (the fake "EMT").

    Bonds are perceived from the FIRST geometry evaluated (chem-lite's
    covalent rule: d < r_i + r_j + 0.4 Å) and frozen for the instance's
    lifetime, matching how the pipeline builds a fresh calculator per
    optimisation/vibration task. Bonded pairs: full Morse. Non-bonded:
    repulsive branch only (D x², x = exp(-a (r - r0))) — smooth, decays
    to zero, and removes the all-pairs compact-cluster minimum."""

    def __init__(self, *args, **kwargs):
        self._bonded = None  # (n, n) bool mask, perceived lazily

    def _params(self, symbols):
        r = np.array([covalent_radius(s) for s in symbols])
        r0 = r[:, None] + r[None, :]
        return r0

    def energy_forces(self, symbols, pos):
        n = len(symbols)
        e = 0.0
        f = np.zeros((n, 3))
        if n < 2:
            return e, f
        r0 = self._params(symbols)
        d = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(d, axis=-1)
        if self._bonded is None or self._bonded.shape[0] != n:
            self._bonded = dist < (r0 + 0.4)
        iu = np.triu_indices(n, k=1)
        rij = dist[iu]
        bonded = self._bonded[iu]
        x = np.exp(-MORSE_A * (rij - r0[iu]))
        # bonded: D (x^2 - 2x); non-bonded: D x^2 (repulsive only)
        e = float(np.sum(MORSE_D * (x * x - 2.0 * x * bonded)))
        # dE/dr: bonded 2 D a x (1 - x); non-bonded -2 D a x^2
        dEdr = 2.0 * MORSE_D * MORSE_A * x * (bonded - x)
        unit = d[iu] / np.maximum(rij, 1e-12)[:, None]
        for (i, j, g, u) in zip(iu[0], iu[1], dEdr, unit):
            f[i] -= g * u
            f[j] += g * u
        return e, f


class Atoms:
    """The subset of ase.Atoms the kinetica_tpu_torch pipeline uses."""

    def __init__(self, symbols="", positions=None):
        self.symbols = _parse_symbols(symbols)
        self.positions = np.asarray(positions, dtype=float).reshape(
            len(self.symbols), 3)
        self.calc = None
        self._charges = np.zeros(len(self.symbols))
        self._magmoms = np.zeros(len(self.symbols))

    def __len__(self):
        return len(self.symbols)

    # geometry
    def get_positions(self):
        return self.positions.copy()

    def set_positions(self, pos):
        self.positions = np.asarray(pos, dtype=float).reshape(
            len(self.symbols), 3)

    def get_chemical_symbols(self):
        return list(self.symbols)

    def get_masses(self):
        return np.array([atomic_mass(s) for s in self.symbols])

    def get_moments_of_inertia(self):
        from ..ase.properties import moments_of_inertia
        from ..chem import make_frame
        return moments_of_inertia(make_frame(self.symbols, self.positions))

    # bookkeeping
    def set_initial_charges(self, v):
        self._charges = np.asarray(v, dtype=float)

    def get_initial_charges(self):
        return self._charges.copy()

    def set_initial_magnetic_moments(self, v):
        self._magmoms = np.asarray(v, dtype=float)

    def get_initial_magnetic_moments(self):
        return self._magmoms.copy()

    # energetics
    def get_potential_energy(self):
        e, _ = self.calc.energy_forces(self.symbols, self.positions)
        return e

    def get_forces(self):
        _, f = self.calc.energy_forces(self.symbols, self.positions)
        return f

    def copy(self):
        a = Atoms(self.symbols, self.positions)
        a._charges = self._charges.copy()
        a._magmoms = self._magmoms.copy()
        return a


class _Descent:
    """Force-quenching descent standing in for every ASE optimiser.

    The stopping rule and step control are force-based (like FIRE), not
    energy-based: NEB's projected/spring force field is non-conservative
    and the climbing image deliberately ASCENDS the energy, so energy
    backtracking would never converge a band.
    """

    def __init__(self, obj, *args, **kwargs):
        self.obj = obj
        self._residual = 0.0

    def get_residual(self):
        return self._residual

    def run(self, fmax=0.05, steps=1000):
        obj = self.obj
        alpha = 0.02
        f_prev = None
        for _ in range(int(steps)):
            f = np.asarray(obj.get_forces())
            self._residual = float(np.abs(f).max())
            if self._residual < fmax:
                return True
            if f_prev is not None:
                # velocity-free FIRE-style control: if the new force is
                # roughly aligned with the last step, accelerate; if it
                # flipped (overshoot), back off
                if float(np.vdot(f, f_prev)) > 0.0:
                    alpha = min(alpha * 1.1, 0.15)
                else:
                    alpha = max(alpha * 0.4, 1e-4)
            obj.set_positions(obj.get_positions() + alpha * f)
            f_prev = f
        f = np.asarray(obj.get_forces())
        self._residual = float(np.abs(f).max())
        return bool(self._residual < fmax)


class NEB:
    """Nudged elastic band over fake Atoms (interior images optimised)."""

    def __init__(self, images, k=0.1, parallel=False,
                 allow_shared_calculator=True, **kwargs):
        self.images = list(images)
        self.k = k
        self.climb = False

    def interpolate(self, method="linear", **kwargs):
        # linear interpolation endpoints -> interior (idpp treated the same)
        n = len(self.images)
        p0 = self.images[0].get_positions()
        p1 = self.images[-1].get_positions()
        for i in range(1, n - 1):
            t = i / (n - 1)
            self.images[i].set_positions((1 - t) * p0 + t * p1)

    # optimiser interface over the interior images
    def get_positions(self):
        return np.concatenate(
            [im.get_positions() for im in self.images[1:-1]], axis=0)

    def set_positions(self, pos):
        na = len(self.images[0])
        pos = np.asarray(pos).reshape(len(self.images) - 2, na, 3)
        for im, p in zip(self.images[1:-1], pos):
            im.set_positions(p)

    def get_potential_energy(self):
        return float(sum(im.get_potential_energy()
                         for im in self.images[1:-1]))

    def get_forces(self):
        ims = self.images
        energies = [im.get_potential_energy() for im in ims]
        i_max = int(np.argmax(energies))
        out = []
        for i in range(1, len(ims) - 1):
            f_true = np.asarray(ims[i].get_forces())
            d_prev = ims[i].get_positions() - ims[i - 1].get_positions()
            d_next = ims[i + 1].get_positions() - ims[i].get_positions()
            tau = d_prev + d_next
            norm = np.linalg.norm(tau)
            tau = tau / norm if norm > 1e-12 else tau
            f_par = float(np.vdot(f_true, tau))
            if self.climb and i == i_max:
                # climbing image: invert the parallel component, no springs
                out.append(f_true - 2.0 * f_par * tau)
                continue
            f_perp = f_true - f_par * tau
            spring = self.k * (np.linalg.norm(d_next)
                               - np.linalg.norm(d_prev))
            out.append(f_perp + spring * tau)
        return np.concatenate(out, axis=0)


class Vibrations:
    """Central finite-difference Hessian -> harmonic mode energies (eV)."""

    # hbar * sqrt(eV / (amu * Å^2)) in eV
    _HBAR_SQRT = 0.06465415

    def __init__(self, atoms, delta=0.01, name="vib", **kwargs):
        self.atoms = atoms
        self.delta = float(delta)
        self._energies = None

    def run(self):
        a = self.atoms
        n = len(a)
        pos0 = a.get_positions()
        H = np.zeros((3 * n, 3 * n))
        d = self.delta
        for i in range(3 * n):
            for sign, store in ((+1, 0), (-1, 1)):
                p = pos0.copy().reshape(-1)
                p[i] += sign * d
                a.set_positions(p.reshape(n, 3))
                f = np.asarray(a.get_forces()).reshape(-1)
                if store == 0:
                    f_plus = f
                else:
                    H[i] = -(f_plus - f) / (2 * d)
        a.set_positions(pos0)
        H = 0.5 * (H + H.T)
        m = np.repeat(a.get_masses(), 3)
        Hw = H / np.sqrt(m[:, None] * m[None, :])
        lam = np.linalg.eigvalsh(Hw)          # ascending, eV/(amu Å^2)
        e = np.empty(3 * n, dtype=complex)
        pos = lam >= 0
        e[pos] = self._HBAR_SQRT * np.sqrt(lam[pos])
        e[~pos] = 1j * self._HBAR_SQRT * np.sqrt(-lam[~pos])
        self._energies = e

    def get_energies(self):
        return self._energies

    def clean(self):
        pass


def _io_write(path, images, **kwargs):
    try:
        from ..ase.conversion import atoms_to_frame
        from ..chem import write_xyz_file
        if not isinstance(images, (list, tuple)):
            images = [images]
        write_xyz_file(str(path) + ".xyz",
                       [atoms_to_frame(im) for im in images])
    except Exception:
        pass


def install() -> None:
    """Register the fake ``ase`` module tree and flip HAS_ASE on.

    Idempotent; raises if a real ase import is present (never shadow a
    real installation).
    """
    if "ase" in sys.modules and not getattr(sys.modules["ase"],
                                            "__kinetica_fake__", False):
        raise RuntimeError("A real 'ase' module is already imported; "
                           "refusing to install the fake backend over it")

    ase = types.ModuleType("ase")
    ase.__kinetica_fake__ = True
    ase.Atoms = Atoms

    opt = types.ModuleType("ase.optimize")
    for name in ("BFGS", "LBFGS", "FIRE", "MDMin", "QuasiNewton"):
        setattr(opt, name, _Descent)

    mep = types.ModuleType("ase.mep")
    mep.NEB = NEB
    mep_neb = types.ModuleType("ase.mep.neb")
    mep_neb.NEB = NEB
    mep_neb.NEBOptimizer = _Descent
    mep.neb = mep_neb

    vib = types.ModuleType("ase.vibrations")
    vib.Vibrations = Vibrations

    io_mod = types.ModuleType("ase.io")
    io_mod.write = _io_write

    calcs = types.ModuleType("ase.calculators")
    emt = types.ModuleType("ase.calculators.emt")
    emt.EMT = ToyMorseCalculator
    calcs.emt = emt

    ase.optimize = opt
    ase.mep = mep
    ase.vibrations = vib
    ase.io = io_mod
    ase.calculators = calcs

    for name, mod in (("ase", ase), ("ase.optimize", opt), ("ase.mep", mep),
                      ("ase.mep.neb", mep_neb), ("ase.vibrations", vib),
                      ("ase.io", io_mod), ("ase.calculators", calcs),
                      ("ase.calculators.emt", emt)):
        mod.__kinetica_fake__ = True
        sys.modules[name] = mod

    _set_has_ase(True)


def _set_has_ase(value: bool) -> None:
    """Flip both public flags: backends.HAS_ASE and its chem re-export."""
    from .. import chem
    from ..chem import backends
    backends.HAS_ASE = value
    if hasattr(chem, "HAS_ASE"):
        chem.HAS_ASE = value


def uninstall() -> None:
    """Remove the fake modules and restore backend detection."""
    # every installed module is tagged; decide before mutating sys.modules
    fake = [name for name, mod in list(sys.modules.items())
            if (name == "ase" or name.startswith("ase."))
            and getattr(mod, "__kinetica_fake__", False)]
    for name in fake:
        del sys.modules[name]
    import importlib.util
    try:
        _set_has_ase(importlib.util.find_spec("ase") is not None)
    except (ImportError, ModuleNotFoundError, ValueError):
        _set_has_ase(False)


class ToyMorseBuilder:
    """Calculator-builder functor matching the EMTBuilder signature."""

    def __call__(self, calcdir, mult, chg, **kwargs):
        return ToyMorseCalculator()
