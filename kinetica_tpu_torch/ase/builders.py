"""ASE calculator builders.

Capability parity with Julia reference src/ase/builders.jl: functor objects
returning configured ASE calculators with signature
``builder(dir, mult, chg, **kwargs)`` (the authoring contract of
docs/src/development/ase-calculator-builders.md:9-13):

* :class:`EMTBuilder` — test-quality EMT (builders.jl:1-27),
* :class:`NWChemDFTBuilder` — NWChem DFT (builders.jl:30-87),
* :class:`FHIAimsBuilder` — FHI-aims DFT (builders.jl:90-179).

All builders are constructible without ASE installed (class lookups happen
lazily at call time) so configuration objects can be created, serialised
and validated anywhere; only actually *calling* them requires ASE.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..chem import backends


@dataclass
class EMTBuilder:
    """Effective-medium-theory calculator — "mostly just here for very
    quick tests" (builders.jl:10-13)."""
    fixed_cutoff: bool = True

    def __call__(self, calcdir: str, mult: int, chg: int, **kwargs):
        backends.require("ase", backends.HAS_ASE, "the EMT calculator")
        from ase.calculators.emt import EMT
        return EMT(fixed_cutoff=self.fixed_cutoff)


@dataclass
class NWChemDFTBuilder:
    """NWChem DFT calculator builder (builders.jl:30-87)."""
    command: str = "nwchem PREFIX.nwi > PREFIX.nwo"
    xc: str = "becke97"
    basis: object = "3-21G"
    maxiter: int = 50
    convergence: str = ""
    adft: bool = True
    memory: str = "1024 mb"

    def __call__(self, calcdir: str, mult: int, chg: int, **kwargs):
        backends.require("ase", backends.HAS_ASE, "the NWChem calculator")
        from ase.calculators.nwchem import NWChem
        dft = {"xc": self.xc, "mult": mult, "maxiter": self.maxiter}
        if self.adft:
            dft["adft"] = None
        if self.convergence:
            dft["convergence"] = self.convergence
        calc = NWChem(memory=self.memory, dft=dft, basis=self.basis)
        calc.command = self.command
        return calc


@dataclass
class FHIAimsBuilder:
    """FHI-aims DFT calculator builder (builders.jl:90-179)."""
    command: str = "aims.x"
    xc: str = "pbe"
    species_dir: str = "./species_defaults/defaults_2020/tight"
    maxiter: int = 1000
    sc_init_iter: int = 1001
    dispersion: str = ""
    sc_accuracy_rho: float | None = None
    sc_accuracy_forces: float | None = None
    sc_accuracy_etot: float | None = None
    sc_accuracy_eev: float | None = None

    def __post_init__(self):
        if not os.path.isdir(self.species_dir):
            raise ValueError(f"No species_dir found at {self.species_dir}")

    def __call__(self, calcdir: str, mult: int, chg: int, **kwargs):
        backends.require("ase", backends.HAS_ASE, "the FHI-aims calculator")
        from ase.calculators.aims import Aims
        args: dict = {
            "aims_command": self.command,
            "outfilename": os.path.join(calcdir, "aims.out"),
            "xc": self.xc,
            "species_dir": self.species_dir,
            "sc_init_iter": str(self.sc_init_iter),
            "sc_iter_limit": str(self.maxiter),
        }
        if self.dispersion:
            if " " not in self.dispersion:
                args[self.dispersion] = ""
            else:
                disptype, dispargs = self.dispersion.split(" ", 1)
                args[disptype] = dispargs
        if self.sc_accuracy_forces is not None:
            args["sc_accuracy_forces"] = str(self.sc_accuracy_forces)
        else:
            args["compute_forces"] = ".true."
        for name in ("sc_accuracy_rho", "sc_accuracy_etot", "sc_accuracy_eev"):
            val = getattr(self, name)
            if val is not None:
                args[name] = str(val)
        args["spin"] = "collinear" if mult > 1 else "none"
        if mult > 1:
            args["fixed_spin_moment"] = str(mult - 1)
        args["charge"] = str(chg)
        return Aims(**args)
