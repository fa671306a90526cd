"""Loader for the first-party native reaction sampler (csrc/host/cde_lite.cpp).

The reference orchestrates an *external* Fortran CDE binary for stochastic
graph-driven mechanism sampling (Julia reference src/exploration/cde.jl:
54-122). This framework ships its own native sampler with the same file
contract (input/Start.xyz -> rxn_*.xyz + input.log), so exploration runs
end-to-end with zero external chemistry binaries. Point
``CDE(cde_exec=...)`` at a real CDE build to use xTB-quality sampling
instead; everything downstream is identical.

The port keeps its own copy of the JAX package's ``csrc/cde_lite.cpp``
and builds it on demand with g++ into the git-ignored
``kinetica_tpu_torch/_build/`` (a hash of the source in the name), as
:mod:`kinetica_tpu_torch.chem.native` builds the chem-lite library.
"""
from __future__ import annotations

import os

from ..chem.native import EXEC_FLAGS, build_host


def build_cde_lite(force: bool = False) -> str | None:
    """Compile csrc/host/cde_lite.cpp if needed; return the executable
    path, or None without a working g++."""
    path = build_host("cde_lite.cpp", "cde_lite", EXEC_FLAGS, force=force)
    return None if path is None else str(path)


def get_cde_lite_exec() -> str:
    """Path to the native sampler, building it on first use."""
    path = build_cde_lite()
    if path is None:
        raise RuntimeError(
            "cde_lite could not be built (g++ unavailable); "
            "provide CDE(cde_exec=...) explicitly")
    return path


def write_minimal_template(template_dir: str, nrxn_per_mech: int = 2,
                           valence_range: dict[str, tuple[int, int]] | None = None,
                           movefile_lines: str | None = None) -> str:
    """Create a minimal CDE template directory for the native sampler.

    The exploration drivers copy ``template_dir`` per run and append
    nmcrxn/nrxn/ranseed (cde.jl:66-72); this helper writes the static part
    (valence ranges + optional movefile) so users need no hand-authored
    template to start exploring.
    """
    os.makedirs(template_dir, exist_ok=True)
    lines = ["# cde_lite template (generated)", f"nrxn {nrxn_per_mech}"]
    if movefile_lines is not None:
        with open(os.path.join(template_dir, "moves.in"), "w") as fh:
            fh.write(movefile_lines)
        lines.append("movefile moves.in")
    vr = valence_range or {"H": (0, 1), "C": (0, 4), "N": (0, 3), "O": (0, 2),
                           "S": (0, 2)}
    lines.append("valencerange{")
    for el, (lo, hi) in vr.items():
        lines.append(f"{el} {lo} {hi}")
    lines.append("}")
    with open(os.path.join(template_dir, "input"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return template_dir
