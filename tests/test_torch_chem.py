"""The port's chemistry layer against the JAX package's.

The chem-lite code is copied into the port; these tests hold the copy to
the original on the same inputs (identical output): SMILES parsing and
canonical output, seeded 3D embedding, atom-mapped SMILES, XYZ system
ingestion, ``SpeciesData.from_xyz_file``/``push_xyz_file`` and the atom
maps ``RxData.push`` builds from geometry frames. The port builds its
native library (``csrc/host/chemlite.cpp``) under
``kinetica_tpu_torch/_build/`` and never writes the JAX package's
tracked ``csrc/build/`` binaries.
"""
import hashlib
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMILES = ["CC", "C=C", "C#C", "[CH3]", "[H][H]", "[H]", "CCO", "C1CC1",
          "c1ccccc1", "CC(C)C", "O=C=O", "[CH2]C", "C=CC=C", "[O][O]"]


def _both(name):
    import importlib
    return (importlib.import_module(f"kinetica_tpu.chem").__dict__[name],
            importlib.import_module(f"kinetica_tpu_torch.chem").__dict__[name])


@pytest.mark.parametrize("smi", SMILES)
def test_smiles_parse_and_canonical(smi):
    f0, f1 = _both("from_smiles")
    m0, m1 = f0(smi), f1(smi)
    assert m1.species == m0.species
    assert m1.bonds == m0.bonds and m1.charges == m0.charges
    c0, c1 = _both("canonical_smiles")
    assert c1(smi) == c0(smi)
    t0, t1 = _both("to_smiles")
    assert t1(m1) == t0(m0)


@pytest.mark.parametrize("seed", [None, 7, 123456789])
def test_frame_from_smiles_seeded(seed):
    f0, f1 = _both("frame_from_smiles")
    for smi in SMILES:
        kw = {} if seed is None else {"seed": seed}
        assert f1(smi, **kw) == f0(smi, **kw), smi


@pytest.mark.parametrize("smi", ["C=C", "CC", "CCO", "[CH2]C", "C#C"])
def test_atom_map_smiles(smi):
    e0, e1 = _both("frame_from_smiles")
    a0, a1 = _both("atom_map_smiles")
    frame = e0(smi, seed=5)
    assert e1(smi, seed=5) == frame
    assert a1(frame, smi) == a0(frame, smi)
    m0, m1 = _both("atom_map_frame")
    assert m1(a1(frame, smi), frame) == m0(a0(frame, smi), frame)


def _system_xyz(tmp_path, smis, seed=3):
    """A multi-molecule XYZ file: the molecules of ``smis`` set apart."""
    from kinetica_tpu_torch.exploration.molecule_system import system_from_smiles
    path = str(tmp_path / "system.xyz")
    system_from_smiles(smis, saveto=path)
    return path


def test_ingest_xyz_system_and_species_data(tmp_path):
    import kinetica_tpu.core.network as N0
    import kinetica_tpu_torch.core.network as N1
    path = _system_xyz(tmp_path, ["CC", "[CH3]", "C=C", "[H][H]", "CC"])
    i0, i1 = _both("ingest_xyz_system")
    smis0, frames0 = i0(path)
    smis1, frames1 = i1(path)
    assert smis1 == smis0 and frames1 == frames0
    assert sorted(set(smis1)) == sorted({"CC", "[CH3]", "C=C", "[H][H]"})
    for unique in (True, False):
        sd0 = N0.SpeciesData.from_xyz_file(path, level=2, unique_species=unique)
        sd1 = N1.SpeciesData.from_xyz_file(path, level=2, unique_species=unique)
        assert sd1.toInt == sd0.toInt and sd1.xyz == sd0.xyz
        assert sd1.level_found == sd0.level_found
    sd0, sd1 = N0.SpeciesData(["CC"]), N1.SpeciesData(["CC"])
    sd0.push_xyz_file(path, level=3)
    sd1.push_xyz_file(path, level=3)
    assert sd1.toInt == sd0.toInt and sd1.xyz == sd0.xyz
    assert sd1.level_found == sd0.level_found


def test_rxdata_push_atom_maps():
    """Reactions pushed with geometry frames carry the same atom-mapped
    reaction SMILES in both packages (the port's map was off before the
    chemistry layer was ported)."""
    import kinetica_tpu.core.network as N0
    import kinetica_tpu_torch.core.network as N1
    from kinetica_tpu_torch.exploration.molecule_system import system_from_mols
    from kinetica_tpu_torch.chem import frame_from_smiles
    reacs = [["CC"], ["C=C", "[H][H]"], ["[CH3]", "[CH3]"]]
    prods = [["[CH3]", "[CH3]"], ["CC"], ["CC"]]
    sys_of = lambda smis: system_from_mols(
        [frame_from_smiles(s, seed=9) for s in smis])
    rsys = [sys_of(r) for r in reacs]
    psys = [sys_of(p) for p in prods]
    out = []
    for N in (N0, N1):
        sd = N.SpeciesData(["CC", "[CH3]", "C=C", "[H][H]"])
        rd = N.RxData()
        rd.push(sd, reacs, prods, rsys, psys, dH=[1.0, -1.0, -3.0])
        out.append(rd)
    assert out[1].mapped_rxns == out[0].mapped_rxns
    assert all(">>" in m and ":" in m for m in out[1].mapped_rxns)
    assert out[1].rhash == out[0].rhash


def _tracked_build_digests():
    d = os.path.join(ROOT, "csrc", "build")
    return {n: hashlib.sha256(open(os.path.join(d, n), "rb").read()).hexdigest()
            for n in sorted(os.listdir(d))}


def test_native_builds_only_under_the_port_build_dir():
    from kinetica_tpu_torch.chem import native
    from kinetica_tpu_torch.exploration.cde_lite import build_cde_lite
    before = _tracked_build_digests()
    lib = native.build_host("chemlite.cpp", "libchemlite", native.SHARED_FLAGS,
                            ".so", force=True)
    exe = build_cde_lite(force=True)
    if lib is None or exe is None:
        pytest.skip("g++ unavailable: the chem layer runs its Python fallback")
    build = os.path.join(ROOT, "kinetica_tpu_torch", "_build")
    for path in (str(lib), exe):
        assert os.path.dirname(path) == build, path
        assert os.path.basename(path).split("-")[0] in ("libchemlite",
                                                        "cde_lite")
    assert os.access(exe, os.X_OK)
    assert native.get_lib() is not None
    assert os.path.dirname(str(native.lib_path)) == build
    assert _tracked_build_digests() == before
    # the native bond perception finds CCO's 8 bonds
    from kinetica_tpu_torch.chem import frame_from_smiles, frame_positions
    from kinetica_tpu_torch.chem.elements import covalent_radius
    frame = frame_from_smiles("CCO", seed=2)
    pos = frame_positions(frame)
    radii = np.array([covalent_radius(s) for s in frame["arrays"]["species"]])
    pairs = native.perceive_bonds_native(pos, radii, 0.45)
    assert len(pairs) == 8
