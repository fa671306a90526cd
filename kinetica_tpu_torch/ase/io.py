"""On-disk caching of TST pipeline artifacts.

Capability parity with Julia reference src/ase/io.jl: per-species optimised
geometries, per-reaction endpoint/TS/vibration artifacts keyed by the hex
reaction hash — so caches transfer *across different CRNs* (io.jl:249-357)
— plus whole-calculator checkpointing (io.jl:12-133) and subset-consistency
verification against the live network (verify_sd/verify_rd, io.jl:191-239).

Storage format is JSON (frames and small arrays) instead of BSON.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils.logging import logger


def _jsonable(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def _save_json(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(_jsonable(payload), fh)


def _load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def species_dir(calcdir: str, sid: int) -> str:
    return os.path.join(calcdir, f"spec_{sid:06d}")


def rhash_dir(calcdir: str, rhash: bytes) -> str:
    return os.path.join(calcdir, "nebs", rhash.hex())


def save_optgeom(calcdir: str, sid: int, frame, props: dict) -> None:
    """Per-species optimised geometry + cached properties (io.jl:249-268)."""
    _save_json(os.path.join(species_dir(calcdir, sid), "opt_final.json"),
               {"frame": frame, "props": props})


def load_optgeom(calcdir: str, sid: int):
    path = os.path.join(species_dir(calcdir, sid), "opt_final.json")
    if not os.path.isfile(path):
        return None
    data = _load_json(path)
    return data["frame"], data["props"]


def save_endpoints(calcdir: str, rhash: bytes, reacsys, prodsys) -> None:
    """Per-reaction aligned endpoint systems (io.jl:277-294)."""
    _save_json(os.path.join(rhash_dir(calcdir, rhash), "endpts.json"),
               {"reacsys": reacsys, "prodsys": prodsys})


def load_endpoints(calcdir: str, rhash: bytes):
    path = os.path.join(rhash_dir(calcdir, rhash), "endpts.json")
    if not os.path.isfile(path):
        return None
    data = _load_json(path)
    return data["reacsys"], data["prodsys"]


def save_tsdata(calcdir: str, rhash: bytes, ts_frame, conv: bool,
                extras: dict | None = None) -> None:
    """Per-reaction TS geometry + convergence marker (io.jl:306-327)."""
    _save_json(os.path.join(rhash_dir(calcdir, rhash), "ts.json"),
               {"ts": ts_frame, "conv": bool(conv), "extras": extras or {}})


def load_tsdata(calcdir: str, rhash: bytes):
    path = os.path.join(rhash_dir(calcdir, rhash), "ts.json")
    if not os.path.isfile(path):
        return None
    data = _load_json(path)
    return data["ts"], data["conv"], data.get("extras", {})


def save_vibdata(calcdir: str, rhash: bytes, vib_energies) -> None:
    """Per-reaction TS vibrational energies (io.jl:339-357)."""
    _save_json(os.path.join(rhash_dir(calcdir, rhash), "vib.json"),
               {"vib_energies": list(vib_energies)})


def load_vibdata(calcdir: str, rhash: bytes):
    path = os.path.join(rhash_dir(calcdir, rhash), "vib.json")
    if not os.path.isfile(path):
        return None
    return _load_json(path)["vib_energies"]


def save_calculator_checkpoint(calcdir: str, calc_state: dict) -> None:
    """Whole-calculator checkpoint (io.jl:12-133)."""
    _save_json(os.path.join(calcdir, "asecalc_chk.json"), calc_state)


def load_calculator_checkpoint(calcdir: str):
    path = os.path.join(calcdir, "asecalc_chk.json")
    if not os.path.isfile(path):
        return None
    return _load_json(path)


def verify_sd(cached_smiles: dict, sd) -> bool:
    """Cached species must be a consistent subset of the live network
    (io.jl:191-222)."""
    for sid_str, smi in cached_smiles.items():
        sid = int(sid_str)
        if sid not in sd.toStr or sd.toStr[sid] != smi:
            logger.warning("Cached species %s (%s) inconsistent with "
                           "network.", sid, smi)
            return False
    return True


def verify_rd(cached_rhashes: list[str], rd) -> bool:
    """Cached reactions must be a consistent prefix-subset of the network
    (io.jl:223-239)."""
    live = [h.hex() for h in rd.rhash]
    for i, h in enumerate(cached_rhashes):
        if i >= len(live) or live[i] != h:
            logger.warning("Cached reaction %d inconsistent with network.", i)
            return False
    return True
