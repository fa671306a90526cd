"""XYZ / extended-XYZ parsing and frame containers.

Frames follow the reference's ExtXYZ dict layout
(Julia reference src/openbabel/conversion.jl:52-86): ``{"N_atoms": int,
"info": {...}, "arrays": {"species": [sym...], "pos": (N, 3) list}}``.
Supports multi-frame trajectory files (CDE writes 2-frame reaction files
with energies in the comment line, cde.jl:258-316) and extxyz comment-line
key=value metadata.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np

Frame = dict[str, Any]


def make_frame(species: list[str], pos, info: dict | None = None) -> Frame:
    pos = np.asarray(pos, dtype=np.float64).reshape(len(species), 3)
    return {"N_atoms": len(species),
            "info": dict(info or {}),
            "arrays": {"species": list(species), "pos": pos.tolist()}}


def frame_species(frame: Frame) -> list[str]:
    return list(frame["arrays"]["species"])


def frame_positions(frame: Frame) -> np.ndarray:
    return np.asarray(frame["arrays"]["pos"], dtype=np.float64)


_KV_RE = re.compile(r'(\w+)=(?:"([^"]*)"|(\S+))')


def _parse_comment(comment: str) -> dict:
    info: dict[str, Any] = {}
    matched_any = False
    for m in _KV_RE.finditer(comment):
        matched_any = True
        key = m.group(1)
        raw = m.group(2) if m.group(2) is not None else m.group(3)
        try:
            val: Any = int(raw)
        except ValueError:
            try:
                val = float(raw)
            except ValueError:
                val = raw
        info[key] = val
    if not matched_any and comment.strip():
        # bare-number comment lines (CDE writes the frame energy there)
        try:
            info["energy"] = float(comment.strip())
        except ValueError:
            info["comment"] = comment.strip()
    return info


def xyz_to_frames(xyz_str: str) -> list[Frame]:
    """Parse a (possibly multi-frame) XYZ string into frames."""
    lines = xyz_str.splitlines()
    frames = []
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].strip())
        comment = lines[i + 1] if i + 1 < len(lines) else ""
        species, pos = [], []
        for j in range(n):
            parts = lines[i + 2 + j].split()
            species.append(parts[0])
            pos.append([float(parts[1]), float(parts[2]), float(parts[3])])
        frame = make_frame(species, pos, _parse_comment(comment))
        frames.append(frame)
        i += 2 + n
    return frames


def xyz_to_frame(xyz_str: str) -> Frame:
    """Single-frame parse (reference conversion.jl:52-66)."""
    return xyz_to_frames(xyz_str)[0]


def frame_to_xyz(frame: Frame, comment: str | None = None) -> str:
    """Frame -> XYZ string (reference conversion.jl:77-86)."""
    species = frame_species(frame)
    pos = frame_positions(frame)
    if comment is None:
        info = frame.get("info", {})
        if "energy" in info:
            comment = f"energy={info['energy']}"
        else:
            comment = ""
    body = "\n".join(
        f"{s} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}"
        for s, p in zip(species, pos))
    return f"{len(species)}\n{comment}\n{body}\n"


def read_xyz_file(path: str) -> list[Frame]:
    with open(path) as fh:
        return xyz_to_frames(fh.read())


def write_xyz_file(path: str, frames: Frame | list[Frame]) -> None:
    if isinstance(frames, dict):
        frames = [frames]
    with open(path, "w") as fh:
        for frame in frames:
            fh.write(frame_to_xyz(frame))


def xyz_file_to_str(path: str) -> str:
    """File -> XYZ string (reference conversion.jl:149-154)."""
    with open(path) as fh:
        return fh.read()
