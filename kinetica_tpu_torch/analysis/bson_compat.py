"""Reading the reference's BSON files (parameters and saved outputs).

Counterpart of ``kinetica_tpu/analysis/bson_compat.py``, copied. The
Julia reference persists everything as BSON.jl dictionary trees (its
io.jl:70-169, and parameter files such as
``examples/getting_started/arrhenius_params.bson``). This is a minimal
BSON decoder (the subset BSON.jl emits) plus helpers to lift
Julia-flavoured structures (typed arrays stored as binary blobs with
``tag``/``type``/``data`` entries) into numpy.
"""
from __future__ import annotations

import struct

import numpy as np

_JULIA_DTYPES = {
    "Float64": np.float64, "Float32": np.float32,
    "Int64": np.int64, "Int32": np.int32, "UInt8": np.uint8,
    "Bool": np.bool_,
}


def parse_bson(data: bytes) -> dict:
    """Decode one BSON document (subset: the types BSON.jl emits)."""
    doc, _ = _parse_doc(data, 0)
    return doc


def load_bson(path: str) -> dict:
    """Load and lift a BSON.jl file into plain Python/numpy structures."""
    with open(path, "rb") as fh:
        raw = parse_bson(fh.read())
    return lift_julia(raw)


def _parse_doc(buf: bytes, pos: int):
    total, = struct.unpack_from("<i", buf, pos)
    end = pos + total
    pos += 4
    out: dict = {}
    while pos < end - 1:
        etype = buf[pos]
        pos += 1
        nul = buf.index(0, pos)
        name = buf[pos:nul].decode()
        pos = nul + 1
        if etype == 0x01:    # double
            val, = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif etype == 0x02:  # string
            slen, = struct.unpack_from("<i", buf, pos)
            pos += 4
            val = buf[pos: pos + slen - 1].decode()
            pos += slen
        elif etype in (0x03, 0x04):  # document / array
            val, pos = _parse_doc(buf, pos)
        elif etype == 0x05:  # binary
            blen, = struct.unpack_from("<i", buf, pos)
            pos += 4
            subtype = buf[pos]
            pos += 1
            val = ("__binary__", subtype, buf[pos: pos + blen])
            pos += blen
        elif etype == 0x08:  # bool
            val = bool(buf[pos])
            pos += 1
        elif etype == 0x0A:  # null
            val = None
        elif etype == 0x10:  # int32
            val, = struct.unpack_from("<i", buf, pos)
            pos += 4
        elif etype == 0x12:  # int64
            val, = struct.unpack_from("<q", buf, pos)
            pos += 8
        else:
            raise ValueError(f"Unsupported BSON element type {etype:#x} "
                             f"at offset {pos}")
        out[name] = val
    return out, end


def _is_bson_array(d) -> bool:
    return (isinstance(d, dict) and d
            and all(k.isdigit() for k in d)
            and sorted(int(k) for k in d) == list(range(len(d))))


def lift_julia(obj):
    """Lift BSON.jl structures: typed binary arrays -> numpy, index-keyed
    docs -> lists, recursively."""
    if isinstance(obj, dict):
        tag = obj.get("tag")
        if tag == "array" and "data" in obj and "type" in obj:
            type_doc = lift_julia(obj["type"])
            name = type_doc.get("name")
            dtype_name = name[-1] if isinstance(name, list) else None
            data = obj["data"]
            if isinstance(data, tuple) and data[0] == "__binary__":
                dtype = _JULIA_DTYPES.get(dtype_name, np.uint8)
                arr = np.frombuffer(data[2], dtype=dtype)
                size = lift_julia(obj.get("size"))
                if isinstance(size, list) and len(size) > 1:
                    arr = arr.reshape([int(s) for s in size], order="F")
                return arr.copy()
            return lift_julia(data)
        if tag == "datatype":
            return {k: lift_julia(v) for k, v in obj.items() if k != "tag"}
        if _is_bson_array(obj):
            return [lift_julia(obj[str(i)]) for i in range(len(obj))]
        return {k: lift_julia(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and obj and obj[0] == "__binary__":
        return np.frombuffer(obj[2], dtype=np.uint8).copy()
    return obj


def load_arrhenius_params(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a reference Arrhenius parameter file -> (Ea, A).

    The getting_started tutorial ships one
    (the reference's examples/getting_started/arrhenius_params.bson,
    getting-started.md:140-152).
    """
    doc = load_bson(path)
    Ea = np.asarray(doc["Ea"], dtype=np.float64)
    A = np.asarray(doc["A"], dtype=np.float64)
    return Ea, A
