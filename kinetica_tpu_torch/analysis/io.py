"""Results container of a solve, and its save/load round trip.

Counterpart of ``kinetica_tpu/analysis/io.py`` (the reference's
io.jl:3-261): ``ODESolveOutput`` binds the solved network, the solution
traces, the precalculated rate table, the condition traces, the
parameters and the conditions; ``save_output`` / ``load_output``
deconstruct everything into one ``.npz`` file (numeric arrays stored
natively, structure and strings in an embedded JSON document) and
rebuild it, with version stamping, profile reconstruction by type name
and a reaction-hash check on load.

The format is the JAX package's, key for key, so a file saved by either
package loads in the other; the version stamp is the port's own
``__version__``. Everything here is host numpy.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, fields as dataclass_fields

import numpy as np

from .. import __version__
from ..conditions import profiles as profile_mod
from ..conditions.condition_set import ConditionSet
from ..core.network import RxData, SpeciesData
from ..solving.params import ODESimulationParams
from ..solving.solutions import ODESolution
from ..utils.interpolation import TimeSeries
from ..utils.logging import logger


@dataclass
class ODESolveOutput:
    """Bound results of a kinetic CRN solve (io.jl:3-48)."""
    sd: SpeciesData
    rd: RxData
    sol: ODESolution
    sol_k: TimeSeries | None
    sol_vcs: dict
    pars: ODESimulationParams
    conditions: ConditionSet

    def __init__(self, solvemethod, sol: ODESolution, sd: SpeciesData,
                 rd: RxData):
        self.sd = sd
        self.rd = rd
        self.sol = sol
        self.sol_k = sol.k
        self.sol_vcs = {sym: TimeSeries(sol.t, trace)
                        for sym, trace in sol.vcs.items()}
        self.pars = solvemethod.pars
        self.conditions = solvemethod.conditions


# every solver knob round-trips: derived from the dataclass so new fields
# persist automatically (load tolerates files written before a field
# existed — missing keys fall back to the constructor default)
_PARS_FIELDS = [f.name for f in dataclass_fields(ODESimulationParams)]

# Profile parameter fields needed to reconstruct each type (constructor args).
_PROFILE_CTOR_FIELDS = {
    "StaticConditionProfile": ["value"],
    "NullDirectProfile": ["X_start", "t_end"],
    "LinearDirectProfile": ["rate", "X_start", "X_end"],
    "NullGradientProfile": ["X_start", "t_end"],
    "LinearGradientProfile": ["rate", "X_start", "X_end"],
    "DoubleRampGradientProfile": ["X_start", "t_start_plateau", "rate1",
                                  "X_mid", "t_mid_plateau", "rate2", "X_end",
                                  "t_end_plateau", "t_blend"],
}


def _frame_to_jsonable(frame):
    if frame is None:
        return None
    out = {}
    for key, val in frame.items():
        if key == "arrays":
            out[key] = {k: (np.asarray(v).tolist() if not isinstance(v, list) else v)
                        for k, v in val.items()}
        elif isinstance(val, np.ndarray):
            out[key] = val.tolist()
        elif isinstance(val, dict):
            out[key] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                        for k, v in val.items()}
        else:
            out[key] = val
    return out


def save_output(out: ODESolveOutput, saveto: str) -> None:
    """Deconstruct an ODESolveOutput into a portable .npz file
    (io.jl:70-169)."""
    meta: dict = {"KineticaTpuVersion": __version__}

    meta["sd"] = {
        "toInt": out.sd.toInt,
        "n": out.sd.n,
        "xyz": {str(i): _frame_to_jsonable(x) for i, x in out.sd.xyz.items()},
        "level_found": {str(i): v for i, v in out.sd.level_found.items()},
    }
    meta["rd"] = {
        "nr": out.rd.nr,
        "mapped_rxns": out.rd.mapped_rxns,
        "id_reacs": out.rd.id_reacs,
        "id_prods": out.rd.id_prods,
        "stoic_reacs": out.rd.stoic_reacs,
        "stoic_prods": out.rd.stoic_prods,
        "dH": out.rd.dH,
        "rhash": [h.hex() for h in out.rd.rhash],
        "level_found": out.rd.level_found,
    }
    meta["pars"] = {}
    for f in _PARS_FIELDS:
        v = getattr(out.pars, f)
        if isinstance(v, tuple):
            v = list(v)
        meta["pars"][f] = v

    profs = []
    arrays: dict[str, np.ndarray] = {}
    for i, (sym, prof) in enumerate(zip(out.conditions.symbols,
                                        out.conditions.profiles)):
        ptype = type(prof).__name__
        pdict = {"pType": ptype, "symbol": sym}
        for f in _PROFILE_CTOR_FIELDS.get(ptype, []):
            val = getattr(prof, f, None)
            if ptype == "DoubleRampGradientProfile" and f == "t_blend":
                val = prof.t_blend if prof.blended else None
            pdict[f] = val
        if getattr(prof, "sol", None) is not None:
            arrays[f"profile_{i}_t"] = prof.sol.t
            arrays[f"profile_{i}_u"] = prof.sol.u
            pdict["has_sol"] = True
        profs.append(pdict)
    meta["conditions"] = {
        "profiles": profs,
        "discrete_updates": out.conditions.discrete_updates,
        "ts_update": out.conditions.ts_update,
    }

    arrays["sol_t"] = out.sol.t
    arrays["sol_u"] = out.sol.u
    meta["sol"] = {"retcode": out.sol.retcode, "vcs_syms": list(out.sol.vcs)}
    for sym, trace in out.sol.vcs.items():
        arrays[f"vc_{sym}"] = np.asarray(trace)
    if out.sol_k is not None:
        arrays["k_t"] = out.sol_k.t
        arrays["k_u"] = out.sol_k.u
        meta["sol"]["has_k"] = True

    np.savez_compressed(saveto, _meta=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    logger.info("Saved output to %s", saveto)


def load_output(path: str) -> ODESolveOutput:
    """Reconstruct an ODESolveOutput from a saved .npz (io.jl:171-261)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["_meta"]).decode())

    sd = SpeciesData()
    for smi, sid in sorted(meta["sd"]["toInt"].items(), key=lambda kv: kv[1]):
        frame = meta["sd"]["xyz"].get(str(sid))
        level = meta["sd"]["level_found"].get(str(sid), 1)
        sd.push(smi, frame, level)
    assert sd.n == meta["sd"]["n"]

    rd = RxData(
        nr=meta["rd"]["nr"],
        mapped_rxns=list(meta["rd"]["mapped_rxns"]),
        id_reacs=[list(x) for x in meta["rd"]["id_reacs"]],
        id_prods=[list(x) for x in meta["rd"]["id_prods"]],
        stoic_reacs=[list(x) for x in meta["rd"]["stoic_reacs"]],
        stoic_prods=[list(x) for x in meta["rd"]["stoic_prods"]],
        dH=list(meta["rd"]["dH"]),
        rhash=[bytes.fromhex(h) for h in meta["rd"]["rhash"]],
        level_found=list(meta["rd"]["level_found"]),
    )
    # hash consistency check (io.jl:211-213)
    for rid in range(rd.nr):
        if rd.get_rhash(sd, rid) != rd.rhash[rid]:
            logger.warning("Reaction hash mismatch on load for reaction %d — "
                           "hashing scheme may have changed.", rid)
            break

    p = dict(meta["pars"])
    p["tspan"] = tuple(p["tspan"])
    pars = ODESimulationParams(**p)

    prof_dict = {}
    for i, pd in enumerate(meta["conditions"]["profiles"]):
        cls = getattr(profile_mod, pd["pType"])
        kwargs = {f: pd[f] for f in _PROFILE_CTOR_FIELDS[pd["pType"]] if f in pd}
        if pd["pType"] == "StaticConditionProfile":
            prof = cls(kwargs["value"])
        else:
            prof = cls(**kwargs)
        if pd.get("has_sol"):
            prof.sol = TimeSeries(data[f"profile_{i}_t"], data[f"profile_{i}_u"])
        prof_dict[pd["symbol"]] = prof
    conditions = ConditionSet(prof_dict,
                              ts_update=meta["conditions"]["ts_update"])

    vcs = {sym: data[f"vc_{sym}"] for sym in meta["sol"]["vcs_syms"]}
    k_series = (TimeSeries(data["k_t"], data["k_u"])
                if meta["sol"].get("has_k") else None)
    sol = ODESolution(t=data["sol_t"], u=data["sol_u"],
                      retcode=meta["sol"]["retcode"], vcs=vcs, k=k_series)

    class _Method:
        pass

    method = _Method()
    method.pars = pars
    method.conditions = conditions
    return ODESolveOutput(method, sol, sd, rd)
