"""Graphviz export of CRNs.

Counterpart of ``kinetica_tpu/analysis/graph.py`` (the reference's
``Catalyst.Graph(sd, rd)``, graph.jl:36-117), copied: a species/reaction
bipartite digraph with per-node exploration-level attributes, custom
graph/species/reaction/edge attribute dicts, optional SMILES labels,
optional pruning of inactive species, stoichiometry edge labels, and a
``savegraph`` that writes DOT text (renderable with any graphviz).
"""
from __future__ import annotations

from ..core.network import RxData, SpeciesData

_DEFAULT_GRAPH_ATTRS = {"layout": "dot", "overlap": "false", "splines": "true"}
_DEFAULT_SPECIES_ATTRS = {"shape": "circle", "color": "#6C9AC3"}
_DEFAULT_RXN_ATTRS = {"shape": "point", "color": "#E28F41", "width": ".1"}
_DEFAULT_EDGE_ATTRS = {"splines": "splines"}

_SUBSCRIPTS = "₀₁₂₃₄₅₆₇₈₉"


def _subscript(i: int) -> str:
    return "".join(_SUBSCRIPTS[int(d)] for d in str(i))


def _attr_str(attrs: dict) -> str:
    return ", ".join(f'{k}="{v}"' for k, v in attrs.items())


class Graph:
    """CRN bipartite graph; ``str(g)`` / ``g.to_dot()`` is the DOT source."""

    def __init__(self, sd: SpeciesData, rd: RxData,
                 graph_attrs: dict | None = None,
                 species_attrs: dict | None = None,
                 rxn_attrs: dict | None = None,
                 edge_attrs: dict | None = None,
                 use_smiles: bool = False,
                 remove_inactive_species: bool = True):
        self.sd, self.rd = sd, rd
        self.graph_attrs = dict(_DEFAULT_GRAPH_ATTRS, **(graph_attrs or {}))
        self.species_attrs = species_attrs or dict(_DEFAULT_SPECIES_ATTRS)
        self.rxn_attrs = rxn_attrs or dict(_DEFAULT_RXN_ATTRS)
        self.edge_attrs = edge_attrs or dict(_DEFAULT_EDGE_ATTRS)
        self.use_smiles = use_smiles
        self.remove_inactive_species = remove_inactive_species

    def _species_name(self, sid: int) -> str:
        if self.use_smiles:
            return self.sd.toStr[sid]
        return "S" + _subscript(sid + 1)

    def active_species(self) -> list[int]:
        if not self.remove_inactive_species:
            return list(range(self.sd.n))
        active = set()
        for rid in range(self.rd.nr):
            active.update(self.rd.id_reacs[rid])
            active.update(self.rd.id_prods[rid])
        return sorted(active)

    def to_dot(self) -> str:
        lines = ["digraph G {"]
        lines.append(f"  graph [{_attr_str(self.graph_attrs)}];")
        if self.edge_attrs:
            lines.append(f"  edge [{_attr_str(self.edge_attrs)}];")
        for sid in self.active_species():
            attrs = dict(self.species_attrs)
            attrs["level"] = str(self.sd.level_found.get(sid, 1))
            lines.append(f'  "{self._species_name(sid)}" [{_attr_str(attrs)}];')
        for rid in range(self.rd.nr):
            rname = "R" + _subscript(rid + 1)
            attrs = dict(self.rxn_attrs)
            attrs["level"] = str(self.rd.level_found[rid])
            lines.append(f'  "{rname}" [{_attr_str(attrs)}];')
            for sid, st in zip(self.rd.id_reacs[rid], self.rd.stoic_reacs[rid]):
                lines.append(
                    f'  "{self._species_name(sid)}" -> "{rname}" '
                    f'[label="{st}", labelfontsize="6"];')
            for sid, st in zip(self.rd.id_prods[rid], self.rd.stoic_prods[rid]):
                lines.append(
                    f'  "{rname}" -> "{self._species_name(sid)}" '
                    f'[label="{st}", labelfontsize="6"];')
        lines.append("}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.to_dot()


def savegraph(graph: Graph, path: str, fmt: str = "dot") -> str:
    """Write the graph to disk; DOT text always, rendered image when a
    graphviz binary is available (reference reexports Catalyst.savegraph)."""
    dot = graph.to_dot()
    if fmt == "dot":
        with open(path, "w") as fh:
            fh.write(dot)
        return path
    import shutil
    import subprocess
    exe = shutil.which("dot")
    if exe is None:
        raise RuntimeError("graphviz 'dot' binary not available; "
                           "use fmt='dot' to write DOT source")
    proc = subprocess.run([exe, f"-T{fmt}", "-o", path], input=dot.encode(),
                          check=True)
    return path
