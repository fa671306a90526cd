"""Plot recipes for kinetic simulation results.

Counterpart of ``kinetica_tpu/analysis/plotting.py`` (matplotlib ports of
the reference's Plots.jl recipes, plotting.jl:1-171, plus the
sensitivity, Morris, Sobol and flux views). Every function takes host
results and returns the matplotlib Axes. Matplotlib is imported inside
the functions, never with the module: plotting runs on the host where
matplotlib is installed, and nothing on the card's path imports it.
"""
from __future__ import annotations

import numpy as np

CONDITION_LABELS = {
    "T": "Temperature / K",
    "P": "Pressure / Pa",
    "V": "Volume / dm$^3$",
}


def _require_mpl():
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        return plt
    except ImportError as exc:  # pragma: no cover
        raise ImportError("matplotlib is required for plotting") from exc


def _is_radical(smiles: str) -> bool:
    # heuristic used by the reference's highlight_radicals (plotting.jl:139):
    # species whose SMILES carries an explicit radical atom.
    return ("[" in smiles and "H]" not in smiles.replace("[H][H]", "")) or \
        smiles.endswith("r")


def plot_solution(res, label_above: float = 0.1, ignore_species=None,
                  ignore_below: float | None = None, ax=None, t_unit="s"):
    """Concentration-vs-time traces (reference plot recipe, plotting.jl:1-42).

    Species whose maximum concentration exceeds ``label_above`` get legend
    entries; ``ignore_species`` are dropped; traces never exceeding
    ``ignore_below`` are dropped.
    """
    plt = _require_mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))
    ignore_species = set(ignore_species or [])
    t = res.sol.t
    for sid in range(res.sd.n):
        smi = res.sd.toStr[sid]
        if smi in ignore_species:
            continue
        trace = res.sol.u[:, sid]
        peak = float(np.max(trace))
        if ignore_below is not None and peak < ignore_below:
            continue
        label = smi if peak >= label_above else None
        ax.plot(t, trace, label=label, lw=1.2)
    ax.set_xlabel(f"Time / {t_unit}")
    ax.set_ylabel("Concentration / mol dm$^{-3}$")
    if ax.get_legend_handles_labels()[0]:
        ax.legend(loc="best", fontsize=8)
    return ax


def conditionsplot(res, sym: str, ax=None, t_unit="s"):
    """Plot one variable condition trace (plotting.jl:45-69)."""
    plt = _require_mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    if sym in res.sol.vcs:
        trace = res.sol.vcs[sym]
        t = res.sol.t
    else:
        prof = res.conditions.get_profile(sym)
        if prof.sol is None:
            raise ValueError(f"Condition {sym} has no solved profile to plot.")
        t, trace = prof.sol.t, prof.sol.u
    ax.plot(t, trace, color="tab:red", lw=1.5)
    ax.set_xlabel(f"Time / {t_unit}")
    ax.set_ylabel(CONDITION_LABELS.get(sym, f"{sym}"))
    return ax


def finalconcplot(res, n_top: int = 10, mode: str = "conc",
                  highlight_radicals: bool = True, logx: bool = False,
                  ax=None):
    """Top-N final concentrations bar chart (plotting.jl:80-171).

    ``mode`` is "conc" (mol dm^-3) or "percent" (% of total); radicals are
    highlighted in a second colour when ``highlight_radicals``.
    """
    plt = _require_mpl()
    if mode not in ("conc", "percent"):
        raise ValueError("mode must be 'conc' or 'percent'")
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 5))
    final = res.sol.u[-1].astype(np.float64).copy()
    if mode == "percent":
        final = 100.0 * final / max(final.sum(), 1e-300)
    order = np.argsort(final)[::-1][:n_top][::-1]
    labels = [res.sd.toStr[int(i)] for i in order]
    values = final[order]
    colors = ["tab:orange" if (highlight_radicals and _is_radical(l))
              else "tab:blue" for l in labels]
    ax.barh(np.arange(len(order)), np.maximum(values, 0.0), color=colors)
    ax.set_yticks(np.arange(len(order)))
    ax.set_yticklabels(labels, fontsize=8)
    ax.set_xlabel("Concentration / mol dm$^{-3}$" if mode == "conc"
                  else "Final mixture fraction / %")
    if logx:
        ax.set_xscale("log")
    return ax


def sensitivityplot(sens, sd, species: str, top_n: int = 8, ax=None,
                    t_unit: str = "s"):
    """Plot the ``top_n`` most influential reactions' log-sensitivity
    traces for one species' trajectory.

    ``sens`` is a :class:`kinetica_tpu_torch.solving.sensitivity.SensitivitySolution`;
    reaction labels come from its own network snapshot (``sens.rd``), the
    one the solve actually ran on. No reference equivalent (the reference
    has no sensitivity analysis).
    """
    plt = _require_mpl()
    from ..core.network import format_rxn
    from ..solving.sensitivity import rank_reactions

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))
    sid = sd.toInt[species]
    for rid, score in rank_reactions(sens, sd, species=species, top_n=top_n):
        label = (format_rxn(sd, sens.rd, rid) if sens.rd is not None
                 else f"reaction {rid}")
        col = int(np.flatnonzero(sens.rids == rid)[0])
        ax.plot(sens.t, sens.S[:, sid, col], label=label[:48])
    ax.set_xlabel(f"Time / {t_unit}")
    ax.set_ylabel(rf"$\partial\,[{species}]\,/\,\partial\,\ln k_j$")
    ax.axhline(0.0, color="k", lw=0.5)
    ax.legend(fontsize=7)
    return ax


def morrisplot(res, sd, rd, top_n: int = 12, ax=None):
    """Morris mu*-sigma scatter: importance vs nonlinearity/interaction.

    ``res`` is a :class:`kinetica_tpu_torch.analysis.screening.MorrisResult`.
    The classic reading (Morris 1991): points far right matter; points
    far above the ``sigma = mu*`` diagonal act nonlinearly or through
    interactions. No reference equivalent.
    """
    plt = _require_mpl()
    from ..core.network import format_rxn

    if ax is None:
        _, ax = plt.subplots(figsize=(7, 5))
    order = np.argsort(res.mu_star)[::-1][:top_n]
    ax.scatter(res.mu_star[order], res.sigma[order], s=26, zorder=3)
    for j in order:
        rid = int(res.rids[j])
        ax.annotate(format_rxn(sd, rd, rid)[:36],
                    (res.mu_star[j], res.sigma[j]), fontsize=6,
                    xytext=(3, 3), textcoords="offset points")
    lim = max(float(res.mu_star[order].max()), 1e-300)
    ax.plot([0, lim], [0, lim], color="k", lw=0.5, ls="--")
    ax.set_xlabel(r"$\mu^{*}$ (mean |elementary effect| per decade of k)")
    ax.set_ylabel(r"$\sigma$ (std of elementary effects)")
    ax.set_title(res.objective_name or "Morris screening")
    return ax


def sobolplot(res, sd, rd, top_n: int = 12, ax=None):
    """Grouped-bar view of Sobol indices: total (ST) vs first-order (S1).

    ``res`` is a :class:`kinetica_tpu_torch.analysis.sobol.SobolResult`.
    Reactions sorted by decreasing total index; the ST-S1 gap reads as
    interaction strength. Estimator noise can push S1 slightly negative
    — bars are drawn from 0 and clipped notes are left to the summary.
    No reference equivalent.
    """
    plt = _require_mpl()
    from ..core.network import format_rxn

    if ax is None:
        _, ax = plt.subplots(figsize=(7, 0.45 * min(top_n, len(res.rids)) + 1.4))
    order = np.argsort(res.ST)[::-1][:top_n]
    y = np.arange(order.size)
    h = 0.38
    ax.barh(y - h / 2, np.maximum(res.ST[order], 0.0), height=h,
            color="tab:blue", label="total $S_T$")
    ax.barh(y + h / 2, np.maximum(res.S1[order], 0.0), height=h,
            color="tab:orange", label="first-order $S_1$")
    ax.set_yticks(y)
    ax.set_yticklabels([format_rxn(sd, rd, int(res.rids[j]))[:40]
                        for j in order], fontsize=7)
    ax.invert_yaxis()
    ax.set_xlabel("Sobol index (fraction of objective variance)")
    ax.set_title(res.objective_name or "Sobol sensitivity")
    ax.legend(frameon=False, fontsize=8)
    return ax


def fluxplot(out, flux=None, top_n: int = 8, ax=None, t_unit: str = "s",
             calc=None, **flux_kwargs):
    """Plot the ``top_n`` largest-extent reactions' flux traces r_j(t).

    ``flux`` is a :class:`kinetica_tpu_torch.analysis.flux.FluxResult`
    (computed from ``out`` via :func:`reaction_fluxes` if omitted —
    pass ``calc`` for continuous/static solves, and any further
    ``reaction_fluxes`` kwargs such as ``attribution="projected"``
    through ``flux_kwargs``). No reference equivalent (the reference
    plots concentrations/conditions only).
    """
    plt = _require_mpl()
    from ..core.network import format_rxn
    from .flux import reaction_fluxes

    if flux is None:
        flux = reaction_fluxes(out, calc=calc, **flux_kwargs)
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))
    for rid, _extent in flux.top(top_n):
        label = format_rxn(out.sd, out.rd, rid)
        ax.plot(flux.t, flux.rates[:, rid], label=label[:48])
    ax.set_xlabel(f"Time / {t_unit}")
    ax.set_ylabel("Reaction flux / mol dm$^{-3}$ s$^{-1}$")
    ax.set_yscale("symlog", linthresh=1e-12)
    ax.legend(fontsize=7)
    return ax
