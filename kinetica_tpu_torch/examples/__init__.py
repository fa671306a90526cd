"""The user programs of ``examples/``, ported to the card.

Each runs as ``python -m kinetica_tpu_torch.examples.<name>`` and takes
``--device`` (default the card, ``cuda``; without one it raises, as every
entry point does); its ``main(..., device=...)`` takes the example's sizes
as keywords whose defaults are the JAX example's own:

* ``getting_started``: a ``DirectExplore`` from CC over the mock CDE, a
  500 -> 1200 K ramp, the plots (where matplotlib imports) and
  ``save_output``;
* ``pyrolysis_sweep``: 32 ramps of ``synthetic_pyrolysis_network(16)``
  through ``EnsembleProblem``, solved twice (the second timed);
* ``analysis_pipeline``: Morris, Sobol, DRGEP and the fluxes of
  ``synthetic_pyrolysis_network(6)`` at 1100 K;
* ``iterative_exploration``: ``IterativeExplore`` over ``cde_lite``,
  each level gated by three ramps;
* ``full_product``: explore, sweep, screen and reduce in one run;
* ``mock_cde``: the mock CDE executable the first one samples with.

Times an example prints stand beside the device's name (and, on the card,
its power limit, as ``nvidia-smi`` reads it).
"""
from __future__ import annotations

import argparse
import subprocess

import torch


def device_label(device) -> str:
    """The device's name; on the card ``nvidia-smi``'s ``name, power.limit``
    (``torch.cuda.get_device_name`` where ``nvidia-smi`` does not run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        lines = out.stdout.strip().splitlines()
        index = device.index or 0
        if out.returncode == 0 and len(lines) > index:
            return lines[index].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return torch.cuda.get_device_name(device)


def parser(doc: str) -> argparse.ArgumentParser:
    """The command line every example shares: ``--device``."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="the device to solve on (default: cuda, the card)")
    return p
