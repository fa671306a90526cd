"""The device's idle share of the traced window while the host is in the
Newton factor (``linalg.factor`` and its ``linalg.refine``: equilibration,
inverse, Newton-Schulz; reads excepted), in % (``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, "linalg.factor")
