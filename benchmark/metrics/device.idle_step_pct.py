"""The device's idle share of the traced window while the host is in a BDF
step outside its Newton iterations and factor (``bdf.step`` and its
``bdf.predict``, ``bdf.jac_refresh``, ``bdf.control`` and
``bdf.chunk_transition``, reads excepted), in % (``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, "bdf.step")
