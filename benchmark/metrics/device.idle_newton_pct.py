"""The device's idle share of the traced window while the host is in the
Newton iterations (``bdf.newton`` and its ``bdf.newton_iter`` spans: the
RHS and the Newton solve of every lane; reads excepted), in %
(``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, "bdf.newton")
