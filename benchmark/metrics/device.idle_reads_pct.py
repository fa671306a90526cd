"""The device's idle share of the traced window while the host is in a
device-to-host read (``host_sync.read``, the read and its wait, any site),
in % (``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, "host_sync.read")
