"""The device's idle share of the traced window while the host is in the
program's set-up: idle time inside the program's solve record outside its
``bdf.step``, ``bdf.newton``, ``linalg.factor`` and ``host_sync.read``
spans: the entry's preparation and collection, each ``bdf_solve``'s
``bdf.init`` outside its factor, the chunk loop between solves; in %
(``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, spans.SETUP)
