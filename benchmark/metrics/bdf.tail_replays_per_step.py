"""Steps whose tail ran from a CUDA graph, a step: the program's
``bdf.tail_replays`` over the traced solve (each a step whose error test,
step and order control, merge and chunk transition were one graph
replay), over its steps max. 1.0 where every step replays; a program
without the counter gives no reading."""
from benchmark import spans


def read(ctx):
    return spans.per_step(ctx, "bdf.tail_replays")
