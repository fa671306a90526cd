"""Share of the batched step work done for running lanes, in %: 100 x the
program's ``bdf.lane_steps`` over the traced solve, over B x its steps
max. Both sides count step attempts, rejected ones included: a lane's
``n_steps`` grows by one at every loop iteration it runs, accepted or
not, so the lanes' sum is the attempts made for running lanes, and the
slowest lane's ``n_steps`` is the loop's iterations, each of which runs
every lane's kernels. A lane retried with tighter tolerances counts its
final solve's attempts only, and the retry's iterations are not in the
denominator. 100 at B=1; a ragged batch reads below. A program without
the counter gives no reading."""
from benchmark import spans


def read(ctx):
    rec = spans.record(ctx)
    if (rec is None or ctx.traced is None or not ctx.traced.steps_max
            or not rec.counters.get("bdf.lane_steps")):
        return None
    return (100.0 * rec.counters["bdf.lane_steps"]
            / (ctx.shape.batch * ctx.traced.steps_max))
