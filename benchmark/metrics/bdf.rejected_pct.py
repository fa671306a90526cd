"""Rejected step attempts, in % of the lanes' steps: 100 x the program's
``bdf.rejected`` (error-test rejections and Newton failures, summed over
the lanes) over its ``bdf.lane_steps`` (the lanes' steps), both over the
traced solve. A program without the counters gives no reading."""
from benchmark import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None:
        return None
    steps = rec.counters.get("bdf.lane_steps")
    if not steps or "bdf.rejected" not in rec.counters:
        return None
    return 100.0 * rec.counters["bdf.rejected"] / steps
