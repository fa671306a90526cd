"""Wall milliseconds a BDF step: the untraced solves of the run (its
measured window), their whole wall time over the sum of their steps max (a
batch steps until its slowest lane is done). Host clock up to the
solve's return in host arrays."""


def read(ctx):
    steps = sum(s.steps_max for s in ctx.solves)
    if not steps:
        return None
    return sum(s.wall_s for s in ctx.solves) * 1e3 / steps
