"""Device-to-host reads a step: the program's ``ops.host_sync.count`` over
the run's untraced solves, over the sum of their steps max."""


def read(ctx):
    steps = sum(s.steps_max for s in ctx.solves)
    if not steps:
        return None
    return sum(s.host_syncs for s in ctx.solves) / steps
