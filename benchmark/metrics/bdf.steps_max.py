"""BDF steps of the slowest lane of a solve (the program's ``n_steps``
counter), the mean over the run's untraced solves."""


def read(ctx):
    if not ctx.solves:
        return None
    return sum(s.steps_max for s in ctx.solves) / len(ctx.solves)
