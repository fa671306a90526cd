"""Newton factors built a lane and step: the sum of the program's per-lane
``n_lu`` over the sum of its per-lane ``n_steps``, over the run's untraced
solves (every lane, not the slowest)."""


def read(ctx):
    steps = sum(int(s.n_steps.sum()) for s in ctx.solves)
    if not steps:
        return None
    return sum(int(s.n_lu.sum()) for s in ctx.solves) / steps
