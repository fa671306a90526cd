"""Temperature profiles solved a second: the profiles of the window's
whole solves over the host-clock time from just before the first solve to
``torch.cuda.synchronize()`` after the last (no solve starts once the
run's seconds have passed and the mix's groups of ramps are whole), the
host's gaps between solves included."""


def read(ctx):
    if not ctx.solves or ctx.window_s <= 0:
        return None
    return ctx.profiles / ctx.window_s
