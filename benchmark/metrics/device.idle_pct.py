"""The device's idle share of the traced solve: 100 (1 - busy / window),
busy the union of the device's kernel, copy and set intervals and window
the traced span, both from the one traced solve."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
