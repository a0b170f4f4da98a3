"""Percent of the profiled window in which no operation ran on the card:
one less the union of the device operations' intervals over the
window."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100. * (1. - ctx.trace.busy_s / ctx.trace.window_s)
