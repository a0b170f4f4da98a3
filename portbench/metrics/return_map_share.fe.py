"""Percent of the window in the return map and tangent update, timed by
the benchmark's probes with the card synchronised around each call."""


def read(ctx):
    return ctx.span_share('return_map')
