"""Percent of the window in the linear solve: the hierarchy build and the
MG-CG solve, timed by the benchmark's probes with the card synchronised
around each call."""


def read(ctx):
    return ctx.span_share('linear_solve')
