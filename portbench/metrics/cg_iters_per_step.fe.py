"""CG iterations a load step over the window: the sum of each step's
``diag['cg_iters_hist']`` over the steps."""


def read(ctx):
    steps = ctx.counters.get('steps', 0)
    return ctx.counters['cg_iters'] / steps if steps else None
