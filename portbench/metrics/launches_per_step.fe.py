"""Device operations (kernels, copies, sets) a load step in the profiled
request: the trace's count over the steps the load-step probe saw."""


def read(ctx):
    steps = ctx.counters.get('profiled_steps', 0)
    if ctx.trace is None or not steps:
        return None
    return ctx.trace.n_ops / steps
