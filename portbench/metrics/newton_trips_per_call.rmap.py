"""Newton trips a return-map call over the window: kernel A's launch
counter (``svc_kernels.svc_f_grad.launches``) a call, less the one trial
evaluation a call makes."""


def read(ctx):
    calls = ctx.counters.get('calls', 0)
    launches = ctx.counters.get('a_launches', 0)
    return launches / calls - 1. if calls and launches else None
