"""Milliseconds a CG iteration over the window: the program's ``cg``
spans (MG-CG, the card synchronized at both ends) over its ``cg_iters``
counter."""
from harness import program

program.start()


def read(ctx):
    w = program.window()
    if w is None or not w.counters.get('cg_iters'):
        return None
    return 1e3 * w.seconds('cg') / w.counters['cg_iters']
