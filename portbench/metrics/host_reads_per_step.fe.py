"""Device-to-host scalar reads a load step over the window, both counted
by the program's recorder (``host_reads`` over ``load_steps``): a CG
residual norm an iteration, the tangent change a round, the active-lane
flag a Newton trip."""
from harness import program

program.start()


def read(ctx):
    w = program.window()
    return None if w is None else w.ratio('host_reads', 'load_steps')
