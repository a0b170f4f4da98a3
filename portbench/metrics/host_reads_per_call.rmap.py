"""Device-to-host scalar reads a return-map call over the window, both
counted by the program's recorder (``host_reads`` over
``return_map_calls``): the active-lane flag a Newton trip."""
from harness import program

program.start()


def read(ctx):
    w = program.window()
    return None if w is None else w.ratio('host_reads', 'return_map_calls')
