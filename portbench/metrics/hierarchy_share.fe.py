"""Percent of the load steps' time in building the multigrid hierarchy
over the window: the program's ``hierarchy`` spans (2-D ``_hier_kes`` and
``levels_from_kes``, 3-D ``build_hierarchy3``) over its ``load_step``
spans, the card synchronized at the ends of each."""
from harness import program

program.start()


def read(ctx):
    w = program.window()
    if w is None or not w.seconds('load_step'):
        return None
    return 100. * (w.seconds('hierarchy') or 0.) / w.seconds('load_step')
