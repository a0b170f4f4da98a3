"""Milliseconds a Newton trip of the return map over the window: the
program's ``newton`` spans (each projection's trip loop, the card
synchronized at both ends) over its ``newton_trips`` counter."""
from harness import program

program.start()


def read(ctx):
    w = program.window()
    if w is None or not w.counters.get('newton_trips'):
        return None
    return 1e3 * w.seconds('newton') / w.counters['newton_trips']
