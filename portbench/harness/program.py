"""The program's own recorder (``pylabfea_tpu_torch.utils.profiling``)
as the per-layer readers of its spans and counters see it.

A reader calls ``start()`` when it is loaded.  The runner loads the
readers of a traced run after the warm-up and before the window, so the
recorder covers the window and the profiled requests after it, and stays
off in every untraced run.  The readers read the window alone: the spans
and counts made outside the profiler.  A program without the recorder
gives them nothing to read: ``start()`` does nothing and ``window()`` is
None."""
import importlib


def _recorder():
    mod = importlib.import_module('pylabfea_tpu_torch.utils.profiling')
    return mod if hasattr(mod, 'start') else None


def start():
    """Reset and switch on the program's recorder, where it has one."""
    rec = _recorder()
    if rec is not None:
        rec.start()


class Window:
    """The window's counters and per-span totals."""

    def __init__(self, rec):
        self.counters = rec.counters()
        self.spans = rec.summary()

    def ratio(self, num, den, scale=1.):
        """``scale`` times counter ``num`` over counter ``den``, or None
        without the denominator."""
        d = self.counters.get(den, 0)
        return scale * self.counters.get(num, 0) / d if d else None

    def seconds(self, name):
        """Total seconds of the outermost spans ``name``, or None."""
        s = self.spans.get(name)
        return s['total_s'] if s else None


def window():
    """The window's records, or None where the program has no recorder
    or it recorded no load step and no return-map call."""
    rec = _recorder()
    if rec is None:
        return None
    w = Window(rec)
    if not (w.counters.get('load_steps') or w.counters.get(
            'return_map_calls')):
        return None
    return w
