"""Tracing and step timing (the counterpart of
``pylabfea_tpu.utils.profiling``).

``trace`` records the enclosed block with ``torch.profiler`` (host and,
on a card, CUDA activity) into a Chrome trace file (chrome://tracing,
Perfetto); ``StepTimer`` collects the seconds of each load step, the card
synchronized at both ends, and counters noted by the caller.
"""
import contextlib
import os
import time

import torch

from pylabfea_tpu_torch.config import resolve_device


@contextlib.contextmanager
def trace(logdir, device=None):
    """Record a ``torch.profiler`` trace of the enclosed block into
    ``logdir/trace.json``: CPU activity, and CUDA activity where
    ``device`` (the card when None) is a card.  Yields the profiler."""
    device = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


class StepTimer:
    """Seconds and counters of the steps of an incremental solver, the
    card (``device``, the card when None) synchronized before and after
    each step so that a step's time is the card's::

        timer = StepTimer()
        for step in range(n):
            with timer.step():
                state, diag = load_step_split(...)
            timer.note(cg_iters=diag['cg_iters'])
        print(timer.summary())
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.times = []
        self.notes = []

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def step(self):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.times.append(time.perf_counter() - t0)

    def note(self, **counters):
        self.notes.append(counters)

    def summary(self):
        """{'steps', 'total_s', 'mean_s', 'max_s'} and, for every counter
        of the first note, '<name>_mean' and '<name>_max' over the notes
        that hold it (the JAX ``StepTimer``'s keys)."""
        n = len(self.times)
        if n == 0:
            return {'steps': 0}
        total = sum(self.times)
        out = {'steps': n, 'total_s': total, 'mean_s': total / n,
               'max_s': max(self.times)}
        if self.notes:
            for k in self.notes[0]:
                vals = [d[k] for d in self.notes if k in d]
                out[f'{k}_mean'] = sum(vals) / len(vals)
                out[f'{k}_max'] = max(vals)
        return out
