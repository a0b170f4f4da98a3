"""Probes around the program's functions, put on from outside in a traced
run only and taken off after it.  A function that a configuration or a
reader names and the program no longer has is an error, not a silent
gap in what the probes read.

A configuration names its layers' functions (``spans``: layer ->
``module:function`` list).  In ``spans`` mode each outermost call of a
layer synchronises the card before and after and records (layer, start,
end) on the host clock; the load step's probe also counts steps and the
CG iterations of ``diag['cg_iters_hist']``.  In ``profile`` mode the
same calls open ``torch.profiler.record_function('portbench.<layer>')``
without synchronising, and the launch functions of the metrics' kernels
record the work of each launch on the card.
"""
import functools
import importlib
import time
from collections import Counter, defaultdict

import torch


def resolve(target):
    """(module, attribute name, function) of ``module:function``; raises
    where the program no longer has it, so that a yardstick never reads
    on with part of what it names."""
    mod, name = target.split(':')
    mod = importlib.import_module(mod)
    if not callable(getattr(mod, name, None)):
        raise AttributeError(f'{target}: the program has no such function')
    return mod, name, getattr(mod, name)


class Patches:
    """Wrappers put on the program's module functions and taken off in
    the reverse order."""

    def __init__(self):
        self._patches = []

    def patch(self, target, make):
        mod, name, orig = resolve(target)
        wrapper = functools.wraps(orig)(make(orig))
        setattr(mod, name, wrapper)
        self._patches.append((mod, name, orig))

    def restore(self):
        for mod, name, orig in reversed(self._patches):
            wrapper = getattr(mod, name)
            orig.__dict__.update({k: v for k, v in wrapper.__dict__.items()
                                  if not k.startswith('__')})
            setattr(mod, name, orig)
        self._patches = []


class Probe(Patches):
    def __init__(self, sync):
        super().__init__()
        self.sync = sync
        self.mode = None
        self.spans = []
        self.depth = Counter()
        self.counters = Counter()
        self.work = defaultdict(list)

    def span(self, layer, target):
        """Put the probe of ``layer`` around ``target``."""
        def make(orig):
            def wrapper(*args, **kwargs):
                if self.mode == 'profile':
                    with torch.profiler.record_function(f'portbench.{layer}'):
                        out = orig(*args, **kwargs)
                    if layer == 'load_step':
                        self.counters['profiled_steps'] += 1
                    return out
                if self.mode != 'spans' or self.depth[layer]:
                    return orig(*args, **kwargs)
                self.depth[layer] += 1
                try:
                    self.sync()
                    t0 = time.perf_counter()
                    out = orig(*args, **kwargs)
                    self.sync()
                    self.spans.append((layer, t0, time.perf_counter()))
                finally:
                    self.depth[layer] -= 1
                if layer == 'load_step':
                    self.counters['steps'] += 1
                    self.counters['cg_iters'] += sum(
                        int(i) for i in out[1]['cg_iters_hist'])
                return out
            return wrapper
        self.patch(target, make)

    def kernel(self, spec):
        """Record the work of each launch of ``spec``'s kernel on the card
        in ``profile`` mode."""
        def make(orig):
            def wrapper(*args, **kwargs):
                if self.mode == 'profile' and args[0].device.type == 'cuda':
                    self.work[spec.target].extend(spec.work(*args, **kwargs))
                return orig(*args, **kwargs)
            return wrapper
        self.patch(spec.target, make)
