"""Tracing, the program's recorder of spans and counters, and step timing
(the counterpart of ``pylabfea_tpu.utils.profiling``).

``trace`` records the enclosed block with ``torch.profiler`` (host and,
on a card, CUDA activity) into a Chrome trace file (chrome://tracing,
Perfetto), the recorder on for the block and its spans there as
``plfea.<name>`` ranges beside the kernels; ``StepTimer`` collects the
seconds of each load step, the card synchronized at both ends, and
counters noted by the caller.

The recorder is off by default.  ``start()`` resets it and switches it
on, ``stop()`` switches it off; ``spans()``, ``counters()`` and
``summary()`` read what it kept.  The solver marks its layers with
``span(name)`` (or ``spanned(name)`` around a whole function), counts
work with ``count(name)`` and reads every device scalar through
``host_read(tensor, site)``.  While off, a span is one shared no-op
context, a count returns at once and a host read is ``tensor.item()``:
no clock read, no ``record_function``, no synchronize.  While on:

* a span records its name, start and end (``time.perf_counter_ns``),
  its parent and its request (the id of the outermost span around it);
* a layer span (``TIMED``) synchronizes the card at both ends, as
  ``StepTimer`` does, so that its time is the card's, except under a
  running ``torch.profiler`` or while a CUDA graph is being captured;
* spans and counts made under a running ``torch.profiler`` are kept
  apart (a span's ``profiled`` flag, ``counters(profiled=True)``);
  inside ``trace`` a span also opens ``record_function('plfea.<name>')``.
  Only there: such a range has a device-side twin covering the kernels
  launched inside it, which a reader of another profiler's trace that
  tells annotations from kernels by name would count as device work;
* a host read counts ``host_reads`` and ``host_reads.<site>`` and
  records a leaf ``host_read`` span (the read itself synchronizes).

A CUDA graph replays without Python: what a captured function (the
analytic fixed-trip return map) spans and counts is recorded when it is
captured, not at each replay.

Spans and counters of the solver (``ops/``): ``solve`` (the root of
``solve_uniaxial`` / ``solve_uniaxial3``); ``load_step`` (``load_steps``,
``rounds``); ``hierarchy`` (``hierarchy_builds``) with ``mesh_chain``
(``mesh_chain_builds``) and ``coarse_inverse`` inside; ``cg``
(``cg_solves``, ``cg_iters``); ``return_map`` (``return_map_calls``, one
a ``response_fast`` call) with ``newton`` (``newton_trips``) inside;
``host_read`` (sites ``cg``, ``dst``, ``gate``, ``newton``).
"""
import contextlib
import functools
import os
import time
from collections import Counter
from dataclasses import dataclass

import torch

from pylabfea_tpu_torch.config import resolve_device

#: the layer spans, timed on the card's clock while no profiler records
TIMED = frozenset({'load_step', 'hierarchy', 'cg', 'return_map', 'newton'})
#: the trace's activity kinds of device operations (not annotations)
DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')


@dataclass(slots=True)
class Span:
    """One recorded span; ``end_ns`` is None while it is open."""
    name: str
    start_ns: int
    end_ns: int
    parent: 'Span'
    request: int
    profiled: bool

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) * 1e-9


class Recorder:
    """What one ``start()`` has recorded."""

    def __init__(self):
        self.spans = []
        self.open = []
        self.requests = 0
        self.counters = Counter()
        self.counters_profiled = Counter()


_ON = False
_RANGES = False
_REC = Recorder()
_NO_SPAN = contextlib.nullcontext()
_now = time.perf_counter_ns


def start():
    """Forget what was recorded and switch the recorder on."""
    global _ON, _REC
    _REC = Recorder()
    _ON = True


def stop():
    """Switch the recorder off; what it recorded stays readable."""
    global _ON
    _ON = False


def enabled():
    return _ON


def _profiling():
    return torch.autograd._profiler_enabled()


def _sync():
    if torch.cuda.is_initialized() and \
            not torch.cuda.is_current_stream_capturing():
        torch.cuda.synchronize()


class _Open:
    """The context of one span while the recorder is on."""
    __slots__ = ('rec', 'name', 'span', 'range')

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec, name = self.rec, self.name
        profiled = _profiling()
        if name in TIMED and not profiled:
            _sync()
        parent = rec.open[-1] if rec.open else None
        if parent is None:
            rec.requests += 1
        self.range = None
        if profiled and _RANGES:
            self.range = torch.profiler.record_function('plfea.' + name)
            self.range.__enter__()
        self.span = Span(name, _now(), None, parent,
                         rec.requests if parent is None else parent.request,
                         profiled)
        rec.spans.append(self.span)
        rec.open.append(self.span)
        return self.span

    def __exit__(self, *exc):
        s = self.span
        if self.name in TIMED and not s.profiled:
            _sync()
        s.end_ns = _now()
        self.rec.open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name, outermost=False):
    """The context of span ``name``: a record while the recorder is on,
    else one shared no-op; with ``outermost``, a record only where no
    span is open (a call made from outside the solver's spans)."""
    if not _ON or (outermost and _REC.open):
        return _NO_SPAN
    return _Open(_REC, name)


def spanned(name):
    """Decorator: the whole call is span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Open(_REC, name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def count(name, n=1):
    """Add ``n`` to counter ``name`` while the recorder is on."""
    if not _ON:
        return
    (_REC.counters_profiled if _profiling() else _REC.counters)[name] += n


def host_read(t, site):
    """The Python scalar of the one-element tensor ``t`` (``t.item()``:
    a float, bool or int), the one place the solver reads the device;
    while the recorder is on, counted under ``site``."""
    if not _ON:
        return t.item()
    with _Open(_REC, 'host_read'):
        value = t.item()
    count('host_reads')
    count('host_reads.' + site)
    return value


def spans(profiled=False):
    """The closed spans recorded outside (or, ``profiled=True``, under) a
    running ``torch.profiler``, in the order they opened."""
    return [s for s in _REC.spans
            if s.end_ns is not None and s.profiled == profiled]


def counters(profiled=False):
    """The counters tallied outside (or under) a running profiler."""
    return dict(_REC.counters_profiled if profiled else _REC.counters)


def summary(profiled=False):
    """{name: {'count', 'total_s', 'self_s'}} of the closed spans:
    ``total_s`` sums the spans of that name not inside another of that
    name; ``self_s`` sums each span's time less its children's."""
    out, child = {}, Counter()
    closed = spans(profiled)
    for s in closed:
        if s.parent is not None:
            child[id(s.parent)] += s.end_ns - s.start_ns
    for s in closed:
        d = out.setdefault(s.name, {'count': 0, 'total_s': 0.,
                                    'self_s': 0.})
        d['count'] += 1
        p = s.parent
        while p is not None and p.name != s.name:
            p = p.parent
        if p is None:
            d['total_s'] += s.seconds
        d['self_s'] += s.seconds - child[id(s)] * 1e-9
    return out


def device_busy_s(prof):
    """Seconds in which any device operation (kernel, copy, set) ran in a
    finished ``torch.profiler`` run: the union of their intervals, so
    that overlapping operations count once."""
    iv = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith('CUDA'):
            continue
        try:
            kind = e.activity_type()
        except AttributeError:      # older releases: annotations by name
            kind = 'annotation' if e.name().startswith('plfea.') \
                else 'kernel'
        if kind in DEVICE_KINDS:
            iv.append((e.start_ns(), e.end_ns()))
    busy, cur_s, cur_e = 0, None, None
    for s, t in sorted(iv):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-9


@contextlib.contextmanager
def trace(logdir, device=None):
    """Record a ``torch.profiler`` trace of the enclosed block into
    ``logdir/trace.json``: CPU activity, and CUDA activity where
    ``device`` (the card when None) is a card.  A recorder that is off is
    started for the block and stopped after it; its spans in the block
    are ``plfea.<name>`` ranges.  Yields the profiler."""
    global _RANGES
    device = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = _ON
    if not was_on:
        start()
    _RANGES = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
    finally:
        _RANGES = False
        if not was_on:
            stop()
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
