"""Replay of a function's kernel launches from CUDA graphs.

``Graphed(fn)`` calls ``fn`` eagerly the first time it sees an input
signature (the structure of the arguments, the shape, dtype and device of
every tensor, the values of every leaf that is neither a tensor nor a
float), capturing its launches into a CUDA graph; later calls with that
signature copy the tensors into the graph's static inputs, replay it and
return copies of its outputs.  The host then issues one replay instead of
every launch: the fixed-trip return map is some 2,500 small kernels a
call, whose launch path on the host costs far more than their work on the
card.

Arguments may nest tuples, lists, dataclasses (``DeviceMaterial``) and
``dual.Dual`` values; a call only replays when every tensor lies on the
card and none takes part in ``torch.autograd``, ``forward_ad`` or a
``torch.func`` transform (a replay records no derivative): otherwise
``fn`` runs as it is.  Float leaves (a material's ``sy``, ``khard``, ...)
are inputs like the tensors: the graph sees them as 0-d float64 tensors
on the card, so a new value replays the same graph.  ``fn`` must read
nothing back to the host and decide nothing on tensor or float values;
what it decides on the other leaves (ints, bools, shapes) is part of the
signature.  Each ``Graphed`` keeps its ``MAX_GRAPHS`` most recently used
graphs, which share a memory pool; a call's outputs are copied out before
the next replay.  A signature whose capture fails (an operation the graph
cannot record) runs eagerly from then on, its error kept in ``failed``.
"""
import dataclasses

import torch

from pylabfea_tpu_torch.ops import dual

#: graphs on (set False to run every call eagerly, e.g. to compare)
ENABLED = True
#: graphs kept per ``Graphed``, the least recently used evicted first
#: (``femu.fit_field`` on a two-material mesh runs the fixed-trip map
#: with 11 signatures, ``calibrate.fit_plasticity`` with 3-6)
MAX_GRAPHS = 32
#: every ``Graphed`` made, for reading ``failed`` and ``replays``
INSTANCES = []


def _flatten(x, leaves):
    """(structure key, rebuild) of ``x``; its tensors appended to
    ``leaves``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        i = len(leaves) - 1
        return (('T', tuple(x.shape), x.dtype, x.device.type),
                lambda ls: ls[i])
    if isinstance(x, dual.Dual):
        kv, rv = _flatten(x.v, leaves)
        kt, rt = _flatten(x.t, leaves)
        return ('D', kv, kt), lambda ls: dual.Dual(rv(ls), rt(ls))
    if isinstance(x, (tuple, list)):
        parts = [_flatten(e, leaves) for e in x]
        kind = type(x)
        return ((kind.__name__,) + tuple(k for k, _ in parts),
                lambda ls: kind(r(ls) for _, r in parts))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = [f.name for f in dataclasses.fields(x) if f.init]
        parts = [_flatten(getattr(x, n), leaves) for n in names]
        cls = type(x)
        return ((cls.__name__,) + tuple(k for k, _ in parts),
                lambda ls: cls(**{n: r(ls) for n, (_, r) in
                                  zip(names, parts)}))
    if isinstance(x, float):
        leaves.append(x)
        i = len(leaves) - 1
        return ('F',), lambda ls: ls[i]
    return ('C', type(x).__name__, x), lambda ls: x


def _replayable(leaves):
    from torch.autograd import forward_ad
    leaves = [t for t in leaves if isinstance(t, torch.Tensor)]
    if not leaves or not all(t.is_cuda for t in leaves):
        return False
    grad = torch.is_grad_enabled()
    return not any(torch._C._functorch.is_functorch_wrapped_tensor(t)
                   or (grad and t.requires_grad)
                   or forward_ad.unpack_dual(t).tangent is not None
                   for t in leaves)


class Graphed:
    """``fn`` with its calls replayed from CUDA graphs, one per input
    signature (see the module docstring)."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs = {}
        self.failed = {}
        self.pool = None
        self.replays = 0
        INSTANCES.append(self)

    def __call__(self, *args):
        leaves = []
        key, rebuild = _flatten(args, leaves)
        if not ENABLED or key in self.failed or not _replayable(leaves):
            return self.fn(*args)
        entry = self.graphs.get(key)
        if entry is None:
            return self._capture(key, leaves, rebuild)
        self.graphs[key] = self.graphs.pop(key)      # most recently used
        static_in, graph, out_leaves, out_rebuild = entry
        for s, x in zip(static_in, leaves):
            if isinstance(x, float):
                s.fill_(x)
            else:
                s.copy_(x)
        graph.replay()
        self.replays += 1
        return out_rebuild([o.clone() if isinstance(o, torch.Tensor) else o
                            for o in out_leaves])

    def _capture(self, key, leaves, rebuild):
        dev = next(x.device for x in leaves if isinstance(x, torch.Tensor))
        static_in = [torch.tensor(x, dtype=torch.float64, device=dev)
                     if isinstance(x, float) else x.clone() for x in leaves]
        args = rebuild(static_in)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = self.fn(*args)            # the eager call: this result
        torch.cuda.current_stream().wait_stream(side)
        if not self.graphs:
            # a pool is freed with the last graph that used it
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                static_out = self.fn(*args)
        except RuntimeError as err:
            self.failed[key] = repr(err)
            torch.cuda.synchronize()
            return out
        out_leaves = []
        _, out_rebuild = _flatten(static_out, out_leaves)
        while len(self.graphs) >= MAX_GRAPHS:
            del self.graphs[next(iter(self.graphs))]
        self.graphs[key] = (static_in, graph, out_leaves, out_rebuild)
        return out
