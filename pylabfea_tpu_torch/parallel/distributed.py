"""Multi-process runtime of the domain decomposition (the counterpart of
``pylabfea_tpu.parallel.distributed``).

``init_multihost`` joins the ``torch.distributed`` process group and
``global_strip_mesh`` orders its ranks into the ``RankMesh`` that the strip
(``parallel.sharded``) and slab (``parallel.sharded3``) meshes span, with
the ranks of one host contiguous so that neighbouring strips exchange their
halos inside a host wherever possible.

``RankMesh`` carries the only collectives the solvers use: ``all_reduce``
(a sum, or a maximum) and ``broadcast``.  Both backends take them on CUDA
tensors, so the halo exchange is built on ``all_reduce`` as well
(``exchange``): every position writes its boundary slabs into its own slot
of a zero buffer and the sum hands every position everyone's slabs, bit for
bit (each entry has one non-zero contributor).  NCCL serves ranks on distinct cards, Gloo the
CPU and several ranks on one card (NCCL refuses two ranks of a communicator
on one GPU; Gloo's send/recv take CPU tensors only).
"""
import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist


def default_backend(device):
    """The backend for ranks on ``device``: 'nccl' on a CUDA device (one
    card a rank), 'gloo' on the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, backend=None, device=None):
    """Join the ``torch.distributed`` process group.  A no-op that returns
    False for a single process.

    The arguments default to the standard variables ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``coordinator_address`` is 'host:port'), ``WORLD_SIZE``
    and ``RANK``.  ``backend`` defaults to ``default_backend(device)``;
    ``device=None`` is the card, as everywhere in the port.  Returns True
    once the group is up."""
    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get('WORLD_SIZE', 1))
    if world <= 1:
        return False
    if coordinator_address is None:
        coordinator_address = f'{env["MASTER_ADDR"]}:{env["MASTER_PORT"]}'
    rank = int(process_id if process_id is not None else env['RANK'])
    if backend is None:
        from pylabfea_tpu_torch.config import resolve_device
        backend = default_backend(resolve_device(device))
    dist.init_process_group(backend,
                            init_method=f'tcp://{coordinator_address}',
                            world_size=world, rank=rank)
    return True


@dataclass(frozen=True)
class RankMesh:
    """The ordered ranks of a strip or slab decomposition: ``order[p]`` is
    the global rank at strip position p, ``pos`` this process's position.
    The default is the single-process mesh (no collectives)."""
    order: tuple = (0,)
    pos: int = 0

    @property
    def size(self):
        return len(self.order)

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """Reduce ``t`` over the ranks (a sum, or ``op``), in place;
        returns ``t``."""
        if self.size > 1:
            dist.all_reduce(t, op)
        return t

    def sum(self, t):
        """``t`` summed over the ranks (a new tensor where there are
        several)."""
        if self.size == 1:
            return t
        return self.all_reduce(t.reshape(-1).clone()).reshape(t.shape)

    def max(self, t):
        """The elementwise maximum of ``t`` over the ranks (a new tensor
        where there are several)."""
        if self.size == 1:
            return t
        return self.all_reduce(t.reshape(-1).clone(),
                               dist.ReduceOp.MAX).reshape(t.shape)

    def broadcast(self, t, src_pos=0):
        """``t`` of position ``src_pos`` on every rank, in place."""
        if self.size > 1:
            dist.broadcast(t, self.order[src_pos])
        return t

    def exchange(self, t):
        """Every position's ``t`` (same shape and dtype everywhere):
        (size, *t.shape), row p from position p."""
        if self.size == 1:
            return t[None]
        buf = t.new_zeros((self.size,) + tuple(t.shape))
        buf[self.pos] = t
        return self.all_reduce(buf)


def global_strip_mesh():
    """The ``RankMesh`` over every rank of the process group, ordered so
    that the ranks of one host are contiguous (hosts in the order of their
    lowest rank, ranks ascending within a host); the single-process mesh
    where no group is up."""
    if not (dist.is_available() and dist.is_initialized()):
        return RankMesh()
    world = dist.get_world_size()
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    first = {}
    for r, h in enumerate(hosts):
        first.setdefault(h, r)
    order = tuple(sorted(range(world), key=lambda r: (first[hosts[r]], r)))
    return RankMesh(order, order.index(dist.get_rank()))
