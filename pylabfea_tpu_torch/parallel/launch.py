"""Launcher of multi-rank runs on one host: ``spawn`` starts one process a
rank (``torch.multiprocessing.spawn``), joins them into a process group
over ``tcp://127.0.0.1``, runs ``fn(mesh, device, *args)`` on each and
returns every rank's result.

The ranks run on the card unless the caller lists their devices
(``placement``).  The target ``fn`` must be a module-level function of an
importable module (the spawned children import it by name, never the
caller's module), and its result picklable (numpy arrays, numbers).
Children use one torch thread.  A failure in any rank ends the others and
raises with that rank's traceback: no rank's error is swallowed.
"""
import socket
import time

import torch
import torch.multiprocessing as mp

from pylabfea_tpu_torch.config import resolve_device
from pylabfea_tpu_torch.parallel.distributed import default_backend


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def placement(world_size, device_of_rank=None, backend=None):
    """(device of each rank, backend) of a run.  ``device_of_rank=None``
    is the card: one card a rank where as many are visible, else every
    rank on card 0; raises where no card is visible.  ``backend=None`` is
    Gloo where ranks share a device (NCCL refuses two ranks of a
    communicator on one GPU), else ``default_backend``."""
    if device_of_rank is None:
        resolve_device(None)        # raises where no card is visible
        own = torch.cuda.device_count() >= world_size
        device_of_rank = [f'cuda:{r if own else 0}'
                          for r in range(world_size)]
    devices = [str(torch.device(d)) for d in device_of_rank]
    if len(devices) != world_size:
        raise ValueError('device_of_rank must list one device a rank')
    if backend is None:
        backend = 'gloo' if len(set(devices)) < world_size \
            else default_backend(devices[0])
    return devices, backend


def _child(rank, world, backend, port, devices, fn, args, out):
    import torch.distributed as dist
    from pylabfea_tpu_torch.parallel import distributed as pd
    torch.set_num_threads(1)
    device = torch.device(devices[rank])
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    joined = pd.init_multihost(f'127.0.0.1:{port}', world, rank,
                               backend=backend, device=device)
    try:
        out.put((rank, fn(pd.global_strip_mesh(), device, *args)))
    finally:
        if joined:
            dist.destroy_process_group()


def spawn(fn, world_size, backend=None, device_of_rank=None, args=(),
          timeout=900.):
    """Run ``fn(mesh, device, *args)`` on ``world_size`` spawned ranks
    placed by ``placement(world_size, device_of_rank, backend)``.  Returns
    the results by rank; raises ``RuntimeError`` with the traceback of a
    rank that failed, ``TimeoutError`` after ``timeout`` seconds."""
    devices, backend = placement(world_size, device_of_rank, backend)
    out = mp.get_context('spawn').SimpleQueue()
    ctx = mp.spawn(_child, (world_size, backend, _free_port(), devices, fn,
                            args, out), nprocs=world_size, join=False)
    results, deadline = {}, time.monotonic() + timeout
    try:
        done = False
        while not done:
            # drain while waiting: a large result blocks its rank's write
            while not out.empty():
                rank, val = out.get()
                results[rank] = val
            # raises on a failed rank, the others ended
            done = ctx.join(timeout=0.5)
            if not done and time.monotonic() > deadline:
                raise TimeoutError(f'spawn: no result after {timeout} s')
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise RuntimeError(f'rank {e.error_index} failed:\n{e}') from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    while not out.empty():
        rank, val = out.get()
        results[rank] = val
    return [results[r] for r in range(world_size)]
