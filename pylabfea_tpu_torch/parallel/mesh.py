"""Element-axis sharding of the 2-D solver (the counterpart of
``pylabfea_tpu.parallel.mesh``).

The return map is elementwise and the only coupling between elements is
the scatter-add of the matrix-free K-apply.  So each rank keeps a
contiguous share ``[e0, e1)`` of the elements (their dofs, material
blocks and state) on the flat layout (``femu.flatten_mesh``: a gather, a
batched (Nel, 8, 8) product and a scatter-add, solved by Jacobi-CG), and
whole nodal vectors.  The mesh carries its ``RankMesh``: the scatter-add
is all-reduced over the ranks, the step's maxima and means are taken over
them (``fe_kernels.scatter_element``, ``rank_max``, ``rank_mean``), and
``load_step_split``'s flat branch runs unchanged.  Each CG vector
operation runs whole on every rank, so every rank takes the same
iterations.  With an SVC material each rank launches kernel A on its
share.

    ranks = make_mesh()                       # the process group's ranks
    md_s = shard_mesh_data(md, ranks)
    state = shard_state(fe_kernels.init_state(femu.flatten_mesh(md), CV),
                        ranks)
    state, diag = fe_kernels.load_step_split(md_s, state, mat, CV, 0.25)
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from pylabfea_tpu_torch.config import resolve_device
from pylabfea_tpu_torch.ops import fe_kernels as fek
from pylabfea_tpu_torch.ops.femu import flatten_mesh
from pylabfea_tpu_torch.parallel.distributed import RankMesh, \
    global_strip_mesh


def make_mesh(n_devices=None, device=None):
    """The ranks the elements are sharded over: the ``RankMesh`` of the
    process group (the one-rank mesh where no group is up, or with
    ``n_devices=1``).  ``n_devices`` other than 1 must be the group's world
    size.  ``device=None`` is the card: raises where none is visible, as
    every constructor of the port."""
    resolve_device(device)
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if n_devices == 1:
        return RankMesh()
    if n_devices is not None and n_devices != world:
        raise ValueError(f'make_mesh: {n_devices} ranks asked for, the '
                         f'process group has {world}')
    return global_strip_mesh()


def element_range(nel, ranks):
    """This rank's contiguous share ``[e0, e1)`` of ``nel`` elements (or
    element x-planes): equal shares in position order; raises where
    ``nel`` does not divide."""
    W = ranks.size
    if nel % W:
        raise ValueError(f'{nel} elements (or x-planes) do not divide over '
                         f'{W} ranks')
    n = nel // W
    return ranks.pos * n, (ranks.pos + 1) * n


def cut_groups(md, e0, e1):
    """(perm, inv_perm, groups) of the elements ``[e0, e1)`` of a
    multi-material mesh: one block per material of the whole mesh, empty
    where the range holds none of it (numpy, local indices)."""
    ids = np.empty(md.nel, np.int64)
    perm = md.perm.cpu().numpy()
    for k, (a, n) in enumerate(md.groups):
        ids[perm[a:a + n]] = k
    local = ids[e0:e1]
    lperm = np.argsort(local, kind='stable')
    counts = np.bincount(local, minlength=len(md.groups))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return lperm, np.argsort(lperm), tuple(
        (int(a), int(c)) for a, c in zip(starts, counts))


def shard_mesh_data(md, ranks, device=None):
    """The flat mesh of a 2-D quad mesh ``md`` (structured or flat)
    restricted to this rank's elements (``element_range``), on ``device``
    (the card when None): the element dofs, the plane-stress condensation
    rows and the material blocks cut to the range; the shared B tables and
    the whole nodal BC vectors; ``ranks`` attached."""
    device = resolve_device(device)
    flat = flatten_mesh(md)
    if flat.B.dim() == 4:
        raise ValueError('shard_mesh_data: a mesh with per-element B tables '
                         '(the 1-D bars) is not sharded')
    e0, e1 = element_range(md.nel, ranks)
    perm = inv_perm = groups = None
    if md.groups is not None:
        lp, lip, groups = cut_groups(md, e0, e1)
        perm, inv_perm = (torch.as_tensor(x, device=device)
                          for x in (lp, lip))
    cut = slice(e0, e1)
    ps_b2 = None if flat.ps_b2 is None else \
        flat.ps_b2.reshape(8, -1)[:, cut].to(device)
    return dataclasses.replace(
        flat, B=flat.B.to(device), Bsum=flat.Bsum.to(device),
        jacw=flat.jacw.to(device), vel=flat.vel.to(device),
        fixed=flat.fixed.to(device),
        fixed_val=flat.fixed_val.to(device), force=flat.force.to(device),
        M64=None if flat.M64 is None else flat.M64.to(device),
        dofs=flat.dofs[cut].to(device),
        nel=e1 - e0, perm=perm, inv_perm=inv_perm, groups=groups,
        ps_b2=ps_b2, ranks=ranks)


def shard_state(state, ranks):
    """This rank's share of a whole 2-D ``SolverState``: the element rows
    (and tangent rows; the tangent planes of a structured state are
    turned into rows) of ``element_range``, the displacement as the whole
    flat vector."""
    nel = state.sig.shape[0]
    e0, e1 = element_range(nel, ranks)
    els = state.elstiff
    if state.u.dim() == 3:              # a structured state: planes
        els = els.reshape(36, nel).T.reshape(nel, 6, 6)
    return fek.SolverState(u=state.u.reshape(-1), sig=state.sig[e0:e1],
                           epl=state.epl[e0:e1], eps=state.eps[e0:e1],
                           elstiff=els[e0:e1].contiguous())
