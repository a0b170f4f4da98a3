"""Element-axis sharding of the 3-D hex8 solver (the counterpart of
``pylabfea_tpu.parallel.mesh3d``).

The flat element order is x-major, so a rank's contiguous share of the
elements is a block of element x-planes ``[x0, x1)``: its rows of the
(Nel, 6) states and its x-block of the (36, NX, NY, NZ) tangent volumes.
Nodal volumes stay whole on every rank.  The mesh carries its
``RankMesh`` and ``xr = (x0, x1)``; ``fe3d`` then runs the fine K-apply
through kernel C on the rank's tangent block and its x1 - x0 + 1 node
planes and all-reduces the nodal result, builds the coarse multigrid
levels whole from the gathered fine tangent volumes once per hierarchy
build, and takes the step's maxima and means over the ranks, so
``load_step3`` runs unchanged.

    ranks = make_mesh3()
    md_s = shard_mesh_data3(md, ranks)
    state = shard_state3(fe3d.init_state3(md, CV), ranks)
    state, diag = fe3d.load_step3(md_s, state, mat, CV, 0.3)
"""
import dataclasses

import torch

from pylabfea_tpu_torch.config import resolve_device
from pylabfea_tpu_torch.ops import fe3d
from pylabfea_tpu_torch.parallel.mesh import cut_groups, element_range, \
    make_mesh

#: the ranks of a 3-D element-sharded mesh are those of the 2-D one
make_mesh3 = make_mesh


def shard_mesh_data3(md, ranks, device=None):
    """``md`` restricted to this rank's element x-planes (``mesh.
    element_range`` of the NX planes) on ``device`` (the card when None):
    the element count and the material blocks cut to the block, the whole
    nodal BC volumes, ``ranks`` and ``xr`` attached."""
    device = resolve_device(device)
    NX, NY, NZ = md.grid[:3]
    x0, x1 = element_range(NX, ranks)
    e0, e1 = x0 * NY * NZ, x1 * NY * NZ
    perm = inv_perm = groups = None
    if md.groups is not None:
        lp, lip, groups = cut_groups(md, e0, e1)
        perm, inv_perm = (torch.as_tensor(x, device=device)
                          for x in (lp, lip))
    return dataclasses.replace(
        md, B=md.B.to(device), Bsum=md.Bsum.to(device),
        jacw=md.jacw.to(device), vel=md.vel.to(device),
        fixed=md.fixed.to(device), fixed_val=md.fixed_val.to(device),
        force=md.force.to(device), nel=e1 - e0, perm=perm,
        inv_perm=inv_perm, groups=groups, ranks=ranks, xr=(x0, x1))


def shard_state3(state, ranks):
    """This rank's share of a whole ``SolverState3``: the element rows of
    its x-planes, the x-block of the tangent volumes (contiguous, as kernel
    C takes them), the whole displacement."""
    NX = state.elstiff.shape[1]
    x0, x1 = element_range(NX, ranks)
    per = state.sig.shape[0] // NX
    rows = slice(x0 * per, x1 * per)
    return fe3d.SolverState3(
        u=state.u, sig=state.sig[rows], epl=state.epl[rows],
        eps=state.eps[rows],
        elstiff=state.elstiff[:, x0:x1].contiguous())
