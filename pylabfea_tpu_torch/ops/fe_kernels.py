"""Structured-grid FE operator and the split load step (subset of
``pylabfea_tpu.ops.fe_kernels``).

The solver never forms K: on a structured NX x NY bilinear-quad grid the
operator is ``u -> K u`` over element stiffness planes (8, 8, NX, NY),
applied by kernel B (``stencil.k_apply``; the plain version on the CPU).
Nodal vectors are component-major planes (2, nnX, nnY), carried through the
solvers as per-component tuples.  Displacement BCs are identity rows on
fixed dofs (masking around the apply).

Ported: plane-strain and plane-stress meshes, single- and
multi-material, the multigrid-preconditioned CG solve, the batched return
maps (fast and reference-faithful) and ``load_step_split`` with its
warm-start/hierarchy-reuse protocol, the convergence gate, mixed-precision
refinement, the float64 commit and the faithful tail.

Multi-material meshes (``rect_mesh(mat_map=...)``) sort the elements into
contiguous per-material blocks (``perm``, ``groups``); the solvers then
take tuples of materials and elastic stiffnesses aligned with the groups,
and ``respond_grouped`` runs one return map per block.

The flat layout (``grid=None``, ``femu.flatten_mesh``) keeps nodal vectors
as (Ndof,) with dof = comp * nnode + node and the element dofs in
``dofs``; its operator is a gather, a batched (Nel, 8, 8) product and a
scatter-add (``k_apply``), solved by Jacobi-preconditioned CG
(``cg_solve``, ``solve_linear``, and ``load_step_split``'s flat branch;
per-element B tables carry the 1-D bars).  Nothing on it is a kernel of
its own.  A flat mesh may hold one rank's share of the elements
(``parallel.mesh.shard_mesh_data``): its ``ranks`` all-reduce the
scatter-add, and the step's maxima and means are taken over the ranks.
"""
import dataclasses
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from pylabfea_tpu_torch.config import DTYPE_DEVICE, resolve_device, \
    yf_tolerance
from pylabfea_tpu_torch.ops import constitutive as con
from pylabfea_tpu_torch.ops import stencil as st
from pylabfea_tpu_torch.utils import profiling


@dataclass
class MeshData:
    """Mesh tensors of the solver (the JAX ``MeshData``).  Structured
    meshes carry ``grid`` and (2, nnX, nnY) BC planes; flat ones
    (``grid=None``) carry 1-D (Ndof,) BC vectors and the element dofs
    ``dofs`` (Nel, 8) (``grid_dofs``).  Multi-material meshes carry
    ``perm`` (a stable sort of the elements by material), its inverse
    ``inv_perm`` and the (start, size) blocks ``groups``; multi-material
    plane-stress meshes also carry ``ps_b2``, the per-element eps_33
    condensation rows.  These are None on single-material meshes.
    ``ranks`` (a ``parallel.distributed.RankMesh``) marks a flat mesh that
    holds this rank's contiguous share of the elements (``nel`` of them,
    ``parallel.mesh.shard_mesh_data``) and whole nodal vectors.
    ``cache`` holds what is derived once per mesh object (the multigrid
    coarse-mesh chain and transfer matrices); ``dataclasses.replace``
    starts a copy with an empty one."""
    B: torch.Tensor          # (4, 6, 8) B at the Gauss points, or
    #                          (Nel, ngp, 6, n) per element (flat bars)
    Bsum: torch.Tensor       # (6, 8) sum_g B (element-average strain)
    jacw: torch.Tensor       # 0-d: Jacobian * Gauss weight ((Nel,) per el.)
    vel: torch.Tensor        # 0-d: element volume
    fixed: torch.Tensor      # (2, nnX, nnY) | (Ndof,) bool displacement BCs
    fixed_val: torch.Tensor  # prescribed values (unit load), same layout
    force: torch.Tensor      # external forces (unit load), same layout
    ndof: int
    nel: int
    grid: tuple              # (NX, NY, lx, ly, uniax); None when flat
    M64: torch.Tensor        # (64, 36) float64 m64_matrix of the geometry
    perm: torch.Tensor = None      # (Nel,) int64 material sort
    inv_perm: torch.Tensor = None  # (Nel,) int64: inv_perm[perm[j]] = j
    ps_b2: torch.Tensor = None     # (8, NX, NY) eps_33 condensation rows
    groups: tuple = None           # ((start, size), ...) per material
    dofs: torch.Tensor = None      # (Nel, 8) int64 global dofs (flat layout)
    ranks: object = None           # RankMesh of an element-sharded mesh
    cache: dict = field(default_factory=dict, init=False, repr=False,
                        compare=False)

    @property
    def device(self):
        return self.B.device

    @property
    def dtype(self):
        return self.B.dtype


def _quad_B(lx, ly, dtype=np.float64, ps_CV=None, ps_E=None, ps_nu=None):
    """B matrices of the bilinear quad at the 4 Gauss points.  With
    ``ps_CV``/``ps_E``/``ps_nu`` the plane-stress thickness strain
    eps_33 = -nu (sig_11 + sig_22) / E is folded into row 2 of each B."""
    cpos = np.sqrt(1. / 3.)
    Bs = np.zeros((4, 6, 8), dtype=dtype)
    for i in range(4):
        sx = (-1) ** int(i / 2)
        sy = (-1) ** i
        x = 0.5 * (1. + sx * cpos) * lx
        y = 0.5 * (1. + sy * cpos) * ly
        xi1 = 2. * x / lx - 1.
        xi2 = 2. * y / ly - 1.
        hxm = 0.125 * (1. - xi1) / ly
        hym = 0.125 * (1. - xi2) / lx
        hxp = 0.125 * (1. + xi1) / ly
        hyp = 0.125 * (1. + xi2) / lx
        B = Bs[i]
        B[0, 0] = -hym
        B[0, 2] = -hyp
        B[0, 4] = hym
        B[0, 6] = hyp
        B[1, 1] = -hxm
        B[1, 3] = hxm
        B[1, 5] = -hxp
        B[1, 7] = hxp
        B[5, 0] = -hxm
        B[5, 1] = -hym
        B[5, 2] = hxm
        B[5, 3] = -hyp
        B[5, 4] = -hxp
        B[5, 5] = hym
        B[5, 6] = hxp
        B[5, 7] = hyp
        if ps_CV is not None:
            hh = np.asarray(ps_CV, dtype=dtype) @ B
            B[2, :] = -ps_nu * (hh[0, :] + hh[1, :]) / ps_E
    return Bs


def make_edge_bcs(NX, NY, left=None, right=None, bot=None, top=None,
                  nodes=()):
    """Structured-grid BC planes from edge specs: each edge maps a
    component (0 = x, 1 = y) to ``(bctype, value)``, 'disp' (prescribed
    displacement) or 'force' (total edge force, half weight at the end
    nodes); ``nodes`` holds ``(ix, iy, comp, bctype, value)`` single-node
    BCs.  Conflicting displacement BCs are first-come in the order left,
    bottom, right, top, node set.  Returns numpy planes (fixed, fixed_val,
    force) for a unit load factor."""
    nnX, nnY = NX + 1, NY + 1
    fixed = np.zeros((2, nnX, nnY), dtype=bool)
    fval = np.zeros((2, nnX, nnY))
    force = np.zeros((2, nnX, nnY))
    sel = {'left': (0, slice(None)), 'right': (nnX - 1, slice(None)),
           'bot': (slice(None), 0), 'top': (slice(None), nnY - 1)}

    def apply_edge(which, spec):
        if not spec:
            return
        ii, jj = sel[which]
        n_edge = nnY if which in ('left', 'right') else nnX
        for comp, (bctype, val) in spec.items():
            if bctype == 'disp':
                new = ~fixed[comp, ii, jj]
                v = fval[comp, ii, jj]
                v[new] = val
                fval[comp, ii, jj] = v
                fixed[comp, ii, jj] = True
            elif bctype == 'force':
                h = np.full(n_edge, 1. / max(n_edge - 1, 1))
                h[0] *= 0.5
                h[-1] *= 0.5
                force[comp, ii, jj] += val * h
            else:
                raise ValueError(f'unknown bctype {bctype!r}')

    for which, spec in (('left', left), ('bot', bot), ('right', right),
                        ('top', top)):
        apply_edge(which, spec)
    for ix, iy, comp, bctype, val in nodes:
        if bctype == 'disp':
            if not fixed[comp, ix, iy]:
                fixed[comp, ix, iy] = True
                fval[comp, ix, iy] = val
        else:
            force[comp, ix, iy] += val
    return fixed, fval, force


def material_groups(ids):
    """Stable sort of element material ids into contiguous blocks: (perm,
    inv_perm, groups) with inv_perm[perm[j]] = j and one (start, size)
    pair per material id 0..max."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    perm = np.argsort(ids, kind='stable')
    inv_perm = np.argsort(perm)
    counts = np.bincount(ids, minlength=int(ids.max()) + 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return perm, inv_perm, tuple((int(a), int(c))
                                 for a, c in zip(starts, counts))


def rect_mesh(NX, NY, LX=1., LY=1., thick=1., uniax='y', eps_tot=0.01,
              dtype=DTYPE_DEVICE, device=None, planestress=False, ps_CV=None,
              ps_E=None, ps_nu=None, eps_x=None, eps_y=None, bc=None,
              mat_map=None):
    """Structured NX x NY quad mesh.  Default BCs: left fixed in x, bottom
    fixed in y, top pulled in +y (``uniax='y'``), right pulled in +x
    (``'x'``) or both (``'xy'``, magnitudes ``eps_x``/``eps_y``); ``bc``
    (see ``make_edge_bcs``) replaces them.  ``fixed_val``/``force`` are
    patterns for a unit load factor.  ``device=None`` is the card.

    ``mat_map`` (NX, NY) material ids 0..n-1 makes a multi-material mesh
    (see ``MeshData``).  ``planestress=True`` takes the plane-stress
    reduced stiffness ``ps_CV`` and the isotropic ``ps_E``/``ps_nu``: one
    material folds the eps_33 condensation into B; several (tuples
    aligned with the groups) keep B condensation-free and put each
    element's condensation row into ``ps_b2`` (the reduced CV has an
    empty row and column 2, so the row never enters the stiffness)."""
    device = resolve_device(device)
    nnX, nnY = NX + 1, NY + 1
    lx, ly = LX / NX, LY / NY
    if bc is not None:
        fixed, fixed_val, force = make_edge_bcs(
            NX, NY, left=bc.get('left'), right=bc.get('right'),
            bot=bc.get('bot'), top=bc.get('top'), nodes=bc.get('nodes', ()))
        uniax = 'bc'
    else:
        fixed = np.zeros((2, nnX, nnY), dtype=bool)
        fixed_val = np.zeros((2, nnX, nnY))
        force = np.zeros((2, nnX, nnY))
        fixed[0, 0, :] = True                   # left: ux = 0
        fixed[1, :, 0] = True                   # bottom: uy = 0
        ex = eps_tot if eps_x is None else eps_x
        ey = eps_tot if eps_y is None else eps_y
        if uniax in ('y', 'xy'):
            fixed[1, :, -1] = True              # top: uy prescribed
            fixed_val[1, :, -1] = ey * LY
        if uniax in ('x', 'xy'):
            fixed[0, -1, :] = True              # right: ux prescribed
            fixed_val[0, -1, :] = ex * LX
    perm = inv_perm = groups = ps_b2 = None
    if mat_map is not None:
        ids = np.asarray(mat_map, dtype=np.int64).reshape(NX * NY)
        perm, inv_perm, groups = material_groups(ids)
    if planestress and (ps_CV is None or ps_E is None or ps_nu is None):
        raise ValueError('planestress=True requires ps_CV, ps_E, ps_nu')
    if planestress and groups is None:
        Bs = _quad_B(lx, ly, ps_CV=ps_CV, ps_E=ps_E, ps_nu=ps_nu)
    else:
        Bs = _quad_B(lx, ly)
    if planestress and groups is not None:
        # eps_33(e) = b2_k(e) . u_e, b2_k = -(nu_k / E_k) [(C_k Bsum)_0 +
        # (C_k Bsum)_1] for the material k of element e
        Bsum_np = Bs.sum(axis=0)
        rows = np.zeros((len(ps_CV), 8))
        for k, (CVk, Ek, nuk) in enumerate(zip(ps_CV, ps_E, ps_nu)):
            hh = np.asarray(CVk, float) @ Bsum_np
            rows[k] = -nuk * (hh[0, :] + hh[1, :]) / Ek
        ps_b2 = rows[ids].T.reshape(8, NX, NY)
    vel = lx * ly * thick

    def dev(a, dt=dtype):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=dt, device=device)

    return MeshData(B=dev(Bs), Bsum=dev(Bs.sum(axis=0)), jacw=dev(vel * 4.),
                    vel=dev(vel), fixed=dev(fixed, torch.bool),
                    fixed_val=dev(fixed_val), force=dev(force),
                    ndof=2 * nnX * nnY, nel=NX * NY,
                    grid=(NX, NY, lx, ly, uniax),
                    M64=dev(m64_matrix(Bs, vel * 4.), torch.float64),
                    perm=dev(perm, torch.long),
                    inv_perm=dev(inv_perm, torch.long), ps_b2=dev(ps_b2),
                    groups=groups)


def grid_dofs(NX, NY):
    """(Nel, 8) int64 numpy: the flat dofs (dof = comp * nnode + node) of
    each element's local dofs on an NX x NY grid, nodes numbered column
    by column as in the reference's structured mesher (the JAX
    ``rect_mesh``'s ``dofs``)."""
    nnY = NY + 1
    ih = np.arange(NX * NY)
    n1 = (ih // NY) * nnY + ih % NY
    nodes = np.stack([n1, n1 + 1, n1 + nnY, n1 + nnY + 1], axis=1)
    return np.stack([nodes + c * (NX + 1) * nnY for c in range(2)],
                    axis=2).reshape(-1, 8)


def m64_matrix(B, jacw):
    """The (64, 36) element-stiffness contraction matrix M[(i,j),(a,b)] =
    jacw sum_g B[g,a,i] B[g,b,j] in float64 (numpy), from the geometry as
    given: ``rect_mesh`` passes the unrounded float64 tables, so the
    refinement residual measures the error against the true operator."""
    B = np.asarray(B, np.float64)
    return float(jacw) * np.einsum('gai,gbj->ijab', B, B).reshape(64, 36)


# -----------------------------------------------------------------
# plane operators
# -----------------------------------------------------------------
def _split(v):
    """(2, nnX, nnY) planes -> per-component tuple."""
    return (v[0], v[1])


def _merge(t):
    return torch.stack(t, 0)


def _gather_planes(md: MeshData, v):
    return st.gather_planes(v, *md.grid[:2])


def elstiff_planes(md: MeshData, elstiff):
    """Tangent field in planes layout (36, NX, NY); rows (Nel, 6, 6) are
    transposed, planes pass through."""
    if elstiff.dim() == 3 and elstiff.shape[0] == 36:
        return elstiff
    NX, NY = md.grid[:2]
    return elstiff.reshape(md.nel, 36).T.reshape(36, NX, NY)


def element_stiffness_planes(md: MeshData, elstiff):
    """Element stiffness planes (8, 8, NX, NY): one (64, 36) geometry
    matrix M[(i,j),(a,b)] = jacw sum_g B[g,a,i] B[g,b,j] against the
    (36, NX*NY) tangent planes."""
    NX, NY = md.grid[:2]
    els = elstiff_planes(md, elstiff)
    M = md.jacw * torch.einsum('gai,gbj->ijab', md.B, md.B)
    Ke = M.reshape(64, 36) @ els.reshape(36, NX * NY)
    return Ke.reshape(8, 8, NX, NY)


def _dot(a, b):
    """Dot product of plane tuples."""
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _axpy(a, x, y):
    """a * x + y over plane tuples."""
    return tuple(a * u + v for u, v in zip(x, y))


# -----------------------------------------------------------------
# flat layout (grid=None)
# -----------------------------------------------------------------
def gather_element(md: MeshData, v):
    """Flat nodal vector (Ndof,) -> per-element (Nel, 8) local values."""
    return v[md.dofs]


def scatter_element(md: MeshData, fe):
    """Per-element (Nel, 8) contributions -> flat nodal vector
    (scatter-add, summed over the ranks of an element-sharded mesh)."""
    out = fe.new_zeros(md.ndof).index_add(0, md.dofs.reshape(-1),
                                          fe.reshape(-1))
    return out if md.ranks is None else md.ranks.all_reduce(out)


def rank_max(md, t):
    """``t`` (a maximum over this mesh's elements) maximized over the
    ranks of an element-sharded mesh."""
    return t if md.ranks is None else md.ranks.max(t)


def rank_mean(md, x):
    """The mean over every element of element rows ``x`` (Nel, k): over
    the ranks of an element-sharded mesh, whose shares are equal."""
    if md.ranks is None:
        return torch.mean(x, dim=0)
    return md.ranks.sum(torch.sum(x, dim=0)) / (md.nel * md.ranks.size)


def element_stiffness(md: MeshData, elstiff):
    """Ke[e] = jacw sum_g B_g^T C_e B_g, (Nel, n, n): with the shared
    (ngp, 6, n) B as one (n*n, 36) geometry matrix against the (Nel, 36)
    tangent rows, with per-element (Nel, ngp, 6, n) B and (Nel,) jacw (the
    bar path) as one batched contraction."""
    if md.B.dim() == 4:
        Ke = torch.einsum('egai,eab,egbj->eij', md.B, elstiff, md.B)
        return md.jacw[:, None, None] * Ke
    n = md.B.shape[-1]
    M = md.jacw * torch.einsum('gai,gbj->ijab', md.B, md.B)
    return (elstiff.reshape(-1, 36) @ M.reshape(n * n, 36).T).reshape(
        -1, n, n)


def k_apply(md: MeshData, Ke, v):
    """Matrix-free K v on a flat mesh with identity rows on fixed dofs: a
    gather, a batched (Nel, 8, 8) product and a scatter-add."""
    vm = torch.where(md.fixed, 0., v)
    fe = torch.einsum('eij,ej->ei', Ke, vm[md.dofs])
    return torch.where(md.fixed, v, scatter_element(md, fe))


def k_diag(md: MeshData, Ke):
    """Diagonal of K on a flat mesh (the Jacobi preconditioner), 1 on
    fixed dofs."""
    d = scatter_element(md, torch.diagonal(Ke, dim1=1, dim2=2))
    return torch.where(md.fixed, 1., d)


@profiling.spanned('cg')
def cg_solve(apply_fn, b, x0, diag, tol=1.e-8, maxiter=2000):
    """Jacobi-preconditioned CG on flat vectors (the JAX ``cg_solve``).

    Exits at ``|r| <= tol |b|``, at ``maxiter``, or (float32 only) after 4
    consecutive iterations below 1e-3 relative that improve the best
    residual by less than 5%: the f32 rounding floor.  The residual norm
    is read to the host once an iteration (the exit test).  Returns (x,
    relative residual, iterations)."""
    minv = 1. / diag
    r = b - apply_fn(x0)
    z = minv * r
    p = z
    rz = torch.sum(r * z)
    bnorm = max(profiling.host_read(torch.sqrt(torch.sum(b * b)), 'cg'),
                1e-30)
    b_f32 = b.dtype == torch.float32
    x = x0
    it, nstall = 0, 0
    rn = best = profiling.host_read(torch.sqrt(torch.sum(r * r)), 'cg')
    while rn > tol * bnorm and it < maxiter and nstall < 4:
        Ap = apply_fn(p)
        alpha = rz / torch.sum(p * Ap)
        x = alpha * p + x
        r = -alpha * Ap + r
        z = minv * r
        rz_new = torch.sum(r * z)
        p = (rz_new / rz) * p + z
        rn = profiling.host_read(torch.sqrt(torch.sum(r * r)), 'cg')
        if b_f32:
            if rn < 0.95 * best:
                nstall = 0
            elif rn < 1e-3 * bnorm:
                nstall += 1
        best = min(best, rn)
        rz = rz_new
        it += 1
    profiling.count('cg_solves')
    profiling.count('cg_iters', it)
    return x, rn / bnorm, it


def _cg_flat(md: MeshData, elstiff, bc_val, force, cg_tol, cg_maxiter, x0):
    """Jacobi-CG on the BC-embedded flat system: the prescribed values
    ``bc_val`` on fixed dofs, their coupling moved to the right-hand
    side."""
    Ke = element_stiffness(md, elstiff)
    du_bc = torch.where(md.fixed, bc_val, 0.)
    fe = torch.einsum('eij,ej->ei', Ke, gather_element(md, du_bc))
    rhs = torch.where(md.fixed, bc_val, -scatter_element(md, fe) + force)
    start = torch.where(md.fixed, bc_val, x0)
    return cg_solve(lambda v: k_apply(md, Ke, v), rhs, start, k_diag(md, Ke),
                    tol=cg_tol, maxiter=cg_maxiter)


def solve_linear(md: MeshData, elstiff, bc_val, force=None, cg_tol=None,
                 cg_maxiter=100, x0=None):
    """One Jacobi-CG solve on a flat mesh with the tangent rows
    ``elstiff`` (Nel, 6, 6): prescribed ``bc_val`` on fixed dofs, the
    optional external ``force`` on free ones, started from ``x0`` (zero
    when None); the flat branch of the JAX ``solve_linear`` (structured
    meshes solve with MG-CG inside ``load_step_split``).  Returns (du,
    relative residual, iterations)."""
    if md.grid is not None:
        raise ValueError('solve_linear: a flat mesh (femu.flatten_mesh)')
    if cg_tol is None:
        cg_tol = 1.e-11 if elstiff.dtype == torch.float64 else 1.e-6
    if force is None:
        force = torch.zeros_like(bc_val)
    if x0 is None:
        x0 = torch.zeros_like(bc_val)
    return _cg_flat(md, elstiff, bc_val, force, float(cg_tol),
                    int(cg_maxiter), x0)


def _residual_f64_flat(md: MeshData, elstiff, du64, force):
    """True residual ``force - K du`` of the BC-embedded flat system in
    float64, the element stiffnesses of the working dtype upcast exactly;
    zero on fixed rows."""
    f64 = torch.float64
    Ke = element_stiffness(md, elstiff).to(f64)
    fe = torch.einsum('eij,ej->ei', Ke, gather_element(md, du64))
    return torch.where(md.fixed, 0., force.to(f64) - scatter_element(md, fe))


def refine_du_flat(md: MeshData, elstiff, du, bc_val, force, cg_tol,
                   cg_maxiter, n=1):
    """Mixed-precision iterative refinement on flat meshes: the float64
    true residual, the correction re-solved with the same Jacobi-CG in the
    working dtype and accumulated in float64, ``n`` times."""
    du64 = du.to(torch.float64)
    zero = torch.zeros_like(bc_val)
    for _ in range(n):
        r = _residual_f64_flat(md, elstiff, du64, force)
        d, _, _ = _cg_flat(md, elstiff, zero, r.to(du.dtype), float(cg_tol),
                           int(cg_maxiter), zero)
        du64 = du64 + d.to(torch.float64)
    return du64.to(du.dtype)


def element_deps(md: MeshData, du):
    """Element-average strain increments (Nel, 6) from the nodal
    displacement increment ((2, nnX, nnY) planes or flat (Ndof,)); eps_33
    from the ``ps_b2`` rows on multi-material plane-stress meshes."""
    if md.grid is None:
        ue = gather_element(md, du)
        if md.Bsum.dim() == 3:      # per-element B (bars)
            return torch.einsum('eai,ei->ea', md.Bsum, ue)
        deps = torch.einsum('ai,ei->ea', md.Bsum, ue)
        if md.ps_b2 is not None:
            e33 = torch.einsum('ei,ei->e', md.ps_b2.reshape(8, -1).T, ue)
            deps = torch.cat([deps[:, :2], e33[:, None], deps[:, 3:]], 1)
        return deps
    up = _gather_planes(md, _split(du))
    planes = [sum(md.Bsum[a, i] * up[i] for i in range(8)) for a in range(6)]
    if md.ps_b2 is not None:
        planes[2] = sum(md.ps_b2[i] * up[i] for i in range(8))
    return torch.stack(planes, -1).reshape(md.nel, 6)


@profiling.spanned('return_map')
def respond_grouped(md, mat, CV, sig, epl, deps, fast=True, maxiter=12,
                    nsub=1):
    """Batched return map: one chunked ``response_fast`` or, with
    ``fast=False``, the chunked reference-faithful ``response``.  On a
    multi-material mesh (2-D or 3-D) ``mat``/``CV`` are tuples aligned
    with ``md.groups``: the element rows are gathered by ``perm`` into
    the material blocks, each non-empty block runs its own return map,
    and the results return to mesh order as a gather by ``inv_perm``.
    Returns (f, sig, depl, tangent rows)."""
    def one(m, C, s, e, d):
        Cd = torch.as_tensor(C, dtype=sig.dtype, device=sig.device)
        if fast:
            return con.response_fast_chunked(m, (s, e), d, Cd, maxiter, nsub)
        return con.response_chunked(m, (s, e), d, Cd)

    if md.groups is None:
        return one(mat, CV, sig, epl, deps)
    sig_g, epl_g, deps_g = sig[md.perm], epl[md.perm], deps[md.perm]
    parts = [one(mat[k], CV[k], sig_g[a:a + n], epl_g[a:a + n],
                 deps_g[a:a + n])
             for k, (a, n) in enumerate(md.groups) if n]
    return tuple(torch.cat([p[i] for p in parts])[md.inv_perm]
                 for i in range(4))


# -----------------------------------------------------------------
# load step
# -----------------------------------------------------------------
@dataclass
class SolverState:
    u: torch.Tensor          # (2, nnX, nnY) | (Ndof,) flat
    sig: torch.Tensor        # (Nel, 6)
    epl: torch.Tensor        # (Nel, 6)
    eps: torch.Tensor        # (Nel, 6)
    elstiff: torch.Tensor    # (36, NX, NY) tangent planes | (Nel, 6, 6)


def group_stiffness(md, CV, dtype):
    """Elastic stiffness in every element, (36, Nel): ``CV`` everywhere,
    or on a multi-material mesh the group's ``CV[k]`` in its elements."""
    if md.groups is None:
        C = torch.as_tensor(CV, dtype=dtype, device=md.device)
        return C.reshape(36, 1).expand(36, md.nel)
    rows = torch.empty((md.nel, 36), dtype=dtype, device=md.device)
    for k, (a, n) in enumerate(md.groups):
        rows[md.perm[a:a + n]] = torch.as_tensor(
            CV[k], dtype=dtype, device=md.device).reshape(36)
    return rows.T


def init_state(md: MeshData, CV, dtype=DTYPE_DEVICE):
    """Virgin state with the elastic stiffness in every element (``CV``,
    or the groups' tuple on a multi-material mesh): tangent planes (36,
    NX, NY) on a structured mesh, rows (Nel, 6, 6) on a flat one."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=md.device)

    els = group_stiffness(md, CV, dtype)
    els = els.T.reshape(md.nel, 6, 6) if md.grid is None else els.reshape(
        36, *md.grid[:2])
    return SolverState(u=zeros(*md.fixed.shape), sig=zeros(md.nel, 6),
                       epl=zeros(md.nel, 6), eps=zeros(md.nel, 6),
                       elstiff=els)


@profiling.spanned('hierarchy')
def _hier_kes(md: MeshData, elstiff):
    """Per-level stiffness planes (+ dense bottom inverse) of the
    multigrid hierarchy for a tangent field."""
    from pylabfea_tpu_torch.ops import multigrid as mg
    profiling.count('hierarchy_builds')
    return mg.hierarchy_kes(mg.build_hierarchy(md, elstiff, attach_inv=False))


def _mg_solve(md: MeshData, kes, bc_val, force, cg_tol, cg_maxiter, x0):
    """Multigrid-preconditioned CG on K du = force with prescribed ``bc_val``
    on fixed dofs, started from ``x0``.  Returns (du, rel. residual, iters)."""
    from pylabfea_tpu_torch.ops import multigrid as mg
    with profiling.span('hierarchy'):
        profiling.count('hierarchy_builds')
        levels = mg.levels_from_kes(md, kes)
    fix = md.fixed
    du_bc = torch.where(fix, bc_val, 0.)
    neg = torch.stack(st.k_apply(kes[0], du_bc[0], du_bc[1]))
    rhs = torch.where(fix, bc_val, force - neg)
    start = torch.where(fix, bc_val, x0)
    return mg.mg_cg_solve(levels, rhs, start, tol=cg_tol,
                          maxiter=min(cg_maxiter, 100))


def _residual_f64_grid(md: MeshData, M64, elstiff, du64, force):
    """True residual ``force - K du`` of the BC-embedded system in float64
    against the operator of the unrounded geometry ``M64``, the tangent
    field upcast exactly (kernel B in float64 on the card); zero on fixed
    rows."""
    NX, NY = md.grid[:2]
    els = elstiff_planes(md, elstiff).to(torch.float64)
    Kp = (M64 @ els.reshape(36, NX * NY)).reshape(8, 8, NX, NY)
    q = st.k_apply(Kp, du64[0], du64[1])
    return _merge(tuple(torch.where(f, 0., fr.to(torch.float64) - qq)
                        for f, fr, qq in zip(_split(md.fixed),
                                             _split(force), q)))


def refine_du(md: MeshData, kes, elstiff, du, bc_val, force, cg_tol,
              cg_maxiter, n=1):
    """Mixed-precision iterative refinement of a linear-solve result: the
    true residual in float64 against the unrounded operator, the
    correction solved with the SAME hierarchy in the working dtype and
    accumulated in float64, ``n`` times."""
    M64 = md.M64
    du64 = du.to(torch.float64)
    zero = torch.zeros_like(bc_val)
    for _ in range(n):
        r = _residual_f64_grid(md, M64, elstiff, du64, force)
        d, _, _ = _mg_solve(md, kes, zero, r.to(du.dtype), cg_tol,
                            cg_maxiter, zero)
        du64 = du64 + d.to(torch.float64)
    return du64.to(du.dtype)


def _respond_and_update(md: MeshData, state: SolverState, mat, CV, du,
                        fast=True, nsub=4):
    """Return map at the increment ``du`` and the tangent update: element
    stiffnesses whose change exceeds 1e-3 (Frobenius) are replaced.
    Returns (f, sig, depl, elstiff, deps, max change as a 0-d tensor)."""
    deps = element_deps(md, du)
    fy, sig_n, depl_n, grad = respond_grouped(
        md, mat, CV, state.sig, state.epl, deps, fast=fast, maxiter=12,
        nsub=nsub)
    if md.grid is None:
        dst = torch.linalg.norm((state.elstiff - grad).reshape(md.nel, -1),
                                dim=1)
        elstiff = torch.where((dst > 1.e-3)[:, None, None], grad,
                              state.elstiff)
        return fy, sig_n, depl_n, elstiff, deps, rank_max(md, dst.max())
    gP = elstiff_planes(md, grad)
    dst = torch.sqrt(torch.sum((state.elstiff - gP) ** 2, dim=0))
    elstiff = torch.where(dst > 1.e-3, gP, state.elstiff)
    return fy, sig_n, depl_n, elstiff, deps, dst.max()


def _materials_to(mat, dtype):
    """``con.material_to`` of one material or of each of a tuple."""
    if isinstance(mat, (tuple, list)):
        return tuple(con.material_to(m, dtype) for m in mat)
    return con.material_to(mat, dtype)


def commit_f64_response(md: MeshData, state: SolverState, mat, CV, du,
                        fast=True, nsub=4):
    """The float64 commit of a float32 step: the response to the
    increment ``du`` re-integrated from the entering state with the
    float64 copy of the material(s).  Returns float64 (f, sig, depl)."""
    f64 = torch.float64
    return respond_grouped(md, _materials_to(mat, f64), CV,
                           state.sig.to(f64), state.epl.to(f64),
                           element_deps(md, du.to(f64)), fast=fast,
                           maxiter=12, nsub=nsub)[:3]


def _gate_scale(md: MeshData, mat):
    """Normalization of the yield excess in the convergence gate: 1 for
    SVC (dimensionless decision values), the yield strength for analytic
    materials (f = seq - sflow in stress units); per element on a
    multi-material mesh."""
    if not isinstance(mat, (tuple, list)):
        return 1. if mat.is_svc else float(mat.sy)
    scale = torch.ones(md.nel, dtype=md.dtype, device=md.device)
    for (a, n), m in zip(md.groups, mat):
        if not m.is_svc:
            scale[md.perm[a:a + n]] = float(m.sy)
    return scale


@profiling.spanned('load_step')
def load_step_split(md: MeshData, state: SolverState, mat, CV, load_frac,
                    n_inner=2, cg_tol=None, cg_maxiter=100, fast=True,
                    nsub=4, du0=None, gate=False, max_inner=15, kes0=None,
                    dst0=None, n_refine=0, gate_dst_rtol=1e-4,
                    commit_f64=False, commit_faithful=False):
    """One load step: rounds of (MG-CG solve with the current tangent
    field, return map, tangent update), ``n_inner + 1`` of them or, with
    ``gate``, until the convergence gate fires (the JAX
    ``load_step_split``).  A flat mesh (``grid=None``: the 1-D bars of the
    bridge) solves with Jacobi-CG (``solve_linear``) warm-started from the
    last increment, and compares tangents per element row.

    ``du0`` warm-starts the first solve (the previous step's ``diag['du']``
    at equal load fractions); ``kes0``/``dst0`` pass the previous step's
    hierarchy (``diag['kes']``) and its last tangent change
    (``diag['dstiff']``): the hierarchy is rebuilt only when ``dst > 1e-3``
    (the tangent field changed).  In float32 a warm start is used only when
    the tangent did not change (a stale increment stalls f32 CG); float64
    keeps it unconditionally.

    ``gate=True``: iterate (at least ``n_inner + 1`` rounds, at most
    ``max_inner + 1``) until the normalized yield excess is within
    tolerance and the tangent stopped changing: ``dst <= 1e-3`` in
    float64; in float32, where tangents oscillate at the rounding floor,
    ``dst`` against ``gate_dst_rtol * |CV|_F`` with a deep hold (a tenth
    of it) or two holds in a row; ``gate_dst_rtol=0`` takes the absolute
    test in float32 too.  ``n_refine``: that many
    mixed-precision refinement passes after every solve (``refine_du``).  ``commit_f64`` (float32 states): the committed
    stress and plastic strain are the last response recomputed in float64
    from the entering state.  ``commit_faithful``: once the fast phase
    converges (or spends its budget), the same loop continues with the
    reference-faithful return map until the gate fires again, so the
    committed state is the faithful integrator's equilibrium; with
    ``commit_f64`` the float64 commit is faithful too.  Returns (new
    state, diag) with the JAX ``diag`` keys."""
    profiling.count('load_steps')
    bc_val = md.fixed_val * load_frac
    force = md.force * load_frac
    elstiff = state.elstiff
    f64 = elstiff.dtype == torch.float64
    tol = cg_tol if cg_tol is not None else (1.e-11 if f64 else 1.e-6)
    count = (max_inner if gate else n_inner) + 1
    faithful_tail = bool(commit_faithful and fast)
    tail = False
    if gate or faithful_tail:
        # the tangent-stall threshold: absolute in float64, relative to
        # |CV|_F in float32 (its tangents oscillate at the rounding floor
        # far above 1e-3)
        CVs = CV if isinstance(mat, (tuple, list)) else (CV,)
        dst_exit = 1.e-3 if f64 else max(1.e-3, gate_dst_rtol * max(
            float(torch.linalg.norm(torch.as_tensor(c, dtype=md.dtype)))
            for c in CVs))
    strict_abs = f64 or gate_dst_rtol == 0.
    held = False
    du, kes = du0, kes0
    dst = None if dst0 is None else float(dst0)
    cg_hist = []
    converged = False
    i = 0
    total_count = count + (max_inner if faithful_tail else 0)
    while i < total_count:
        profiling.count('rounds')
        if md.grid is None:
            # flat meshes: Jacobi-CG warm-started from the last increment
            du, cg_res, cg_it = solve_linear(md, elstiff, bc_val, force, tol,
                                             cg_maxiter, x0=du)
            if n_refine:
                du = refine_du_flat(md, elstiff, du, bc_val, force, tol,
                                    cg_maxiter, n=n_refine)
        else:
            if kes is None or dst is None or dst > 1.e-3:
                kes = _hier_kes(md, elstiff)
            if du is None:
                x0 = torch.zeros_like(bc_val)
            elif dst is None or f64 or dst <= 1.e-3:
                x0 = du
            else:
                x0 = torch.zeros_like(du)
            du, cg_res, cg_it = _mg_solve(md, kes, bc_val, force, tol,
                                          cg_maxiter, x0)
            if n_refine:
                du = refine_du(md, kes, elstiff, du, bc_val, force, tol,
                               cg_maxiter, n=n_refine)
        cg_hist.append(cg_it)
        fy, sig_n, depl_n, elstiff, deps, dst_t = _respond_and_update(
            md, dataclasses.replace(state, elstiff=elstiff), mat, CV, du,
            fast and not tail, nsub)
        # host read of the tangent change once per round: it decides the
        # next hierarchy rebuild, the warm start and the gate
        dst = profiling.host_read(dst_t, 'dst')
        if tail or (gate and i >= min(n_inner, count - 1)):
            fmax = profiling.host_read(
                rank_max(md, torch.max(fy / _gate_scale(md, mat))), 'gate')
            dst_ok = (dst <= dst_exit) if strict_abs else (
                dst <= 0.1 * dst_exit or (held and dst <= dst_exit))
            if fmax <= yf_tolerance * 1.0001 and dst_ok:
                if faithful_tail and not tail:
                    # fast phase converged: continue with the faithful map
                    tail, held = True, False
                else:
                    converged = True
                    break
            else:
                held = dst <= dst_exit
                if faithful_tail and not tail and i >= count - 1:
                    # fast budget spent unconverged: the commit must still
                    # be faithful
                    tail, held = True, False
        elif faithful_tail and not tail and i == count - 1:
            tail, held = True, False
        i += 1
    if not converged and (gate or tail):
        fmax = profiling.host_read(
            rank_max(md, torch.max(fy / _gate_scale(md, mat))), 'gate')
        if fmax > yf_tolerance * 1.0001:
            warnings.warn(
                f'load_step_split: no convergence of the plasticity '
                f'algorithm within max_inner={max_inner} iterations '
                f'(normalized yield excess {fmax:.3g} > tolerance '
                f'{yf_tolerance:.1e}); reduce the load increment or '
                f'increase nsub', stacklevel=2)
    if commit_f64 and state.sig.dtype == torch.float32:
        # tangents and du stay float32
        dt = state.sig.dtype
        fy, sig_n, depl_n = (x.to(dt) for x in commit_f64_response(
            md, state, mat, CV, du, fast and not commit_faithful, nsub))
    new = SolverState(u=state.u + du, sig=sig_n, epl=state.epl + depl_n,
                      eps=state.eps + deps, elstiff=elstiff)
    diag = {'fy_max': rank_max(md, fy.max()), 'dstiff': dst,
            'cg_res': cg_res, 'cg_iters': cg_it, 'cg_iters_hist': cg_hist,
            'du': du, 'glob_sig': rank_mean(md, sig_n),
            'glob_eps': rank_mean(md, new.eps),
            'glob_epl': rank_mean(md, new.epl), 'kes': kes}
    return new, diag


@profiling.spanned('solve')
def solve_uniaxial(md: MeshData, mat, CV, nsteps=20, n_inner=3,
                   dtype=DTYPE_DEVICE, cg_tol=None, cg_maxiter=2000,
                   fast=True, nsub=4, split=True, gate=False, n_refine=0,
                   commit_faithful=False):
    """Apply the boundary displacement in ``nsteps`` equal increments,
    threading ``du``, the hierarchy and the tangent change from step to
    step; ``gate``, ``n_refine`` and ``commit_faithful`` as in
    ``load_step_split``.  ``split=False`` selects the JAX package's
    monolithic ``load_step``, which exists only to suit XLA's compiler and
    is not ported.  Returns (final state, [(glob_sig, glob_eps,
    glob_epl)])."""
    if not split:
        raise NotImplementedError(
            'solve_uniaxial(split=False): the monolithic load_step is not '
            'ported; load_step_split computes the same step')
    state = init_state(md, CV, dtype=dtype)
    hist = []
    du0 = kes0 = dst0 = None
    for _ in range(nsteps):
        state, diag = load_step_split(
            md, state, mat, CV, 1. / nsteps, n_inner=n_inner, cg_tol=cg_tol,
            cg_maxiter=cg_maxiter, fast=fast, nsub=nsub, du0=du0, kes0=kes0,
            dst0=dst0, gate=gate, n_refine=n_refine,
            commit_faithful=commit_faithful)
        du0, kes0, dst0 = diag['du'], diag['kes'], diag['dstiff']
        hist.append((diag['glob_sig'], diag['glob_eps'], diag['glob_epl']))
    return state, hist
