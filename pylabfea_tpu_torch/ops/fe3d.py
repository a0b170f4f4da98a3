"""3-D structured-grid FE solver on trilinear hex8 elements (subset of
``pylabfea_tpu.ops.fe3d``).

Nodal vectors are per-component (nnX, nnY, nnZ) volumes, carried through
the solvers as tuples; element state is (Nel, 6) in flat element order
e = (ex * NY + ey) * NZ + ez, Voigt order (11, 22, 33, 23, 13, 12) with
engineering shears.  K is never formed: ``u -> K u`` runs over the 36
tangent volumes (36, NX, NY, NZ) through kernel C (``volume.k_apply3``,
the plain version on the CPU) at every grid level.  The linear solve is CG
preconditioned by a rediscretized geometric multigrid V-cycle (2x2x2
tangent averaging, separable full-weighting transfers, Chebyshev
smoothing, exact dense bottom solve); the return map is the
dimension-agnostic ``constitutive.response_fast``.

Ported: single- and multi-material box meshes (``mat_map``, the grouped
return map of the 2-D path with tuples of materials and stiffnesses),
``load_step3`` with its warm start, mid-step hierarchy rebuild and inexact
inner solves, the fast and the reference-faithful (``fast=False``) return
maps, ``solve_uniaxial3``, the element fields as volumes
(``field_volumes``, ``plot_midplane``).

A mesh may hold one rank's element x-planes ``[x0, x1)``
(``parallel.mesh3d.shard_mesh_data3``): the state and the fine tangent
volumes are the rank's block, nodal volumes stay whole.  The fine K-apply
runs kernel C on the block and its x1 - x0 + 1 node planes and all-reduces
the nodal result over the ranks (as does the diagonal); each hierarchy
build all-gathers the fine tangent volumes once and builds the coarse
levels whole on every rank; the step's maxima and means are taken over the
ranks.
"""
import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from pylabfea_tpu_torch.config import DTYPE_DEVICE, resolve_device
from pylabfea_tpu_torch.ops import jtensors as jt
from pylabfea_tpu_torch.ops import volume
from pylabfea_tpu_torch.ops.fe_kernels import _axpy, _dot, _norm, \
    group_stiffness, material_groups, rank_max, rank_mean, respond_grouped
from pylabfea_tpu_torch.ops.multigrid import _restrict_mat
from pylabfea_tpu_torch.ops.volume import CORNERS3 as _CORNERS3
from pylabfea_tpu_torch.ops.volume import hex_B as _hex_B
from pylabfea_tpu_torch.utils import profiling


def _hex_B_modes(lx, ly, lz):
    """Exact parity-mode factorization of the hex8 Gauss sum:
    sum_g B_g^T C B_g = sum_p w_p B_p^T C B_p over the 7 non-empty parity
    monomials p of (xi, eta, zeta), w_p = 8 (1/3)^|p|.  Returns a tuple of
    (B_p (6, 24) nested list, w_p, active strain rows).  Kernel C computes
    B_p u and B_p^T sigma as Walsh-Hadamard transforms of the corner
    values, which is this factorization with the sign pattern of each
    entry made explicit (``csrc/kapply3d.cu``)."""
    L = (lx, ly, lz)
    _ROWS_OF = ((0, 0), (1, 1), (2, 2), (3, 1), (3, 2), (4, 0), (4, 2),
                (5, 0), (5, 1))
    _D_OF = {(0, 0): 0, (1, 1): 1, (2, 2): 2, (3, 1): 2, (3, 2): 1,
             (4, 0): 2, (4, 2): 0, (5, 0): 1, (5, 1): 0}
    Bp = {p: np.zeros((6, 24)) for p in
          ((0, 0, 0),) + tuple(t for t in _CORNERS3 if t != (0, 0, 0))}
    for a, cn in enumerate(_CORNERS3):
        s = [2. * c - 1. for c in cn]
        for (row, comp) in _ROWS_OF:
            d = _D_OF[(row, comp)]
            e1, e2 = [e for e in range(3) if e != d]
            base = 0.25 * s[d] / L[d]
            i = 3 * a + comp
            p0 = [0, 0, 0]
            Bp[tuple(p0)][row, i] += base
            p1 = [0, 0, 0]; p1[e1] = 1
            Bp[tuple(p1)][row, i] += base * s[e1]
            p2 = [0, 0, 0]; p2[e2] = 1
            Bp[tuple(p2)][row, i] += base * s[e2]
            p3 = [0, 0, 0]; p3[e1] = 1; p3[e2] = 1
            Bp[tuple(p3)][row, i] += base * s[e1] * s[e2]
    modes = []
    for p, M in Bp.items():
        if not np.any(M):
            continue
        w = 8. * (1. / 3.) ** sum(p)
        rows = tuple(a for a in range(6) if np.any(M[a]))
        modes.append((M.tolist(), w, rows))
    return tuple(modes)


@dataclass
class MeshData3D:
    """Structured 3-D mesh tensors of the solver (the JAX ``MeshData3D``).
    ``grid`` = (NX, NY, NZ, lx, ly, lz, uniax); nodal fields are (3, nnX,
    nnY, nnZ).  Multi-material meshes carry ``perm``/``inv_perm``/
    ``groups`` as the 2-D ``MeshData`` does (None otherwise).  ``ranks``
    (a ``parallel.distributed.RankMesh``) and ``xr`` = (x0, x1) mark a mesh
    that holds this rank's element x-planes [x0, x1) (``nel`` elements);
    ``grid`` and the nodal fields stay those of the whole box.  ``cache``
    holds what is derived once per mesh object (the coarse-mesh chain,
    transfer matrices); ``dataclasses.replace`` starts a copy with an
    empty one."""
    B: torch.Tensor          # (8, 6, 24) hex8 B matrices at the Gauss points
    Bsum: torch.Tensor       # (6, 24) element-average B
    jacw: torch.Tensor       # 0-d: Gauss weight * |J| (= vel / 8)
    vel: torch.Tensor        # 0-d: element volume
    fixed: torch.Tensor      # (3, nnX, nnY, nnZ) bool displacement mask
    fixed_val: torch.Tensor  # prescribed displacement (unit load)
    force: torch.Tensor      # external force pattern (unit load)
    ndof: int
    nel: int
    grid: tuple
    perm: torch.Tensor = None
    inv_perm: torch.Tensor = None
    groups: tuple = None
    ranks: object = None     # RankMesh of an element-sharded mesh
    xr: tuple = None         # (x0, x1) element x-planes of this rank
    cache: dict = field(default_factory=dict, init=False, repr=False,
                        compare=False)

    @property
    def device(self):
        return self.B.device

    @property
    def dtype(self):
        return self.B.dtype


def make_face_bcs(NX, NY, NZ, xlo=None, xhi=None, ylo=None, yhi=None,
                  zlo=None, zhi=None, nodes=()):
    """Structured-grid BC volumes from face specs.

    Each face spec maps a component (0/1/2 = x/y/z) to ``(bctype, value)``
    with bctype 'disp' or 'force' (TOTAL face force, distributed with the
    product of per-axis end-node-halved weights).  ``nodes`` is an
    iterable of ``(ix, iy, iz, comp, bctype, value)``.  Displacement
    conflicts are first-come in the order xlo, ylo, zlo, xhi, yhi, zhi,
    nodes.  Returns numpy (fixed, fixed_val, force) for a unit load."""
    nnX, nnY, nnZ = NX + 1, NY + 1, NZ + 1
    fixed = np.zeros((3, nnX, nnY, nnZ), dtype=bool)
    fval = np.zeros((3, nnX, nnY, nnZ))
    force = np.zeros((3, nnX, nnY, nnZ))
    sel = {'xlo': (0, slice(None), slice(None)),
           'xhi': (nnX - 1, slice(None), slice(None)),
           'ylo': (slice(None), 0, slice(None)),
           'yhi': (slice(None), nnY - 1, slice(None)),
           'zlo': (slice(None), slice(None), 0),
           'zhi': (slice(None), slice(None), nnZ - 1)}

    def trap(n):
        w = np.ones(n)
        w[0] = w[-1] = 0.5
        return w

    def face_weights(which):
        if which in ('xlo', 'xhi'):
            w = np.outer(trap(nnY), trap(nnZ))
        elif which in ('ylo', 'yhi'):
            w = np.outer(trap(nnX), trap(nnZ))
        else:
            w = np.outer(trap(nnX), trap(nnY))
        return w / w.sum()

    def apply_face(which, spec):
        if not spec:
            return
        ii = sel[which]
        for comp, (bctype, val) in spec.items():
            if bctype == 'disp':
                region = fixed[comp][ii]
                vals = fval[comp][ii]
                vals[~region] = val
                fval[comp][ii] = vals
                fixed[comp][ii] = True
            elif bctype == 'force':
                force[comp][ii] += val * face_weights(which)
            else:
                raise ValueError(f'unknown bctype {bctype!r}')

    for which, spec in (('xlo', xlo), ('ylo', ylo), ('zlo', zlo),
                        ('xhi', xhi), ('yhi', yhi), ('zhi', zhi)):
        apply_face(which, spec)
    for ix, iy, iz, comp, bctype, val in nodes:
        if bctype == 'disp':
            if not fixed[comp, ix, iy, iz]:
                fixed[comp, ix, iy, iz] = True
                fval[comp, ix, iy, iz] = val
        else:
            force[comp, ix, iy, iz] += val
    return fixed, fval, force


def box_mesh(NX, NY, NZ, LX=1., LY=1., LZ=1., uniax='z', eps_tot=0.01,
             dtype=DTYPE_DEVICE, device=None, bc=None, mat_map=None):
    """Structured NX x NY x NZ hex8 mesh.  Default BCs: symmetry rollers on
    the three low faces and the high face of the load axis (``uniax``
    'x' | 'y' | 'z', or 'none') pulled to ``eps_tot`` -- an exact uniaxial
    stress state for a homogeneous material.  ``bc`` (keys xlo/xhi/ylo/
    yhi/zlo/zhi/nodes, see ``make_face_bcs``) replaces the defaults.
    ``fixed_val``/``force`` are unit-load patterns.  ``mat_map`` (NX, NY,
    NZ) material ids 0..n-1 makes a multi-material mesh.  ``device=None``
    is the card."""
    device = resolve_device(device)
    nnX, nnY, nnZ = NX + 1, NY + 1, NZ + 1
    lx, ly, lz = LX / NX, LY / NY, LZ / NZ
    B = _hex_B(lx, ly, lz)
    vel = lx * ly * lz
    if bc is not None:
        fixed, fval, force = make_face_bcs(NX, NY, NZ, **bc)
    else:
        ax = {'x': 0, 'y': 1, 'z': 2}[uniax] if uniax != 'none' else None
        spec = dict(xlo={0: ('disp', 0.)}, ylo={1: ('disp', 0.)},
                    zlo={2: ('disp', 0.)})
        if ax is not None:
            hi = ('xhi', 'yhi', 'zhi')[ax]
            spec[hi] = {ax: ('disp', eps_tot * (LX, LY, LZ)[ax])}
        fixed, fval, force = make_face_bcs(NX, NY, NZ, **spec)

    perm = inv_perm = groups = None
    if mat_map is not None:
        perm, inv_perm, groups = material_groups(mat_map)

    def dev(a, dt=dtype):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=dt, device=device)

    return MeshData3D(B=dev(B), Bsum=dev(B.mean(axis=0)), jacw=dev(vel / 8.),
                      vel=dev(vel), fixed=dev(fixed, torch.bool),
                      fixed_val=dev(fval), force=dev(force),
                      ndof=3 * nnX * nnY * nnZ, nel=NX * NY * NZ,
                      grid=(NX, NY, NZ, lx, ly, lz, uniax),
                      perm=dev(perm, torch.long),
                      inv_perm=dev(inv_perm, torch.long), groups=groups)


# -----------------------------------------------------------------
# volume operators
# -----------------------------------------------------------------
def _split3(v):
    """(3, nnX, nnY, nnZ) -> per-component tuple."""
    return (v[0], v[1], v[2])


def _merge3(t):
    return torch.stack(t, 0)


def element_grid(md: MeshData3D):
    """(NX, NY, NZ) of the mesh's elements: this rank's block (x1 - x0,
    NY, NZ) on an element-sharded mesh."""
    NX, NY, NZ = md.grid[:3]
    return (NX if md.xr is None else md.xr[1] - md.xr[0], NY, NZ)


def _node_block(md: MeshData3D, v):
    """The node planes [x0, x1] of this rank's elements of a nodal volume
    tuple (contiguous views); the whole volumes on an unsharded mesh."""
    if md.xr is None:
        return tuple(v)
    x0, x1 = md.xr
    return tuple(x[x0:x1 + 1] for x in v)


def _assemble(md: MeshData3D, out):
    """A nodal block tuple of this rank's elements -> the whole nodal
    volumes summed over the ranks (one all-reduce); passes through on an
    unsharded mesh."""
    if md.xr is None:
        return out
    x0, x1 = md.xr
    full = out[0].new_zeros(md.fixed.shape)
    full[:, x0:x1 + 1] = torch.stack(out, 0)
    return _split3(md.ranks.all_reduce(full))


def _gather_vols(md: MeshData3D, v):
    """Stacked (24, NX, NY, NZ) element dof volumes of the mesh's
    elements."""
    return torch.stack(volume.gather_vols(_node_block(md, v),
                                          *element_grid(md)), 0)


def _scatter_vols(md: MeshData3D, f24):
    """24 element dof volumes -> whole nodal volume tuple (scatter-add,
    summed over the ranks)."""
    return _assemble(md, volume.scatter_vols(f24, *element_grid(md)))


def elstiff_vols(md: MeshData3D, elstiff):
    """Tangent field in volumes layout (36, NX, NY, NZ); rows (Nel, 6, 6)
    are transposed into contiguous volumes (the layout kernel C takes),
    volumes pass through."""
    if elstiff.dim() == 4 and elstiff.shape[0] == 36:
        return elstiff
    return elstiff.reshape(md.nel, 36).T.contiguous().reshape(
        36, *element_grid(md))


def _k_apply3_raw(md: MeshData3D, Cp, v):
    """K v without BC handling: kernel C on the card, the plain version on
    the CPU (on an element-sharded mesh on this rank's tangent block and
    node planes, all-reduced)."""
    return _assemble(md, volume.k_apply3(Cp, *_node_block(md, v),
                                         *md.grid[3:6]))


def k_apply3_t(md: MeshData3D, Cp, v, fixed):
    """K v on volume tuples with identity rows on fixed dofs."""
    vm = tuple(torch.where(f, 0., x) for f, x in zip(fixed, v))
    out = _k_apply3_raw(md, Cp, vm)
    return tuple(torch.where(f, x, o) for f, x, o in zip(fixed, v, out))


def k_diag3_t(md: MeshData3D, Cp, fixed):
    """Diagonal of K as a volume tuple, 1 on fixed dofs: per-element
    contributions D @ C with D[i, 6 a + b] = jacw sum_g B[g,a,i] B[g,b,i]."""
    D = (md.jacw * torch.einsum('gai,gbi->iab', md.B, md.B)).reshape(24, 36)
    d24 = (D.to(Cp.dtype) @ Cp.reshape(36, -1)).reshape(24,
                                                        *element_grid(md))
    d = _scatter_vols(md, d24)
    return tuple(torch.where(f, 1., x) for f, x in zip(fixed, d))


def element_deps3(md: MeshData3D, du):
    """Element-average strain increments (Nel, 6) of the mesh's elements
    from a whole nodal increment (3, nnX, nnY, nnZ)."""
    up = _gather_vols(md, _split3(du))
    return (md.Bsum @ up.reshape(24, -1)).T


# -----------------------------------------------------------------
# multigrid
# -----------------------------------------------------------------
def coarsen_mesh3(md: MeshData3D):
    """Mesh of the next-coarser level (half resolution).  The coarse BC
    mask is pin-preserving: a coarse node is fixed when any fine node of
    its 3x3x3 prolongation neighbourhood is fixed."""
    NX, NY, NZ, lx, ly, lz, _ = md.grid
    mdc = box_mesh(NX // 2, NY // 2, NZ // 2, LX=lx * NX, LY=ly * NY,
                   LZ=lz * NZ, uniax='none', eps_tot=0., dtype=md.dtype,
                   device=md.device)
    nXc, nYc, nZc = NX // 2 + 1, NY // 2 + 1, NZ // 2 + 1
    fp = torch.zeros((3, NX + 3, NY + 3, NZ + 3), dtype=torch.bool,
                     device=md.device)
    fp[:, 1:-1, 1:-1, 1:-1] = md.fixed
    fc = torch.zeros((3, nXc, nYc, nZc), dtype=torch.bool, device=md.device)
    for di in range(3):
        for dj in range(3):
            for dk in range(3):
                fc = fc | fp[:, di:di + 2 * nXc - 1:2, dj:dj + 2 * nYc - 1:2,
                             dk:dk + 2 * nZc - 1:2]
    return dataclasses.replace(mdc, fixed=fc)


def mesh_chain3(md: MeshData3D, min_size=4):
    """Fine-to-coarse meshes of the hierarchy; built once per mesh object
    (kept in ``md.cache``)."""
    key = ('chain', min_size)
    if key not in md.cache:
        profiling.count('mesh_chain_builds')
        with profiling.span('mesh_chain'):
            chain = [md]
            while True:
                NX, NY, NZ = chain[-1].grid[:3]
                if (NX % 2 or NY % 2 or NZ % 2 or NX // 2 < min_size
                        or NY // 2 < min_size or NZ // 2 < min_size):
                    break
                chain.append(coarsen_mesh3(chain[-1]))
        md.cache[key] = tuple(chain)
    return md.cache[key]


def coarsen_C(Cp):
    """Average the 2x2x2 fine tangent blocks -> coarse tangent volumes
    (the rediscretized coarse operator)."""
    n = Cp.shape
    e = Cp.reshape(36, n[1] // 2, 2, n[2] // 2, 2, n[3] // 2, 2)
    return e.mean(dim=(2, 4, 6))


def _transfer_mats3(md: MeshData3D):
    """(Wx, Wy, Wz) full-weighting factors of the mesh's node grid, built
    once per mesh object."""
    if 'W' not in md.cache:
        md.cache['W'] = tuple(_restrict_mat(n + 1, md.dtype, md.device)
                              for n in md.grid[:3])
    return md.cache['W']


def restrict3(fine, W):
    """Full-weighting restriction on volume tuples: three separable
    products with the fine level's factors ``W``."""
    Wx, Wy, Wz = W
    out = []
    for p in fine:
        q = torch.einsum('Ix,xyz->Iyz', Wx, p)
        q = torch.einsum('Jy,Iyz->IJz', Wy, q)
        out.append(torch.einsum('Kz,IJz->IJK', Wz, q))
    return tuple(out)


def prolong3(coarse, W):
    """Trilinear prolongation, the exact transpose of ``restrict3``."""
    Wx, Wy, Wz = W
    out = []
    for p in coarse:
        q = torch.einsum('Ix,Iyz->xyz', Wx, p)
        q = torch.einsum('Jy,xJz->xyz', Wy, q)
        out.append(torch.einsum('Kz,xyK->xyz', Wz, q))
    return tuple(out)


@dataclass
class MGLevel3:
    """One level: mesh, tangent volumes, Jacobi diagonal and BC mask
    (volume tuples), lambda_max(D^-1 K) estimate of the Chebyshev smoother
    (a 0-d tensor); the coarsest level may carry a dense inverse."""
    md: MeshData3D
    Cp: torch.Tensor
    diag: tuple
    fixed: tuple
    lmax: torch.Tensor
    kc_inv: torch.Tensor = None


#: exact dense bottom solve cap (dofs); a 4^3 grid has 3 * 125 = 375
COARSE_DENSE_MAX3 = 1100


@profiling.spanned('coarse_inverse')
def _dense_coarse_inv3(level: MGLevel3):
    """Dense SPD pseudo-inverse of the coarsest-level operator (identity
    rows on fixed dofs): equilibrated eigendecomposition with
    small-eigenvalue clipping.  The matrix is assembled by applying the
    operator to every unit vector at once (one batched plain apply on a
    grid of at most ``COARSE_DENSE_MAX3`` dofs)."""
    md = level.md
    NX, NY, NZ = md.grid[:3]
    nn = (NX + 1, NY + 1, NZ + 1)
    m = nn[0] * nn[1] * nn[2]
    n = 3 * m
    eye = torch.eye(n, dtype=level.Cp.dtype, device=level.Cp.device)
    v = tuple(eye[:, c * m:(c + 1) * m].reshape(n, *nn) for c in range(3))
    vm = tuple(torch.where(f, 0., x) for f, x in zip(level.fixed, v))
    out = volume.k_apply3_plain(level.Cp, *vm, *md.grid[3:6])
    o = tuple(torch.where(f, x, y) for f, x, y in zip(level.fixed, v, out))
    K = torch.cat([x.reshape(n, m) for x in o], dim=1)
    s = torch.rsqrt(torch.clamp(torch.diagonal(K), min=1e-30))
    Ks = s[:, None] * K * s[None, :]
    # symmetrize as jnp.linalg.eigh does with its input
    w, V = torch.linalg.eigh(0.5 * (Ks + Ks.T))
    rel = 1e-11 if K.dtype == torch.float64 else 3e-6
    cut = rel * torch.clamp(torch.max(torch.abs(w)), min=1e-30)
    winv = torch.where(w > cut, 1. / torch.where(w > cut, w, 1.), 0.)
    SV = s[:, None] * V
    return (SV * winv[None, :]) @ SV.T


def _make_level3(md: MeshData3D, Cp, lmax=None):
    """Level record with a 10-step power-iteration estimate of
    lambda_max(D^-1 K) for the Chebyshev smoother (point Jacobi is not a
    safe 3-D smoother: lambda_max ~ 2.91 puts omega = 0.7 above its
    stability bound).  ``lmax`` from an earlier hierarchy on the same mesh
    skips the power iteration (the mid-step rebuild: plastification
    softens the tangent, and the entering estimate already carries the
    1.1x safety margin of ``_smooth3``)."""
    fixT = _split3(md.fixed)
    diag = k_diag3_t(md, Cp, fixT)
    if lmax is not None:
        return MGLevel3(md, Cp, diag, fixT, lmax)
    nn = (md.grid[0] + 1, md.grid[1] + 1, md.grid[2] + 1)
    i = torch.arange(nn[0] * nn[1] * nn[2], dtype=Cp.dtype,
                     device=Cp.device).reshape(nn)
    v = tuple(torch.sin(i * (0.37 + 0.11 * c)) + 0.01 for c in range(3))
    minv = tuple(1. / d for d in diag)
    for _ in range(10):
        w = k_apply3_t(md, Cp, v, fixT)
        w = tuple(m * x for m, x in zip(minv, w))
        nrm = torch.clamp(_norm(w), min=1e-30)
        v = tuple(x / nrm for x in w)
    Av = k_apply3_t(md, Cp, v, fixT)
    Av = tuple(m * x for m, x in zip(minv, Av))
    lmax = _dot(v, Av) / torch.clamp(_dot(v, v), min=1e-30)
    return MGLevel3(md, Cp, diag, fixT, lmax)


@profiling.spanned('hierarchy')
def build_hierarchy3(md: MeshData3D, elstiff, min_size=4, lmax_from=None):
    """Level list (fine -> coarse) for the current tangent field.
    ``lmax_from`` reuses the per-level lambda_max of an earlier hierarchy
    on the same mesh (see ``_make_level3``)."""
    profiling.count('hierarchy_builds')
    chain = mesh_chain3(md, min_size)
    levels = []
    Cp = elstiff_vols(md, elstiff)
    # the coarse levels are built whole on every rank of an element-sharded
    # mesh from the gathered fine tangent volumes
    whole = _whole_vols(md, Cp)
    for i, cur_md in enumerate(chain):
        prev = lmax_from[i].lmax if lmax_from is not None else None
        levels.append(_make_level3(cur_md, Cp, lmax=prev))
        Cp = whole = coarsen_C(whole) if i + 1 < len(chain) else whole
    bot = levels[-1]
    NX, NY, NZ = bot.md.grid[:3]
    if 3 * (NX + 1) * (NY + 1) * (NZ + 1) <= COARSE_DENSE_MAX3:
        bot.kc_inv = _dense_coarse_inv3(dataclasses.replace(bot, Cp=whole))
    return levels


def _whole_vols(md: MeshData3D, Cp):
    """The whole (36, NX, NY, NZ) tangent volumes from every rank's
    x-block (position order, one exchange); ``Cp`` on an unsharded
    mesh."""
    if md.xr is None:
        return Cp
    blocks = md.ranks.exchange(Cp.contiguous())
    return torch.cat(tuple(blocks), 1).contiguous()


def _smooth3(level: MGLevel3, x, b, nu, zero_start=False):
    """Degree-``nu`` Chebyshev smoothing of K x = b: a polynomial in
    D^-1 K on [lmax/4, lmax] with the level's lambda_max estimate.
    ``zero_start=True`` asserts x == 0 so the first residual needs no
    apply."""
    minv = tuple(1. / d for d in level.diag)
    lmax = 1.1 * level.lmax
    lmin = lmax / 4.
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    if zero_start:
        r = b
    else:
        Kx = k_apply3_t(level.md, level.Cp, x, level.fixed)
        r = tuple(bi - ki for bi, ki in zip(b, Kx))
    d = tuple(m * ri / theta for m, ri in zip(minv, r))
    rho = 1. / sigma
    for _ in range(max(nu, 1)):
        x = tuple(xi + di for xi, di in zip(x, d))
        Kd = k_apply3_t(level.md, level.Cp, d, level.fixed)
        r = tuple(torch.where(f, 0., ri - ki)
                  for f, ri, ki in zip(level.fixed, r, Kd))
        rho_new = 1. / (2. * sigma - rho)
        d = tuple(rho_new * rho * di + 2. * rho_new / delta * m * ri
                  for di, m, ri in zip(d, minv, r))
        rho = rho_new
    return x


def v_cycle3(levels, b, lvl=0, nu=2):
    """One symmetric V-cycle (zero initial guess) on volume tuples."""
    level = levels[lvl]
    fix = level.fixed
    b = tuple(torch.where(f, 0., bi) for f, bi in zip(fix, b))
    zero = tuple(torch.zeros_like(bi) for bi in b)
    if lvl == len(levels) - 1:
        if level.kc_inv is not None:
            nn = b[0].shape
            m = b[0].numel()
            x = level.kc_inv @ torch.cat([bi.reshape(-1) for bi in b])
            return tuple(x[c * m:(c + 1) * m].reshape(nn) for c in range(3))
        return _smooth3(level, zero, b, 8 * nu, zero_start=True)
    x = _smooth3(level, zero, b, nu, zero_start=True)
    Kx = k_apply3_t(level.md, level.Cp, x, fix)
    r = tuple(torch.where(f, 0., bi - ki) for f, bi, ki in zip(fix, b, Kx))
    W = _transfer_mats3(level.md)
    ec = v_cycle3(levels, restrict3(r, W), lvl + 1, nu)
    ec = tuple(torch.where(f, 0., ei)
               for f, ei in zip(levels[lvl + 1].fixed, ec))
    e = prolong3(ec, W)
    x = tuple(xi + torch.where(f, 0., ei) for xi, f, ei in zip(x, fix, e))
    return _smooth3(level, x, b, nu)


@profiling.spanned('cg')
def mg_cg_solve3(levels, b, x0, tol=1.e-8, maxiter=200, nu=2,
                 Cp_apply=None):
    """CG with a V-cycle preconditioner on volume tuples.

    ``Cp_apply`` supplies the current tangent volumes for the Krylov
    operator while ``levels`` precondition with a possibly stale hierarchy
    (staleness costs iterations, never correctness).  Exits at
    ``|r| <= tol |b|``, at ``maxiter``, or (float32 only) after 4
    consecutive iterations below 1e-3 relative that improve the best
    residual by less than 5%.  Returns (x, relative residual, iterations)."""
    level = levels[0]
    fix = level.fixed
    Cp_op = level.Cp if Cp_apply is None else Cp_apply

    def apply_fn(v):
        return k_apply3_t(level.md, Cp_op, v, fix)

    Ax0 = apply_fn(x0)
    r = tuple(torch.where(f, 0., bi - ai) for f, bi, ai in zip(fix, b, Ax0))
    bnorm = max(profiling.host_read(_norm(b), 'cg'), 1e-30)
    b_f32 = r[0].dtype == torch.float32
    x, p, rz_prev = x0, None, None
    it, nstall = 0, 0
    rn = best = profiling.host_read(_norm(r), 'cg')
    while rn > tol * bnorm and it < maxiter and nstall < 4:
        z = v_cycle3(levels, r, nu=nu)
        rz = _dot(r, z)
        p = z if it == 0 else _axpy(rz / rz_prev, p, z)
        Ap = apply_fn(p)
        alpha = rz / _dot(p, Ap)
        x = _axpy(alpha, p, x)
        r = tuple(torch.where(f, 0., ri - alpha * ai)
                  for f, ri, ai in zip(fix, r, Ap))
        # host read of the residual norm once per iteration (the exit test)
        rn = profiling.host_read(_norm(r), 'cg')
        if b_f32:
            if rn < 0.95 * best:
                nstall = 0
            elif rn < 1e-3 * bnorm:
                nstall += 1
        best = min(best, rn)
        rz_prev = rz
        it += 1
    profiling.count('cg_solves')
    profiling.count('cg_iters', it)
    return x, rn / bnorm, it


# -----------------------------------------------------------------
# solver
# -----------------------------------------------------------------
@dataclass
class SolverState3:
    u: torch.Tensor          # (3, nnX, nnY, nnZ)
    sig: torch.Tensor        # (Nel, 6)
    epl: torch.Tensor        # (Nel, 6)
    eps: torch.Tensor        # (Nel, 6)
    elstiff: torch.Tensor    # (36, NX, NY, NZ) tangent volumes


def init_state3(md: MeshData3D, CV, dtype=DTYPE_DEVICE):
    """Virgin state with the elastic stiffness in every element (``CV``,
    or the groups' tuple on a multi-material mesh), materialized: kernel C
    takes contiguous tangent volumes."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=md.device)

    return SolverState3(
        u=zeros(*md.fixed.shape), sig=zeros(md.nel, 6),
        epl=zeros(md.nel, 6), eps=zeros(md.nel, 6),
        elstiff=group_stiffness(md, CV, dtype).reshape(
            36, *element_grid(md)).contiguous())


#: the return map is dimension-agnostic: the 2-D grouped dispatch serves
#: the 3-D mesh's groups
respond_grouped3 = respond_grouped


@profiling.spanned('load_step')
def load_step3(md: MeshData3D, state: SolverState3, mat, CV, load_frac,
               n_inner=2, cg_tol=None, cg_maxiter=100, fast=True, nsub=4,
               du0=None, rebuild_mid=True, cg_tol_inner=None):
    """One incremental load step: elastic predictor + ``n_inner``
    secant-Picard equilibrium iterations, each an MG-CG solve with the
    current tangent volumes, the batched return map (``fast=False``: the
    reference-faithful one) and a change-gated tangent update (the JAX
    ``load_step3``).  Multi-material meshes take tuples ``mat``/``CV``.

    The hierarchy is built from the entering tangent field and, with
    ``rebuild_mid``, rebuilt once after the first inner iteration, reusing
    the entering lambda_max estimates.  Non-final solves run at
    ``cg_tol_inner`` (default ``max(cg_tol, 3e-5)`` in f32, ``1e-9`` in
    f64); the committed increment comes from the final solve at
    ``cg_tol``.  ``du0`` warm-starts the first solve.  Returns (new state,
    diag) with the JAX ``diag`` keys."""
    profiling.count('load_steps')
    f64 = state.u.dtype == torch.float64
    if cg_tol is None:
        cg_tol = 1.e-11 if f64 else 1.e-6
    if cg_tol_inner is None:
        cg_tol_inner = max(cg_tol, 1.e-9 if f64 else 3.e-5)
    if du0 is None:
        du0 = torch.zeros_like(state.u)
    fixT = _split3(md.fixed)
    bcT = _split3(md.fixed_val * load_frac)
    frcT = _split3(md.force)
    levels = build_hierarchy3(md, state.elstiff)

    def solve_with(levels, elstiff, x0, tol):
        Cp = elstiff_vols(md, elstiff)
        du_bc = tuple(torch.where(f, b, 0.) for f, b in zip(fixT, bcT))
        neg = _k_apply3_raw(md, Cp, du_bc)
        rhs = tuple(torch.where(f, b, fr * load_frac - q)
                    for f, b, fr, q in zip(fixT, bcT, frcT, neg))
        x0 = tuple(torch.where(f, b, x) for f, b, x in zip(fixT, bcT, x0))
        duT, res, it = mg_cg_solve3(levels, rhs, x0, tol=tol,
                                    maxiter=cg_maxiter, Cp_apply=Cp)
        return _merge3(duT), res, it

    def inner(levels, elstiff, du_prev, tol):
        du, cg_res, cg_it = solve_with(levels, elstiff, _split3(du_prev),
                                       tol)
        deps = element_deps3(md, du)
        fy, sig_n, depl_n, grad = respond_grouped3(
            md, mat, CV, state.sig, state.epl, deps, fast=fast, maxiter=12,
            nsub=nsub)
        gP = elstiff_vols(md, grad)
        dst = torch.sqrt(torch.sum((elstiff - gP) ** 2, dim=0))
        elstiff = torch.where(dst > 1.e-3, gP, elstiff)
        return elstiff, (du, fy, sig_n, depl_n, rank_max(md, dst.max()),
                         cg_res, cg_it)

    elstiff, du = state.elstiff, du0
    outs = []
    tols = [cg_tol_inner] * n_inner + [cg_tol]
    for k, tol in enumerate(tols):
        profiling.count('rounds')
        if k == 1 and rebuild_mid:
            levels = build_hierarchy3(md, elstiff, lmax_from=levels)
        elstiff, out = inner(levels, elstiff, du, tol)
        du = out[0]
        outs.append(out)
    du, fy, sig_n, depl_n, _, cg_res, cg_it = outs[-1]
    deps = element_deps3(md, du)
    new = SolverState3(u=state.u + du, sig=sig_n, epl=state.epl + depl_n,
                       eps=state.eps + deps, elstiff=elstiff)
    diag = {'fy_max': rank_max(md, fy.max()),
            'dstiff': torch.stack([o[4] for o in outs]),
            'cg_res': cg_res, 'cg_iters': cg_it,
            'cg_iters_hist': [o[6] for o in outs], 'du': du,
            'glob_sig': rank_mean(md, new.sig),
            'glob_eps': rank_mean(md, new.eps),
            'glob_epl': rank_mean(md, new.epl)}
    return new, diag


@profiling.spanned('solve')
def solve_uniaxial3(md: MeshData3D, mat, CV, nsteps=10, n_inner=2,
                    dtype=None, nsub=4, cg_maxiter=100):
    """``nsteps`` equal load fractions up to the mesh's unit-load BC
    pattern, each step warm-started from the previous increment.  Returns
    (final state, [(glob_sig, glob_eps, cg_iters)])."""
    if dtype is None:
        dtype = md.fixed_val.dtype
    state = init_state3(md, CV, dtype=dtype)
    hist = []
    du0 = torch.zeros_like(state.u)
    for i in range(1, nsteps + 1):
        frac = i / nsteps - (i - 1) / nsteps
        state, diag = load_step3(md, state, mat, CV, frac, n_inner=n_inner,
                                 nsub=nsub, cg_maxiter=cg_maxiter, du0=du0)
        du0 = diag['du']
        hist.append((diag['glob_sig'], diag['glob_eps'], diag['cg_iters']))
    return state, hist


# -----------------------------------------------------------------
# post-processing
# -----------------------------------------------------------------
def field_volumes(md: MeshData3D, state: SolverState3):
    """Element fields as (NX, NY, NZ) volumes (this rank's block on an
    element-sharded mesh), on the state's device: 'seq' (J2 equivalent
    stress), 'peeq' (equivalent plastic strain) and the Voigt components
    'sig_i', 'eps_i', 'epl_i' (the JAX ``field_volumes``)."""
    shape = element_grid(md)
    out = {'seq': jt.seq_j2_voigt(state.sig).reshape(shape),
           'peeq': jt.eps_eq(state.epl).reshape(shape)}
    for k in range(6):
        out[f'sig_{k}'] = state.sig[:, k].reshape(shape)
        out[f'eps_{k}'] = state.eps[:, k].reshape(shape)
        out[f'epl_{k}'] = state.epl[:, k].reshape(shape)
    return out


def plot_midplane(md: MeshData3D, state: SolverState3, sel='seq', axis='y',
                  index=None, ax=None, show=True):
    """The mid-plane (or ``index``-plane) slice normal to ``axis`` ('x',
    'y' or 'z') of the element field ``sel`` of ``field_volumes``, drawn
    with matplotlib (imported here: the card's hosts may lack it).
    Returns the axes."""
    import matplotlib.pyplot as plt
    vols = field_volumes(md, state)
    if sel not in vols:
        raise ValueError(f'unknown field {sel!r}; one of {sorted(vols)}')
    v = vols[sel].detach().cpu().numpy()
    axn = {'x': 0, 'y': 1, 'z': 2}[axis]
    if index is None:
        index = v.shape[axn] // 2
    sl = np.take(v, index, axis=axn)
    if ax is None:
        _, ax = plt.subplots()
    im = ax.imshow(sl.T, origin='lower', cmap='viridis')
    plt.colorbar(im, ax=ax, label=sel)
    rest = [a for a in 'xyz' if a != axis]
    ax.set_xlabel(rest[0])
    ax.set_ylabel(rest[1])
    ax.set_title(f'{sel}, {axis} = plane {index}')
    if show:
        plt.show()
    return ax
