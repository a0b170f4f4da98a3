"""Domain-decomposed 3-D FE solver over ``torch.distributed``: x-slabs
with a one-plane halo exchange (the port of
``pylabfea_tpu.parallel.sharded3``, the 3-D lift of ``parallel.sharded``).

Slab position r holds element layers [r NXd, (r+1) NXd) and node layers
[r NXd, r NXd + NXd]; the last plane is shared with position r+1 and
duplicated on both.  Nodal vectors are tuples of per-component (NXd+1,
nnY, nnZ) volumes, the tangent field this slab's (36, NXd, NY, NZ)
volumes, element rows (NXd NY NZ, ...) in the slab-local raster order
(ex NY + ey) NZ + ez, a contiguous row range of the global one.

Every slab-local apply, diagonal, strain and hierarchy is the single-grid
``ops.fe3d`` one on the slab's ``MeshData3D`` template: the apply is
kernel C on the card (JAX keeps its Pallas kernel off here only because
``shard_map`` cannot partition it) and its plain version on the CPU.  The
CG (``make_slab_cg3``) is preconditioned by the slab-local Chebyshev
V-cycle, Dirichlet at interior interfaces (additive Schwarz), built once a
solve, plus the optional coarse correction of a slab-spanning trilinear
coarse space (``build_coarse_inv3``), built once a load step.
"""
import numpy as np
import torch

from pylabfea_tpu_torch.config import DTYPE_DEVICE, resolve_device
from pylabfea_tpu_torch.ops import fe3d
from pylabfea_tpu_torch.parallel.distributed import global_strip_mesh
from pylabfea_tpu_torch.parallel.sharded import _Block, _halo_accumulate, \
    coarse_weights_1d, coarse_weights_x, respond_elements


class SlabMesh3(_Block):
    """This rank's x-slab of a structured NX x NY x NZ hex8 box (the JAX
    ``SlabMesh3``).  ``mesh`` is the ``RankMesh`` (default
    ``global_strip_mesh()``), ``device=None`` the card; BCs are the face
    spec ``bc`` of ``fe3d.make_face_bcs`` or the uniaxial-stress defaults
    of ``fe3d.box_mesh``; ``mat_map`` (NX, NY, NZ) material ids."""

    def __init__(self, NX, NY, NZ, LX=1., LY=1., LZ=1., uniax='z',
                 eps_tot=0.01, mesh=None, dtype=DTYPE_DEVICE, device=None,
                 bc=None, mat_map=None):
        mesh = global_strip_mesh() if mesh is None else mesh
        D = mesh.size
        if NX % D:
            raise ValueError(f'NX={NX} must be divisible by {D} ranks')
        device = resolve_device(device)
        self.mesh, self.D, self.pos = mesh, D, mesh.pos
        self.NX, self.NY, self.NZ = NX, NY, NZ
        self.NXd = NX // D
        self.nnY, self.nnZ = NY + 1, NZ + 1
        self.dtype, self.device = dtype, device
        # the slab-local single-grid template of every local operator (its
        # BC fields are unused: the slab masks below replace them)
        self.md_loc = fe3d.box_mesh(self.NXd, NY, NZ, LX=LX * self.NXd / NX,
                                    LY=LY, LZ=LZ, uniax='none', eps_tot=0.,
                                    dtype=dtype, device=device)
        if bc is not None:
            gfix, gval, gforce = fe3d.make_face_bcs(NX, NY, NZ, **bc)
        else:
            spec = dict(xlo={0: ('disp', 0.)}, ylo={1: ('disp', 0.)},
                        zlo={2: ('disp', 0.)})
            if uniax != 'none':
                ax = {'x': 0, 'y': 1, 'z': 2}[uniax]
                spec[('xhi', 'yhi', 'zhi')[ax]] = {
                    ax: ('disp', eps_tot * (LX, LY, LZ)[ax])}
            gfix, gval, gforce = fe3d.make_face_bcs(NX, NY, NZ, **spec)
        lay = slice(self.pos * self.NXd, self.pos * self.NXd + self.NXd + 1)

        def slab(g, dt):
            return tuple(torch.as_tensor(np.asarray(g)[c, lay], dtype=dt,
                                         device=device) for c in range(3))

        self.fixed = slab(gfix, torch.bool)
        self.fixed_val = slab(gval, dtype)
        self.force = slab(gforce, dtype)
        own = torch.ones((self.NXd + 1, self.nnY, self.nnZ), dtype=dtype,
                         device=device)
        if self.pos < D - 1:
            own[-1] = 0.    # the shared plane counts on the right slab only
        self.own = (own, own, own)
        self.mat_ids_global = None if mat_map is None else np.asarray(
            mat_map, dtype=np.int64).reshape(-1)
        self.mat_ids = None if mat_map is None else torch.as_tensor(
            self._rows(self.mat_ids_global), device=device)
        self._schwarz_md = None

    @property
    def nel_loc(self):
        return self.NXd * self.NY * self.NZ

    def _rows(self, a):
        return a[self.pos * self.nel_loc:(self.pos + 1) * self.nel_loc]

    def zeros_u(self):
        return tuple(torch.zeros((self.NXd + 1, self.nnY, self.nnZ),
                                 dtype=self.dtype, device=self.device)
                     for _ in range(3))

    def shard_elements(self, arr_global):
        """(Nel, ...) global element array -> this slab's (nel_loc, ...)
        rows in the mesh dtype."""
        a = torch.as_tensor(arr_global, dtype=self.dtype)
        return self._rows(a).contiguous().to(self.device)

    def elstiff_blocks(self, CV):
        """This slab's initial (36, NXd, NY, NZ) tangent volumes from one
        elastic stiffness (6, 6) or global per-element rows (Nel, 6, 6)."""
        CV = np.asarray(CV, dtype=np.float64)
        rows = np.broadcast_to(CV, (self.nel_loc, 6, 6)) if CV.ndim == 2 \
            else self._rows(CV)
        vols = np.ascontiguousarray(rows.reshape(self.nel_loc, 36).T)
        return torch.as_tensor(vols.reshape(36, self.NXd, self.NY, self.NZ),
                               dtype=self.dtype, device=self.device)


def _coarse_weights3(sm: SlabMesh3, nyc=None, nzc=None):
    """Separable trilinear weights of the slab-spanning coarse space:
    coarse x-nodes at the slab interfaces (D+1), ``nyc``/``nzc`` coarse
    y/z nodes.  Returns (Wx (NXd+1, D+1) of this slab, Wy, Wz, nyc,
    nzc)."""
    nyc = min(sm.nnY, 5) if nyc is None else min(sm.nnY, nyc)
    nzc = min(sm.nnZ, 5) if nzc is None else min(sm.nnZ, nzc)

    def ten(a):
        return torch.as_tensor(a, dtype=sm.dtype, device=sm.device)
    return (ten(coarse_weights_x(sm.D, sm.NXd, sm.pos)),
            ten(coarse_weights_1d(sm.nnY, nyc)),
            ten(coarse_weights_1d(sm.nnZ, nzc)), nyc, nzc)


def _restrict3(W, v):
    """(D+1, nyc, nzc, 3) coarse vector of a volume tuple, flattened."""
    Wx, Wy, Wz = W
    return torch.stack([torch.einsum('ja,kb,lc,jkl->abc', Wx, Wy, Wz, x)
                        for x in v], -1).reshape(-1)


def _prolong3(W, c, fixed):
    """Volume tuple of a flat coarse vector, zero on ``fixed`` dofs; the
    x-interpolation elementwise, so a duplicated plane comes out bitwise
    alike on both slabs (``sharded._prolong``)."""
    Wx, Wy, Wz = W
    c = c.reshape(Wx.shape[1], Wy.shape[1], Wz.shape[1], 3)
    out = []
    for d, f in enumerate(fixed):
        T = torch.einsum('kb,lc,abc->akl', Wy, Wz, c[..., d])
        out.append(torch.where(f, 0., sum(Wx[:, a, None, None] * T[a]
                                          for a in range(Wx.shape[1]))))
    return tuple(out)


def build_coarse_inv3(sm: SlabMesh3, C_loc, nyc=None, nzc=None, batch=32):
    """Dense inverse of the Galerkin coarse operator Kc = P^T K P of the
    slab-spanning coarse space: the coarse basis functions that live on
    the slab (those of its two boundary x-nodes; the other rows of its
    share are zero), ``batch`` at a time, through the slab-local apply
    (kernel C on the card, a launch each), summed over the ranks; coarse
    dofs without support replaced by identity rows.  Returns (Kc_inv, W =
    (Wx, Wy, Wz))."""
    Wx, Wy, Wz, nyc, nzc = _coarse_weights3(sm, nyc, nzc)
    nc = (sm.D + 1) * nyc * nzc * 3
    per = nyc * nzc * 3
    fixed = torch.stack(sm.fixed)
    eye = torch.eye(nc, dtype=sm.dtype, device=sm.device)
    Kc = torch.zeros((nc, nc), dtype=sm.dtype, device=sm.device)
    for e0 in range(sm.pos * per, (sm.pos + 2) * per, batch):
        e1 = min(e0 + batch, (sm.pos + 2) * per)
        c = eye[e0:e1].reshape(-1, sm.D + 1, nyc, nzc, 3)
        V = torch.where(fixed, 0., torch.einsum('ja,kb,lc,mabcd->mdjkl', Wx,
                                                 Wy, Wz, c))
        out = fe3d._k_apply3_raw(sm.md_loc, C_loc, tuple(
            V[:, d].contiguous() for d in range(3)))
        out = torch.where(fixed, 0., torch.stack(out, 1))
        Kc[e0:e1] = torch.einsum('ja,kb,lc,mdjkl->mabcd', Wx, Wy, Wz,
                                 out).reshape(e1 - e0, nc)
    Kc = sm.mesh.all_reduce(Kc)
    dKc = torch.diagonal(Kc)
    bad = dKc <= 1e-10 * torch.max(dKc)
    Kc = torch.where(bad[:, None] | bad[None, :], 0., Kc)
    Kc = Kc + torch.diag(bad.to(Kc.dtype))
    return torch.linalg.inv(Kc), (Wx, Wy, Wz)


def make_slab_cg3(sm: SlabMesh3, two_level=True, nu=2):
    """Preconditioned CG on the slab-decomposed operator (the JAX
    ``make_slab_cg3``): a trip exchanges the K-apply's halo planes, sums
    the dots over the ranks and reads the residual norm on the host once.
    The preconditioner is the slab-local Chebyshev V-cycle (Dirichlet at
    interior interfaces, a Jacobi patch on them), built once a solve,
    plus (``two_level``) the coarse correction P Kc^-1 P^T r.

    Returns ``solve(C_loc, rhs, x0, coarse, tol=1e-8, maxiter=400) -> (x,
    relative residual, iterations)``; ``coarse`` is ``build_coarse_inv3``'s
    pair (ignored without ``two_level``).  Exits at ``|r| <= tol |b|``, at
    ``maxiter`` or, in float32, after 4 trips below 1e-3 relative that
    improve the best residual by less than 5%."""
    md_loc = sm.md_loc
    gfix, own = sm.fixed, sm.own
    fix_loc = sm.local_fixed()

    def gdot(a, b):
        return sm.mesh.sum(sum(torch.sum(x * y * w)
                               for x, y, w in zip(a, b, own)))

    def solve(C_loc, rhs, x0, coarse=None, tol=1e-8, maxiter=400):
        def A(v):
            vm = tuple(torch.where(f, 0., x) for f, x in zip(gfix, v))
            out = _halo_accumulate(sm, list(fe3d._k_apply3_raw(md_loc,
                                                                C_loc, vm)))
            return tuple(torch.where(f, x, o)
                         for f, x, o in zip(gfix, v, out))

        levels = fe3d.build_hierarchy3(sm.schwarz_mesh(), C_loc)
        diag = _halo_accumulate(sm, list(fe3d.k_diag3_t(md_loc, C_loc,
                                                         gfix)))

        def M(r):
            rm = tuple(torch.where(f, 0., x) for f, x in zip(fix_loc, r))
            z = fe3d.v_cycle3(levels, rm, nu=nu)
            # the Jacobi patch on the interfaces; on globally fixed dofs
            # (r = 0 there) it gives the exact 0 where the V-cycle's dense
            # bottom inverse leaves round-off
            z = tuple(torch.where(f, x / d, y)
                      for f, x, d, y in zip(fix_loc, r, diag, z))
            if two_level:
                Kc_inv, W = coarse
                rm2 = tuple(torch.where(f, 0., x) * w
                            for f, x, w in zip(gfix, r, own))
                rc = sm.mesh.all_reduce(_restrict3(W, rm2))
                zc = _prolong3(W, Kc_inv @ rc, gfix)
                z = tuple(a + b for a, b in zip(z, zc))
            return z

        r = tuple(torch.where(f, 0., b - a)
                  for f, b, a in zip(gfix, rhs, A(x0)))
        bnorm = max(float(torch.sqrt(gdot(rhs, rhs))), 1e-30)
        b_f32 = r[0].dtype == torch.float32
        x, p, rz_prev, it, nstall = x0, None, None, 0, 0
        rn = best = float(torch.sqrt(gdot(r, r)))
        while rn > tol * bnorm and it < maxiter and nstall < 4:
            z = M(r)
            rz = gdot(r, z)
            p = z if it == 0 else tuple(zi + (rz / rz_prev) * pi
                                        for zi, pi in zip(z, p))
            Ap = A(p)
            alpha = rz / gdot(p, Ap)
            x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
            r = tuple(torch.where(f, 0., ri - alpha * ai)
                      for f, ri, ai in zip(gfix, r, Ap))
            # host read of the residual norm once per trip (the exit test)
            rn = float(torch.sqrt(gdot(r, r)))
            if b_f32:
                if rn < 0.95 * best:
                    nstall = 0
                elif rn < 1e-3 * bnorm:
                    nstall += 1
            best = min(best, rn)
            rz_prev = rz
            it += 1
        return x, rn / bnorm, it

    return solve


def make_deps3(sm: SlabMesh3):
    """``deps_of(du)``: element strain increments (nel_loc, 6) of this
    slab from its displacement increment volumes."""
    def deps_of(du):
        return fe3d.element_deps3(sm.md_loc, torch.stack(du, 0))
    return deps_of


def slab_load_step3(sm: SlabMesh3, C_loc, sig, epl, mat, load_frac=1.0,
                    n_inner=2, cg_tol=None, nsub=4, CVs=None,
                    two_level=True):
    """One incremental load step on the slab-decomposed box (the JAX
    ``slab_load_step3``): CG solve, element-local return map (no
    communication), change-gated tangent update (1e-3), re-solve warm
    started from the last increment, ``n_inner`` times; the final response
    and a last tangent update (the tangents carried into the next step, as
    ``fe3d.load_step3``).  ``C_loc`` is this slab's (36, NXd, NY, NZ)
    tangent volumes, ``sig``/``epl`` its (nel_loc, 6) rows; multi-material
    slabs take tuples ``mat``/``CVs`` and run one masked pass a material.
    ``cg_tol`` defaults to 1e-11 in float64, 1e-6 in float32.  Returns
    (sig, epl, du, diag) with ``cg_res``, ``cg_iters``, ``du``,
    ``elstiff`` and the global means ``glob_sig``, ``glob_eps``,
    ``glob_epl``."""
    dt = sig.dtype
    if cg_tol is None:
        cg_tol = 1.e-11 if dt == torch.float64 else 1.e-6
    gfix = sm.fixed
    bc = tuple(v * load_frac for v in sm.fixed_val)
    force = tuple(f * load_frac for f in sm.force)
    solve_cg = make_slab_cg3(sm, two_level=two_level)
    deps_of = make_deps3(sm)

    def respond(deps):
        return respond_elements(sm, mat, CVs, sig, epl, deps, nsub,
                                grouped=False)

    def update(el, grad):
        g = grad.reshape(sm.nel_loc, 36).T.contiguous().reshape(el.shape)
        dst = torch.sqrt(torch.sum((el - g) ** 2, dim=0))
        # kernel C takes contiguous volumes
        return torch.where(dst > 1.e-3, g, el).contiguous()

    def solve_with(el, coarse, x0=None):
        # the BC lift -K u_bc with the CURRENT tangents
        du_bc = tuple(torch.where(f, b, 0.) for f, b in zip(gfix, bc))
        neg = _halo_accumulate(sm, list(fe3d._k_apply3_raw(sm.md_loc, el,
                                                            du_bc)))
        rhs = tuple(torch.where(f, b, -q + fr)
                    for f, b, q, fr in zip(gfix, bc, neg, force))
        start = tuple(torch.where(f, b, 0. if x0 is None else x)
                      for f, b, x in zip(gfix, bc, bc if x0 is None else x0))
        return solve_cg(el, rhs, start, coarse, tol=cg_tol)

    coarse = build_coarse_inv3(sm, C_loc) if two_level else None
    du, res, it = solve_with(C_loc, coarse)
    el = C_loc
    for _ in range(n_inner):
        el = update(el, respond(deps_of(du))[3])
        du, res, it = solve_with(el, coarse, x0=du)
    deps = deps_of(du)
    fy, sig_n, depl_n, grad = respond(deps)
    el = update(el, grad)
    epl_new = epl + depl_n
    nel = sm.NX * sm.NY * sm.NZ
    diag = {'cg_res': res, 'cg_iters': it, 'du': du, 'elstiff': el,
            'glob_sig': sm.mesh.sum(torch.sum(sig_n, 0)) / nel,
            'glob_eps': sm.mesh.sum(torch.sum(deps, 0)) / nel,
            'glob_epl': sm.mesh.sum(torch.sum(epl_new, 0)) / nel}
    return sig_n, epl_new, du, diag


def solve_uniaxial3_slab(sm: SlabMesh3, mat, CV, nsteps=10, n_inner=2,
                         nsub=4, two_level=True):
    """Incremental solve on the slab decomposition (the
    ``fe3d.solve_uniaxial3`` twin): equal load fractions, the tangents
    carried from step to step.  ``CV`` a stiffness or, with ``mat`` a
    tuple, the materials' tuple (per-element initial stiffness from the
    material map).  Returns (sig, epl, u, [(glob_sig, glob_eps,
    cg_iters)])."""
    if isinstance(CV, (tuple, list)):
        C = sm.elstiff_blocks(np.asarray(CV)[sm.mat_ids_global])
    else:
        C = sm.elstiff_blocks(CV)
    z = torch.zeros((sm.nel_loc, 6), dtype=sm.dtype, device=sm.device)
    sig, epl, u = z, z.clone(), sm.zeros_u()
    hist = []
    for _ in range(nsteps):
        sig, epl, du, d = slab_load_step3(sm, C, sig, epl, mat, 1. / nsteps,
                                          n_inner=n_inner, nsub=nsub,
                                          CVs=CV, two_level=two_level)
        u = tuple(a + b for a, b in zip(u, du))
        C = d['elstiff']
        hist.append((d['glob_sig'], d['glob_eps'], d['cg_iters']))
    return sig, epl, u, hist
