"""Domain-decomposed 2-D FE solver over ``torch.distributed``: x-strips
with a one-column halo exchange (the port of
``pylabfea_tpu.parallel.sharded``).

The structured NX x NY mesh is cut into one x-strip a rank: strip position
r holds element columns [r NXd, (r+1) NXd) and node columns [r NXd,
r NXd + NXd]; the last column is shared with position r+1 and DUPLICATED
on both.  There is no global array: each rank holds its own block.  Nodal
vectors are tuples of per-component (NXd+1, nnY) planes, element fields
(NXd NY, ...) rows in the global x-major raster order.

After a strip-local apply (kernel B on the card, its plain version on the
CPU) both copies of a shared column hold partial sums; one exchange a
K-apply completes them (``_halo_accumulate``).  Reductions weight the
duplicated column once (``own``) and are summed over the ranks.  CG
(``cg_solve_strip``) is preconditioned by Jacobi or by additive Schwarz: a
strip-local multigrid V-cycle with Dirichlet conditions at interior
interfaces (``make_schwarz_mg``), plus, for two levels, a strip-spanning
coarse space whose Galerkin operator is summed over the ranks and
inverted densely on each (``make_schwarz_two_level``).  A preconditioner
is built once a solve from that solve's tangents (its coarse inverse once
a load step); the residual norm is read on the host once a CG trip.
"""
import dataclasses

import numpy as np
import torch

from pylabfea_tpu_torch.config import DTYPE_DEVICE, resolve_device
from pylabfea_tpu_torch.ops import constitutive as con
from pylabfea_tpu_torch.ops import fe_kernels as fek
from pylabfea_tpu_torch.ops import multigrid as mg
from pylabfea_tpu_torch.ops import stencil as st
from pylabfea_tpu_torch.parallel.distributed import global_strip_mesh


class _Block:
    """What a strip (``StripMesh``) and a slab (``sharded3.SlabMesh3``)
    share: this rank's position ``pos`` of ``D``, its BC masks ``fixed``
    and its single-grid template ``md_loc``."""

    def local_fixed(self):
        """BC masks of the subdomain solve: the global masks plus
        Dirichlet at interior interfaces (the first layer for pos > 0, the
        last one for pos < D - 1)."""
        out = []
        for f in self.fixed:
            f = f.clone()
            if self.pos > 0:
                f[0] = True
            if self.pos < self.D - 1:
                f[-1] = True
            out.append(f)
        return tuple(out)

    def schwarz_mesh(self):
        """The template under ``local_fixed``, built once (its ``cache``
        keeps the coarse-mesh chain of every later hierarchy)."""
        if self._schwarz_md is None:
            self._schwarz_md = dataclasses.replace(
                self.md_loc, fixed=torch.stack(self.local_fixed(), 0))
        return self._schwarz_md


def coarse_weights_x(D, NXd, pos):
    """(NXd+1, D+1) piecewise-linear weights of the coarse x-nodes at the
    D+1 block boundaries on the node layers of block ``pos``."""
    xc = np.arange(D + 1) * NXd
    xg = pos * NXd + np.arange(NXd + 1)
    return np.stack([np.interp(xg, xc, e) for e in np.eye(D + 1)], 1)


def coarse_weights_1d(nn, nc):
    """(nn, nc) piecewise-linear weights of ``nc`` evenly spaced coarse
    nodes on ``nn`` nodes."""
    yc = np.linspace(0., nn - 1., nc)
    return np.stack([np.interp(np.arange(nn), yc, e) for e in np.eye(nc)],
                    1)


class StripMesh(_Block):
    """This rank's x-strip of a structured NX x NY mesh (the JAX
    ``StripMesh``, one block instead of a global sharded array).

    ``mesh`` is the ``RankMesh`` the strips span (default
    ``global_strip_mesh()``); ``device=None`` is the card.  BCs: the
    ``make_edge_bcs`` spec ``bc`` or the uniaxial defaults; ``mat_map``
    (NX, NY) material ids make a multi-material mesh: the strip's ids
    ``mat_ids`` and its material blocks (``perm``, ``inv_perm``,
    ``groups`` of ``md_loc``; JAX pads them to one capacity on every rank
    because ``shard_map`` needs equal shapes, a rank of the port sizes
    them to its own strip)."""

    def __init__(self, NX, NY, LX=1., LY=1., uniax='y', eps_tot=0.01,
                 mesh=None, dtype=DTYPE_DEVICE, device=None, bc=None,
                 mat_map=None):
        mesh = global_strip_mesh() if mesh is None else mesh
        D = mesh.size
        if NX % D:
            raise ValueError(f'NX={NX} must be divisible by {D} ranks')
        device = resolve_device(device)
        self.mesh, self.D, self.pos = mesh, D, mesh.pos
        self.NX, self.NY = NX, NY
        self.NXd = NX // D
        self.nnY = NY + 1
        self.dtype, self.device = dtype, device
        self.mat_ids = None
        if mat_map is not None:
            ids = np.asarray(mat_map, dtype=np.int64).reshape(D, -1)[
                self.pos]
            self.mat_ids = torch.as_tensor(ids, device=device)
        # the strip-local single-grid template of every local operator:
        # stiffness planes, strains, the grouped return map (the strip's
        # material blocks) and the Schwarz hierarchy; its BC fields are
        # unused (the strip masks below replace them)
        self.md_loc = fek.rect_mesh(
            self.NXd, NY, LX=LX / NX * self.NXd, LY=LY, uniax='y',
            eps_tot=0., dtype=dtype, device=device,
            mat_map=None if mat_map is None else ids.reshape(self.NXd, NY))
        if bc is not None:
            gfix, gval, gforce = fek.make_edge_bcs(
                NX, NY, left=bc.get('left'), right=bc.get('right'),
                bot=bc.get('bot'), top=bc.get('top'),
                nodes=bc.get('nodes', ()))
        else:
            gfix = np.zeros((2, NX + 1, self.nnY), dtype=bool)
            gval = np.zeros((2, NX + 1, self.nnY))
            gforce = np.zeros((2, NX + 1, self.nnY))
            gfix[1, :, 0] = True                      # bottom: uy = 0
            gfix[0, 0, :] = True                      # left edge: ux = 0
            if uniax == 'y':
                gfix[1, :, -1] = True                 # top: uy prescribed
                gval[1, :, -1] = eps_tot * LY
        cols = slice(self.pos * self.NXd, self.pos * self.NXd + self.NXd + 1)

        def strip(g, dt):
            return tuple(torch.as_tensor(g[c, cols], dtype=dt, device=device)
                         for c in range(2))

        self.fixed = strip(gfix, torch.bool)
        self.fixed_val = strip(gval, dtype)
        self.force = strip(gforce, dtype)
        # the shared column (local index NXd) counts on the right
        # neighbour only
        own = torch.ones((self.NXd + 1, self.nnY), dtype=dtype, device=device)
        if self.pos < D - 1:
            own[-1] = 0.
        self.own = (own, own)
        self._schwarz_md = None

    @property
    def nel_loc(self):
        return self.NXd * self.NY

    def shard_elements(self, arr_global):
        """(Nel, ...) global element array -> this rank's (NXd NY, ...)
        block in the mesh dtype (the raster order is x-major, so a strip is
        a contiguous row range)."""
        a = torch.as_tensor(arr_global, dtype=self.dtype)
        NL = self.nel_loc
        return a[self.pos * NL:(self.pos + 1) * NL].contiguous().to(
            self.device)


def _halo_accumulate(sm: _Block, out):
    """Complete the duplicated boundary layers (columns of a strip's
    planes, planes of a slab's volumes) of a tuple (in place; returns it):
    position r adds position r-1's last-layer partial sum to its first
    layer, and its last layer becomes position r+1's completed first
    layer, computed from the same two partial sums in the same order, so
    both copies agree bitwise.  One exchange of every position's two
    boundary layers; a no-op on one rank."""
    if sm.D == 1:
        return out
    cols = sm.mesh.exchange(torch.stack([torch.stack((p[0], p[-1]))
                                         for p in out]))
    for c, p in enumerate(out):
        if sm.pos > 0:
            p[0] = p[0] + cols[sm.pos - 1, c, 1]
        if sm.pos < sm.D - 1:
            p[-1] = cols[sm.pos + 1, c, 0] + p[-1]
    return out


def element_Ke_planes(sm: StripMesh, el_loc):
    """Element stiffness planes (8, 8, NXd, NY) from the strip's tangent
    rows (NXd NY, 6, 6) (``fek.element_stiffness_planes`` on the strip's
    template)."""
    return fek.element_stiffness_planes(sm.md_loc, el_loc.reshape(
        sm.nel_loc, 36).T.reshape(36, sm.NXd, sm.NY))


def apply_planes(sm: StripMesh, Kp, v, fixed):
    """K v across the strips with identity rows on ``fixed`` dofs."""
    vm = tuple(torch.where(f, 0., x) for f, x in zip(fixed, v))
    # the strip-local apply: kernel B on the card, its plain version on
    # the CPU
    out = _halo_accumulate(sm, list(st.k_apply(Kp, vm[0], vm[1])))
    return tuple(torch.where(f, x, o) for f, x, o in zip(fixed, v, out))


def make_k_apply(sm: StripMesh):
    """``k_apply(el_loc, v, fixed)``: the matrix-free K-apply with halo
    exchange from the strip's tangent rows (the JAX ``make_k_apply``)."""
    def k_apply(el_loc, v, fixed):
        return apply_planes(sm, element_Ke_planes(sm, el_loc), v, fixed)
    return k_apply


def make_dot(sm: StripMesh):
    """``gdot(a, b, own)``: the global dot product of plane tuples that
    counts the duplicated columns once."""
    def gdot(a, b, own):
        return sm.mesh.sum(sum(torch.sum(x * y * w)
                               for x, y, w in zip(a, b, own)))
    return gdot


def k_diag_planes(sm: StripMesh, Kp):
    """Assembled diagonal of K across the strips, 1 on fixed dofs."""
    d = st.scatter_planes(tuple(Kp[i, i] for i in range(8)), sm.NXd, sm.NY)
    d = _halo_accumulate(sm, list(d))
    return tuple(torch.where(f, 1., x) for f, x in zip(sm.fixed, d))


def make_schwarz_mg(sm: StripMesh, min_size=8):
    """One-level additive Schwarz with a strip-local multigrid V-cycle:
    each rank solves its own strip with Dirichlet conditions at interior
    interfaces (no communication), and a Jacobi patch on the interface
    columns keeps the preconditioner SPD.  Returns ``prepare(el_loc,
    diag) -> precon(r)``: the strip-local hierarchy is built once from the
    solve's tangents (JAX rebuilds it at every application of the same
    tangents; the result is the same)."""
    md_d = sm.schwarz_mesh()
    fix = sm.local_fixed()

    def prepare(el_loc, diag):
        levels = mg.build_hierarchy(md_d, el_loc, min_size=min_size)

        def precon(r):
            z = mg.v_cycle(levels, tuple(torch.where(f, 0., x)
                                         for f, x in zip(fix, r)))
            # the Jacobi patch on the interfaces; on globally fixed dofs
            # (r = 0 there) it gives the exact 0 where the V-cycle's dense
            # bottom inverse leaves round-off
            return tuple(torch.where(f, x / d, y)
                         for f, x, d, y in zip(fix, r, diag, z))
        return precon

    return prepare


def _coarse_weights(sm: StripMesh, nyc=None):
    """Separable bilinear weights of the strip-spanning coarse space:
    coarse x-nodes at the strip boundaries (D+1), ``nyc`` coarse y-nodes.
    Returns (Wx (NXd+1, D+1) of this strip, Wy (nnY, nyc), nyc)."""
    nyc = min(sm.nnY, 9) if nyc is None else min(sm.nnY, nyc)

    def ten(a):
        return torch.as_tensor(a, dtype=sm.dtype, device=sm.device)
    return (ten(coarse_weights_x(sm.D, sm.NXd, sm.pos)),
            ten(coarse_weights_1d(sm.nnY, nyc)), nyc)


def _restrict(Wx, Wy, v):
    """(D+1, nyc, 2) coarse vector of a plane tuple, flattened."""
    return torch.stack([Wx.T @ p @ Wy for p in v], -1).reshape(-1)


def _prolong(Wx, Wy, c, nyc, fixed):
    """Plane tuple of a flat coarse vector, zero on ``fixed`` dofs.  The
    x-interpolation is an elementwise sum, so a duplicated column comes
    out bitwise alike on both strips (a matmul may round a row by its
    place in the matrix)."""
    c = c.reshape(Wx.shape[1], nyc, 2)
    out = []
    for i, f in enumerate(fixed):
        T = c[:, :, i] @ Wy.T
        out.append(torch.where(f, 0., sum(Wx[:, a, None] * T[a]
                                          for a in range(Wx.shape[1]))))
    return tuple(out)


def build_coarse_inv(sm: StripMesh, el_loc, nyc=None):
    """Dense inverse of the Galerkin coarse operator Kc = P^T K P of the
    strip-spanning coarse space: every coarse basis function that lives on
    the strip through the strip-local apply (kernel B on the card; the
    partial sums of the duplicated columns need no halo, the sum over the
    ranks assembles each element once), coarse dofs without support
    replaced by identity rows.
    Returns (Kc_inv, Wx, Wy, nyc)."""
    Wx, Wy, nyc = _coarse_weights(sm, nyc)
    nc2 = (sm.D + 1) * nyc * 2
    Kp = element_Ke_planes(sm, el_loc)
    eye = torch.eye(nc2, dtype=sm.dtype, device=sm.device)
    Kc = torch.zeros((nc2, nc2), dtype=sm.dtype, device=sm.device)
    # a basis function of coarse x-node a vanishes on the strip unless a is
    # one of its two boundaries: its row of this strip's share is zero
    for e in range(2 * sm.pos * nyc, 2 * (sm.pos + 2) * nyc):
        v = _prolong(Wx, Wy, eye[e], nyc, sm.fixed)
        out = st.k_apply(Kp, v[0], v[1])
        Kc[e] = _restrict(Wx, Wy, tuple(
            torch.where(f, 0., o) for f, o in zip(sm.fixed, out)))
    Kc = sm.mesh.all_reduce(Kc)
    dKc = torch.diagonal(Kc)
    bad = dKc <= 1e-10 * torch.max(dKc)
    Kc = torch.where(bad[:, None] | bad[None, :], 0., Kc)
    Kc = Kc + torch.diag(bad.to(Kc.dtype))
    return torch.linalg.inv(Kc), Wx, Wy, nyc


def make_schwarz_two_level(sm: StripMesh, el_entry, min_size=8, nyc=None):
    """Two-level additive Schwarz: the strip-local V-cycle of
    ``make_schwarz_mg`` plus the coarse correction P Kc^-1 P^T r, whose
    inverse comes from the tangents ``el_entry`` (frozen; a stale coarse
    operator costs iterations, never correctness).  Returns
    ``prepare(el_loc, diag) -> precon(r)``."""
    local = make_schwarz_mg(sm, min_size=min_size)
    Kc_inv, Wx, Wy, nyc = build_coarse_inv(sm, el_entry, nyc)

    def coarse_corr(r):
        rm = tuple(torch.where(f, 0., x) * w
                   for f, x, w in zip(sm.fixed, r, sm.own))
        rc = sm.mesh.all_reduce(_restrict(Wx, Wy, rm))
        return _prolong(Wx, Wy, Kc_inv @ rc, nyc, sm.fixed)

    def prepare(el_loc, diag):
        pre = local(el_loc, diag)

        def precon(r):
            return tuple(a + b for a, b in zip(pre(r), coarse_corr(r)))
        return precon

    return prepare


def cg_solve_strip(sm: StripMesh, el_loc, rhs, x0, diag, tol=1e-8,
                   maxiter=1000, precon=None):
    """Preconditioned CG on the strip-decomposed operator (the JAX
    ``cg_solve_strip``): plane tuples of this strip; a trip communicates
    the K-apply's halo and the dots' sums and reads the residual norm on
    the host once.  ``precon`` maps r to z (Jacobi by default).  Exits at
    ``|r| <= tol |b|`` (ownership-weighted norms) or at ``maxiter``.
    Returns (x, relative residual, iterations)."""
    Kp = element_Ke_planes(sm, el_loc)
    gdot = make_dot(sm)

    def A(v):
        return apply_planes(sm, Kp, v, sm.fixed)

    if precon is None:
        minv = tuple(1. / d for d in diag)

        def precon(r):
            return tuple(m * q for m, q in zip(minv, r))

    r = tuple(b - a for b, a in zip(rhs, A(x0)))
    bnorm = max(float(torch.sqrt(gdot(rhs, rhs, sm.own))), 1e-30)
    x, p, rz_prev, it = x0, None, None, 0
    rn = float(torch.sqrt(gdot(r, r, sm.own)))
    while rn > tol * bnorm and it < maxiter:
        z = precon(r)
        rz = gdot(r, z, sm.own)
        p = z if it == 0 else tuple(zi + (rz / rz_prev) * pi
                                    for zi, pi in zip(z, p))
        Ap = A(p)
        alpha = rz / gdot(p, Ap, sm.own)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * ai for ri, ai in zip(r, Ap))
        # host read of the residual norm once per trip (the exit test)
        rn = float(torch.sqrt(gdot(r, r, sm.own)))
        rz_prev = rz
        it += 1
    return x, rn / bnorm, it


def respond_elements(sm: _Block, mat, CV, sig, epl, deps, nsub=4,
                     grouped=True):
    """The element-local return map of a strip or slab (no
    communication): ``response_fast`` of one material, or, with tuples
    ``mat``/``CV``, each material on its block of ``sm.md_loc``
    (``fek.respond_grouped``) or, with ``grouped=False``, one masked pass
    a material over every row (by ``sm.mat_ids``).  Returns (f, sig,
    depl, tangent rows)."""
    if not isinstance(mat, (tuple, list)):
        return con.response_fast_chunked(mat, (sig, epl), deps,
                                         torch.as_tensor(CV, dtype=sig.dtype,
                                                         device=sig.device),
                                         12, nsub)
    if grouped:
        return fek.respond_grouped(sm.md_loc, mat, CV, sig, epl, deps,
                                   maxiter=12, nsub=nsub)
    out = None
    for k, mk in enumerate(mat):
        CVk = torch.as_tensor(CV[k], dtype=sig.dtype, device=sig.device)
        ok = con.response_fast(mk, (sig, epl), deps, CVk, 12, nsub)
        if out is None:
            out = ok
        else:
            sel = sm.mat_ids == k
            out = tuple(torch.where(
                sel.reshape((-1,) + (1,) * (o.dim() - 1)), o, prev)
                for prev, o in zip(out, ok))
    return out


def strip_load_step(sm: StripMesh, elstiff, sig, epl, mat, load_frac=1.0,
                    n_inner=2, cg_tol=1e-8, nsub=4, schwarz=2, CVs=None,
                    grouped=True):
    """One load step on the strip-decomposed mesh (the JAX
    ``strip_load_step``): CG solve, element-local return map (no
    communication), change-gated tangent update (1e-3), re-solve warm
    started from the last increment, ``n_inner`` times, then the final
    response.  ``elstiff`` (NXd NY, 6, 6), ``sig``/``epl`` (NXd NY, 6) are
    this strip's rows.  ``schwarz=2`` preconditions with two-level
    additive Schwarz (its coarse inverse built once a step from the entry
    tangents), ``True`` one-level, falsy Jacobi.

    Multi-material strips take ``mat`` and ``CVs`` as tuples and a mesh
    with ``mat_map``: the return map runs grouped (each material on its
    block of the strip's rows) or, with ``grouped=False``, as one masked
    pass a material over every row (``respond_elements``).  Returns (sig, epl,
    du, diag) with ``cg_res``, ``cg_iters`` (the last solve's),
    ``cg_iters_hist`` (every solve's) and the global means ``glob_sig``,
    ``glob_epl``."""
    # elastic reference of a single material: element 0 of the mesh
    if not isinstance(mat, (tuple, list)):
        CVs = sm.mesh.broadcast(elstiff[0].clone())
    bc = tuple(v * load_frac for v in sm.fixed_val)
    k_apply = make_k_apply(sm)

    pre = None
    if schwarz:
        pre = make_schwarz_two_level(sm, elstiff) if schwarz == 2 \
            else make_schwarz_mg(sm)

    def solve_with(el, x0=None):
        du_bc = tuple(torch.where(f, b, 0.) for f, b in zip(sm.fixed, bc))
        zmask = tuple(torch.zeros_like(f) for f in sm.fixed)
        neg = k_apply(el, du_bc, zmask)
        rhs = tuple(torch.where(f, b, fr * load_frac - q)
                    for f, b, fr, q in zip(sm.fixed, bc, sm.force, neg))
        diag = k_diag_planes(sm, element_Ke_planes(sm, el))
        M = None if pre is None else pre(el, diag)
        start = du_bc if x0 is None else tuple(
            torch.where(f, b, x) for f, b, x in zip(sm.fixed, bc, x0))
        return cg_solve_strip(sm, el, rhs, start, diag, tol=cg_tol,
                              precon=M)

    def respond(deps):
        return respond_elements(sm, mat, CVs, sig, epl, deps, nsub, grouped)

    def deps_of(du):
        return fek.element_deps(sm.md_loc, torch.stack(du))

    du, res, it = solve_with(elstiff)
    el, iters = elstiff, [it]
    for _ in range(n_inner):
        grad = respond(deps_of(du))[3]
        dst = torch.linalg.norm((el - grad).reshape(-1, 36), dim=1)
        el = torch.where((dst > 1e-3)[:, None, None], grad, el)
        du, res, it = solve_with(el, x0=du)
        iters.append(it)
    fy, sig_n, depl_n, grad = respond(deps_of(du))
    epl_new = epl + depl_n
    nel = sm.NX * sm.NY
    diag = {'cg_res': res, 'cg_iters': it, 'cg_iters_hist': iters,
            'glob_sig': sm.mesh.sum(torch.sum(sig_n, 0)) / nel,
            'glob_epl': sm.mesh.sum(torch.sum(epl_new, 0)) / nel}
    return sig_n, epl_new, du, diag
