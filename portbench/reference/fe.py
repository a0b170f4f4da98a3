"""Plain finite elements on structured grids of bilinear quads (2-D, plane
strain) and trilinear hexahedra (3-D), in plain PyTorch.

Nodal vectors are flat, component-major: dof = comp * nnode + node, with
nodes and elements numbered lexicographically (x slowest), which is the
layout of (dim, nnX, nnY[, nnZ]) nodal arrays and of (Nel, 6) element
rows of the program.  Stresses and strains are Voigt rows (11, 22, 33, 23,
13, 12) with engineering shears.  Stiffness is integrated with 2^dim Gauss
points; the element-average strain uses the average of their B matrices,
which for these elements is B at the centroid.

``solve_uniaxial`` is the reference's own load history (elastic
predictor, secant-Picard rounds of a linear solve and the return map): it
is what the control runs in the program's place.  Its linear solver is
Jacobi-preconditioned CG, which converges on the small meshes of the tests
and stops at ``cg_maxiter`` on large ones.
"""
import itertools
import math

import numpy as np
import torch

from . import returnmap as rm

_SHEAR = {3: (1, 2), 4: (0, 2), 5: (0, 1)}


def _b_matrix(xi, h):
    """B (6, dim * 2^dim) at the reference point ``xi`` of an element with
    edge lengths ``h``; element dofs corner-major, component-minor."""
    dim = len(h)
    cs = list(itertools.product((0, 1), repeat=dim))
    B = np.zeros((6, dim * len(cs)))
    for a, c in enumerate(cs):
        s = 2. * np.array(c) - 1.
        f = 0.5 * (1. + s * xi)
        dN = np.empty(dim)
        for d in range(dim):
            dN[d] = 0.5 * s[d] * 2. / h[d] * np.prod(
                [f[e] for e in range(dim) if e != d])
        for d in range(dim):
            B[d, dim * a + d] = dN[d]
        for row, (p, q) in _SHEAR.items():
            if p < dim and q < dim:
                B[row, dim * a + p] = dN[q]
                B[row, dim * a + q] = dN[p]
    return B


class Grid:
    """A structured grid of ``n`` elements per axis over a box of edge
    lengths ``lengths``: its Gauss-point B matrices, the element-average
    B, the element dofs and the uniaxial boundary conditions."""

    def __init__(self, n, lengths, device='cpu'):
        self.n = tuple(int(k) for k in n)
        self.dim = len(self.n)
        self.lengths = tuple(float(x) for x in lengths)
        self.h = [L / k for L, k in zip(self.lengths, self.n)]
        self.nn = tuple(k + 1 for k in self.n)
        self.nnode = math.prod(self.nn)
        self.nel = math.prod(self.n)
        self.ndof = self.dim * self.nnode
        self.vel = math.prod(self.h)
        self.device = torch.device(device)
        g = 1. / math.sqrt(3.)
        pts = [np.array([(2 * c - 1) * g for c in cs])
               for cs in itertools.product((0, 1), repeat=self.dim)]
        self.B = torch.as_tensor(np.stack([_b_matrix(p, self.h)
                                           for p in pts]),
                                 dtype=torch.float64, device=self.device)
        self.Bc = self.B.mean(0)
        self.wgp = self.vel / len(pts)
        stride = [math.prod(self.nn[d + 1:]) for d in range(self.dim)]
        axes = torch.meshgrid(*[torch.arange(k, device=self.device)
                                for k in self.n], indexing='ij')
        base = sum(a.reshape(-1) * s for a, s in zip(axes, stride))
        cols = []
        for c in itertools.product((0, 1), repeat=self.dim):
            node = base + sum(ci * s for ci, s in zip(c, stride))
            cols.extend(comp * self.nnode + node for comp in range(self.dim))
        self.dofs = torch.stack(cols, 1)
        self._stride = stride

    def node_coords(self):
        """Integer node coordinates (nnode, dim)."""
        axes = torch.meshgrid(*[torch.arange(k, device=self.device)
                                for k in self.nn], indexing='ij')
        return torch.stack([a.reshape(-1) for a in axes], 1)

    def uniaxial_bcs(self, axis, eps):
        """Rollers on the low face of every axis and the high face of
        ``axis`` moved by ``eps`` times the edge length: (fixed (ndof,)
        bool, prescribed values (ndof,) float64)."""
        ij = self.node_coords()
        fixed = torch.zeros((self.dim, self.nnode), dtype=torch.bool,
                            device=self.device)
        val = torch.zeros((self.dim, self.nnode), dtype=torch.float64,
                          device=self.device)
        for d in range(self.dim):
            fixed[d] |= ij[:, d] == 0
        top = ij[:, axis] == self.n[axis]
        fixed[axis] |= top
        val[axis] = torch.where(top, eps * self.lengths[axis], 0.)
        return fixed.reshape(-1), val.reshape(-1)

    def strain(self, u):
        """Element-average strains (Nel, 6) of the nodal vector ``u``."""
        u = u.reshape(-1)
        return u[self.dofs] @ self.Bc.to(u.dtype).T

    def internal_force(self, sig):
        """Nodal forces (ndof,) of element-constant stresses (Nel, 6)."""
        fe = self.vel * (sig @ self.Bc.to(sig.dtype))
        out = torch.zeros(self.ndof, dtype=sig.dtype, device=sig.device)
        return out.index_add_(0, self.dofs.reshape(-1), fe.reshape(-1))

    def k_apply(self, T, u):
        """K u for element tangents T (Nel, 6, 6)."""
        ue = u[self.dofs]
        fe = torch.zeros_like(ue)
        for Bg in self.B.to(u.dtype):
            s = torch.bmm(T, (ue @ Bg.T)[:, :, None])[:, :, 0]
            fe += self.wgp * (s @ Bg)
        out = torch.zeros_like(u)
        return out.index_add_(0, self.dofs.reshape(-1), fe.reshape(-1))

    def k_diag(self, T):
        """Diagonal of K (ndof,) for element tangents T (Nel, 6, 6)."""
        de = torch.zeros((self.nel, self.dofs.shape[1]), dtype=T.dtype,
                         device=T.device)
        for Bg in self.B.to(T.dtype):
            de += self.wgp * (Bg[None] * (T @ Bg)).sum(1)
        out = torch.zeros(self.ndof, dtype=T.dtype, device=T.device)
        return out.index_add_(0, self.dofs.reshape(-1), de.reshape(-1))


def pcg(apply, b, x0, free, dinv, tol, maxiter):
    """Jacobi-preconditioned CG on the free dofs of K x = b (x fixed
    elsewhere at x0) to ``tol`` of the lifted right-hand side.  Returns
    (x, relative residual, iterations)."""
    def op(v):
        return torch.where(free, apply(torch.where(free, v, 0.)), 0.)

    x = x0.clone()
    r = torch.where(free, b - apply(x), 0.)
    # the right-hand side of the free dofs, prescribed values lifted
    bn = max(float(torch.linalg.vector_norm(torch.where(
        free, b - apply(torch.where(free, 0., x0)), 0.))), 1e-300)
    z = dinv * r
    p = z
    rz = torch.dot(r, z)
    it = 0
    rn = float(torch.linalg.vector_norm(r))
    while rn > tol * bn and it < maxiter and float(rz) != 0.:
        q = op(p)
        alpha = rz / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = dinv * r
        rz, rz_old = torch.dot(r, z), rz
        p = z + (rz / rz_old) * p
        rn = float(torch.linalg.vector_norm(r))
        it += 1
    return x, rn / bn, it


def solve_uniaxial(grid, mat, CV, axis, eps, nsteps, n_inner, nsub=4,
                   dtype=torch.float64, cg_tol=None, cg_maxiter=100):
    """The reference load history: ``nsteps`` equal increments of the
    uniaxial boundary displacement up to strain ``eps``; each step runs
    ``n_inner + 1`` rounds of (CG on the current tangent, the return map
    from the step's entering state, the tangent update where it changed
    by more than 1e-3), the first warm-started from the last increment,
    and commits the last round.  Everything is computed in ``dtype``.
    Returns ((u (ndof,), sig, epl, eps (Nel, 6)), [glob_sig (6,) of each
    step], the first round's tangent ``T_first``, the last round's
    ``T_last`` and its increment ``du_last``)."""
    dev = grid.device
    fixed, val = grid.uniaxial_bcs(axis, eps)
    free = ~fixed
    val = val.to(dtype)
    C = torch.as_tensor(CV, dtype=dtype, device=dev)
    tol = cg_tol if cg_tol is not None else (
        1e-11 if dtype == torch.float64 else 1e-6)
    u = torch.zeros(grid.ndof, dtype=dtype, device=dev)
    sig = torch.zeros((grid.nel, 6), dtype=dtype, device=dev)
    epl = torch.zeros_like(sig)
    eps_el = torch.zeros_like(sig)
    T = C.expand(grid.nel, 6, 6).clone()
    du = torch.zeros_like(u)
    hist = []
    T_first = T
    for _ in range(nsteps):
        bc = val / nsteps
        for _ in range(n_inner + 1):
            diag = grid.k_diag(T)
            dinv = torch.where(free, 1. / torch.where(free, diag, 1.), 0.)
            x0 = torch.where(fixed, bc, du)
            du, _, _ = pcg(lambda v: grid.k_apply(T, v), torch.zeros_like(u),
                           x0, free, dinv, tol, cg_maxiter)
            deps = grid.strain(du)
            T_last = T
            _, sig_n, depl, tan = rm.response(mat, sig, epl, deps, C,
                                              nsub=nsub)
            dst = torch.linalg.matrix_norm(T - tan)
            T = torch.where((dst > 1e-3)[:, None, None], tan, T)
        u = u + du
        sig, epl, eps_el = sig_n, epl + depl, eps_el + deps
        hist.append(sig.mean(0))
    return (u, sig, epl, eps_el), hist, dict(T_first=T_first, T_last=T_last,
                                             du_last=du)
