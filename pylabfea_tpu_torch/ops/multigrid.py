"""Geometric multigrid preconditioner for the structured-mesh FE operator
(the Jacobi V-cycle of ``pylabfea_tpu.ops.multigrid``).

Coarse operators are the exact Galerkin products P^T K P of the bilinear
prolongation, assembled as coarse element-stiffness planes; restriction
and prolongation are the separable full-weighting matrices (``restrict_mm``
/ ``prolong_mm``); smoothing is damped Jacobi or, with ``SMOOTHER =
'chebyshev'``, a Chebyshev polynomial in D^-1 K; the coarsest level (at most
``COARSE_DENSE_MAX`` dofs) is solved exactly with a dense pseudo-inverse.
Every nodal vector is one stacked (2, nnX, nnY) tensor of both displacement
planes, so each elementwise step, mask, transfer and reduction is one
operation for both; every stiffness apply is one call of ``stencil.k_apply``
(kernel B on the card) on its two planes.  Inside the V-cycle every vector
is 0 on fixed dofs.  The V-cycle is symmetric, so it preconditions CG.
"""
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pylabfea_tpu_torch.ops import fe_kernels as fek
from pylabfea_tpu_torch.ops import stencil as st
from pylabfea_tpu_torch.utils import profiling

#: exact dense bottom solve when the coarsest level has at most this many
#: dofs (min_size=8 -> 162)
COARSE_DENSE_MAX = 700
#: smoother selection: 'jacobi' (damped by OMEGA) or 'chebyshev'
#: (degree-nu polynomial on D^-1 K, eigenvalue interval [lmax/4, lmax])
SMOOTHER = 'jacobi'
#: damping of the Jacobi smoother
OMEGA = 0.7


def coarsen_mesh(md: fek.MeshData):
    """Mesh of the next-coarser level (half resolution).  The coarse BC
    mask is pin-preserving: a coarse node is fixed when any fine node of
    its 3x3 neighbourhood is fixed."""
    NX, NY, lx, ly, _ = md.grid
    mdc = fek.rect_mesh(NX // 2, NY // 2, LX=lx * NX, LY=ly * NY,
                        uniax='none', eps_tot=0., dtype=md.dtype,
                        device=md.device)
    nXc, nYc = NX // 2 + 1, NY // 2 + 1
    fp = torch.zeros((2, NX + 3, NY + 3), dtype=torch.bool, device=md.device)
    fp[:, 1:-1, 1:-1] = md.fixed
    fc = torch.zeros((2, nXc, nYc), dtype=torch.bool, device=md.device)
    for di in range(3):
        for dj in range(3):
            fc = fc | fp[:, di:di + 2 * nXc - 1:2, dj:dj + 2 * nYc - 1:2]
    return dataclasses.replace(mdc, fixed=fc)


def mesh_chain(md: fek.MeshData, min_size=8):
    """Fine-to-coarse meshes of the hierarchy; built once per mesh object
    (kept in ``md.cache``)."""
    key = ('chain', min_size)
    if key not in md.cache:
        profiling.count('mesh_chain_builds')
        with profiling.span('mesh_chain'):
            chain = [md]
            while True:
                NX, NY = chain[-1].grid[:2]
                if NX % 2 or NY % 2 or NX // 2 < min_size or \
                        NY // 2 < min_size:
                    break
                chain.append(coarsen_mesh(chain[-1]))
        md.cache[key] = tuple(chain)
    return md.cache[key]


def _galerkin_patch_T():
    """(4, 64, 64) patch-transfer matrices T_ab: Kc = sum_ab T_ab Kf(a, b)
    for the fine element at offset (a, b) of its coarse cell."""
    Ts = []
    for a, b in st.CORNERS:
        M = np.zeros((8, 8))
        for corner, (dx, dy) in enumerate(st.CORNERS):
            x = (a + dx) / 2.
            y = (b + dy) / 2.
            for C, (DX, DY) in enumerate(st.CORNERS):
                w = ((1. - x) if DX == 0 else x) * \
                    ((1. - y) if DY == 0 else y)
                for c in range(2):
                    M[2 * corner + c, 2 * C + c] = w
        Ts.append(np.einsum('ki,lj->ijkl', M, M).reshape(64, 64))
    return np.stack(Ts)


def galerkin_coarsen_Ke(Kf):
    """Exact Galerkin coarsening (8, 8, NX, NY) -> (8, 8, NX/2, NY/2): four
    (64, 64) contractions, one per patch position."""
    NX, NY = Kf.shape[2], Kf.shape[3]
    T = torch.as_tensor(_galerkin_patch_T(), dtype=Kf.dtype, device=Kf.device)
    K6 = Kf.reshape(64, NX // 2, 2, NY // 2, 2)
    out = 0.
    for idx, (a, b) in enumerate(st.CORNERS):
        blk = K6[:, :, a, :, b].reshape(64, -1)
        out = out + T[idx] @ blk
    return out.reshape(8, 8, NX // 2, NY // 2)


def _restrict_mat(nn, dtype, device):
    """(nn//2+1, nn) full-weighting rows [.., 0.5, 1, 0.5, ..] at stride 2:
    the separable factor of the 3x3 transfer stencil."""
    nc = nn // 2 + 1
    W = np.zeros((nc, nn))
    for I in range(nc):
        j = 2 * I
        W[I, j] = 1.
        if j - 1 >= 0:
            W[I, j - 1] = .5
        if j + 1 < nn:
            W[I, j + 1] = .5
    return torch.as_tensor(W, dtype=dtype, device=device)


def _transfer_mats(md: fek.MeshData):
    """(Wx, Wy) restriction factors of the mesh's node grid, built once per
    mesh object."""
    if 'W' not in md.cache:
        NX, NY = md.grid[:2]
        md.cache['W'] = (_restrict_mat(NX + 1, md.dtype, md.device),
                         _restrict_mat(NY + 1, md.dtype, md.device))
    return md.cache['W']


def restrict_mm(fine, W):
    """Restriction Wx @ p @ Wy^T of stacked planes (2, nnX, nnY), both in
    one matmul pair (the exact transpose of ``prolong_mm``, weights 1, 1/2,
    1/4)."""
    Wx, Wy = W
    return Wx @ fine @ Wy.T


def prolong_mm(coarse, W):
    """Bilinear prolongation Wx^T @ p @ Wy of stacked planes; ``W`` is the
    fine level's restriction pair."""
    Wx, Wy = W
    return Wx.T @ coarse @ Wy


@dataclass
class MGLevel:
    """One level: mesh, element stiffness planes, and as stacked (2, nnX,
    nnY) planes the Jacobi diagonal, the BC mask, the free-dof weight (1 on
    free dofs, 0 on fixed ones) and the damped-Jacobi factor OMEGA / diag;
    the restriction pair of its node grid; under the Chebyshev smoother
    the estimate of lambda_max(D^-1 K) and 1 / diag (None under Jacobi);
    the coarsest level may carry the dense inverse of its operator."""
    md: fek.MeshData
    Ke: torch.Tensor
    diag: torch.Tensor
    fixed: torch.Tensor
    free: torch.Tensor
    jinv: torch.Tensor
    W: tuple
    lmax: torch.Tensor = None
    cinv: torch.Tensor = None
    kc_inv: torch.Tensor = None


def _dot(a, b):
    """Dot product of stacked planes: one reduction."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _kx(level: MGLevel, v):
    """K v by kernel B for stacked planes ``v`` that hold 0 on fixed dofs.
    The rows of fixed dofs are K's own: callers zero them (``level.free``
    weights) or replace them."""
    o0, o1 = st.k_apply(level.Ke, v[0], v[1])
    return torch.stack((o0, o1))


def _apply(level: MGLevel, v):
    """K v with identity rows on fixed dofs, the entries of ``v`` on fixed
    dofs left out of the product."""
    return torch.where(level.fixed, v,
                       _kx(level, v.masked_fill(level.fixed, 0.)))


@profiling.spanned('coarse_inverse')
def _dense_coarse_inv(level: MGLevel):
    """Dense SPD pseudo-inverse of the coarsest-level operator (identity
    rows on fixed dofs): Jacobi-equilibrated eigendecomposition with
    small-eigenvalue clipping.  The dense matrix is assembled by applying
    the operator to every unit vector at once (batched plain plane ops on
    a grid of at most ``COARSE_DENSE_MAX`` dofs)."""
    md = level.md
    NX, NY = md.grid[:2]
    n = 2 * (NX + 1) * (NY + 1)
    v = torch.eye(n, dtype=level.Ke.dtype, device=level.Ke.device).reshape(
        n, 2, NX + 1, NY + 1)
    vm = v.masked_fill(level.fixed, 0.)
    out = st.scatter_planes(st.contract_planes(
        level.Ke, st.gather_planes(vm.unbind(1), NX, NY)), NX, NY)
    K = torch.where(level.fixed, v, torch.stack(out, 1)).reshape(n, n)
    s = torch.rsqrt(torch.clamp(torch.diagonal(K), min=1e-30))
    Ks = s[:, None] * K * s[None, :]
    # symmetrize as jnp.linalg.eigh does with its input
    w, V = torch.linalg.eigh(0.5 * (Ks + Ks.T))
    rel = 1e-11 if K.dtype == torch.float64 else 3e-6
    cut = rel * torch.clamp(torch.max(torch.abs(w)), min=1e-30)
    winv = torch.where(w > cut, 1. / torch.where(w > cut, w, 1.), 0.)
    SV = s[:, None] * V
    return (SV * winv[None, :]) @ SV.T


def _coarse_dense(level: MGLevel):
    NX, NY = level.md.grid[:2]
    return 2 * (NX + 1) * (NY + 1) <= COARSE_DENSE_MAX


def _make_level(cur_md, Ke):
    """MGLevel from mesh metadata + element-stiffness planes.  A level with
    an odd element count is the coarsest (``mesh_chain`` stops there) and
    gets no restriction pair, which needs even counts (the JAX package
    builds the pair only when it restricts)."""
    fixed = cur_md.fixed
    NX, NY = cur_md.grid[:2]
    W = None if NX % 2 or NY % 2 else _transfer_mats(cur_md)
    diag = torch.stack(st.scatter_planes(
        tuple(Ke[i, i] for i in range(8)), NX, NY)).masked_fill_(fixed, 1.)
    level = MGLevel(cur_md, Ke, diag, fixed, (~fixed).to(Ke.dtype),
                    OMEGA / diag, W)
    if SMOOTHER == 'chebyshev':
        level.cinv = 1. / diag
        # 10 power iterations for lambda_max(D^-1 K) from the JAX
        # package's deterministic start
        i = torch.arange((NX + 1) * (NY + 1), dtype=Ke.dtype,
                         device=Ke.device).reshape(NX + 1, NY + 1)
        v = torch.stack([torch.sin(i * (0.37 + 0.11 * c)) + 0.01
                         for c in range(2)])
        for _ in range(10):
            w = level.cinv * _apply(level, v)
            v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
        Av = level.cinv * _apply(level, v)
        level.lmax = _dot(v, Av) / torch.clamp(_dot(v, v), min=1e-30)
    return level


def build_hierarchy(md: fek.MeshData, elstiff, min_size=8, attach_inv=True):
    """Level list (fine -> coarse) for the current tangent field."""
    chain = mesh_chain(md, min_size)
    levels = []
    Ke = fek.element_stiffness_planes(md, elstiff)
    for i, cur_md in enumerate(chain):
        levels.append(_make_level(cur_md, Ke))
        if i + 1 < len(chain):
            Ke = galerkin_coarsen_Ke(Ke)
    if attach_inv and _coarse_dense(levels[-1]):
        levels[-1].kc_inv = _dense_coarse_inv(levels[-1])
    return levels


def hierarchy_kes(levels):
    """The per-level stiffness planes, plus the dense bottom inverse (a 2-D
    tensor) when the coarsest level qualifies: what a later solve needs to
    rebuild the levels (``levels_from_kes``)."""
    kes = tuple(lv.Ke for lv in levels)
    bot = levels[-1]
    if _coarse_dense(bot):
        inv = bot.kc_inv if bot.kc_inv is not None \
            else _dense_coarse_inv(bot)
        return kes + (inv,)
    return kes


def levels_from_kes(md: fek.MeshData, kes):
    """Level list from ``hierarchy_kes`` output (Jacobi diagonals are
    recomputed)."""
    kc_inv = None
    if len(kes) > 1 and kes[-1].dim() == 2:
        kc_inv, kes = kes[-1], kes[:-1]
    chain = mesh_chain(md, 8)
    levels = [_make_level(chain[i], Ke) for i, Ke in enumerate(kes)]
    if kc_inv is not None:
        levels[-1].kc_inv = kc_inv
    elif _coarse_dense(levels[-1]):
        levels[-1].kc_inv = _dense_coarse_inv(levels[-1])
    return levels


def _smooth(level: MGLevel, x, b, nu, zero_start=False):
    """``nu`` smoothing sweeps on K x = b: damped Jacobi, or with
    ``SMOOTHER = 'chebyshev'`` a degree-``nu`` Chebyshev polynomial in
    D^-1 K on [1.1 lmax / 4, 1.1 lmax] (the 3-D ``fe3d._smooth3``).
    ``b`` and ``x`` hold 0 on fixed dofs, and so does the result: each
    residual weights K x by ``level.free``.  ``zero_start=True`` means
    x == 0 (``x`` may be None), so the first residual is b (Chebyshev) or
    the first sweep x = OMEGA D^-1 b (Jacobi), without an apply."""
    if SMOOTHER == 'chebyshev' and level.lmax is not None:
        lmax = 1.1 * level.lmax
        lmin = lmax / 4.
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        r = b if zero_start else \
            torch.addcmul(b, level.free, _kx(level, x), value=-1)
        d = level.cinv * r / theta
        rho = 1. / sigma
        for _ in range(max(nu, 1)):
            x = d if x is None else x + d
            r = torch.addcmul(r, level.free, _kx(level, d), value=-1)
            rho_new = 1. / (2. * sigma - rho)
            d = rho_new * rho * d + 2. * rho_new / delta * level.cinv * r
            rho = rho_new
        return x
    if zero_start:
        x = level.jinv * b
        nu = nu - 1
    for _ in range(nu):
        x = torch.addcmul(x, level.jinv, torch.addcmul(
            b, level.free, _kx(level, x), value=-1))
    return x


def v_cycle(levels, b, lvl=0, nu=2):
    """One symmetric V-cycle solving K e = b approximately from zero, on
    stacked planes; e is 0 on fixed dofs."""
    level = levels[lvl]
    b = b.masked_fill(level.fixed, 0.)
    if lvl == len(levels) - 1:
        if level.kc_inv is not None:
            # the dense inverse leaves round-off on fixed dofs
            x = level.kc_inv @ b.reshape(-1)
            return x.reshape(b.shape).masked_fill_(level.fixed, 0.)
        return _smooth(level, None, b, 8 * nu, zero_start=True)
    x = _smooth(level, None, b, nu, zero_start=True)
    r = torch.addcmul(b, level.free, _kx(level, x), value=-1)
    e = prolong_mm(v_cycle(levels, restrict_mm(r, level.W), lvl + 1, nu),
                   level.W)
    return _smooth(level, torch.addcmul(x, level.free, e), b, nu)


@profiling.spanned('cg')
def mg_cg_solve(levels, b, x0, tol=1.e-8, maxiter=200, nu=2):
    """CG with a V-cycle preconditioner on the finest level, ``b`` and
    ``x0`` stacked (2, nnX, nnY) planes (``x0`` holds the prescribed values
    on fixed dofs, which stay).

    Exits at ``|r| <= tol |b|``, at ``maxiter``, or (float32 only) after
    4 consecutive iterations below 1e-3 relative that improve the best
    residual by less than 5%: the f32 rounding floor, where further Krylov
    work makes no progress.  Returns (x, relative residual, iterations)."""
    level = levels[0]
    fix = level.fixed
    r = (b - _apply(level, x0)).masked_fill_(fix, 0.)
    bnorm = max(profiling.host_read(torch.linalg.vector_norm(b), 'cg'), 1e-30)
    b_f32 = r.dtype == torch.float32
    x, p, rz_prev = x0, None, None
    it, nstall = 0, 0
    rn = best = profiling.host_read(torch.linalg.vector_norm(r), 'cg')
    while rn > tol * bnorm and it < maxiter and nstall < 4:
        z = v_cycle(levels, r, nu=nu)
        rz = _dot(r, z)
        p = z if it == 0 else torch.addcmul(z, rz / rz_prev, p)
        # identity rows on fixed dofs, where p (as z and r) is 0: r stays
        # 0 there without a mask
        Ap = torch.where(fix, p, _kx(level, p))
        alpha = rz / _dot(p, Ap)
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, Ap, value=-1)
        # host read of the residual norm once per iteration (the exit test)
        rn = profiling.host_read(torch.linalg.vector_norm(r), 'cg')
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
