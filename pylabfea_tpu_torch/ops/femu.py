"""Differentiable FE: implicit-function-theorem derivatives through the
equilibrium solve, and full-field model updating (the port of
``pylabfea_tpu.ops.femu``).

A displacement-controlled load step converges to the fixed point

    G(du) = K(C_sec(du)) du - rhs(bc) = 0

with C_sec the exact path secant of the fixed-trip return map.  The
forward solve is the production inner loop (an elastic flat solve, then
``n_inner`` secant-Picard rounds of return map and Jacobi-CG), detached;
the derivative of the converged du w.r.t. the material parameters, the
entering state and the prescribed increment is one linear tangent solve
at the solution (BiCGStab on the linearized residual, the semantics of
``jax.scipy.sparse.linalg.bicgstab``) and never a derivative through
solver iterations.  The linearized residual is built from the per-element
derivative of the secant w.r.t. the element strain (one forward-mode pass
of the return map with 6 tangents), so a BiCGStab product costs a few
element contractions and no return map.

Forward mode only, as in the JAX package: ``step_implicit`` is a
``torch.autograd.Function`` with a ``jvp`` (``forward_ad`` and
``torch.func.jvp``, one tangent column at a time), and on ``dual.Dual``
inputs it pushes every column through in one pass (``fit_field``'s
Jacobian).  Meshes run on the flat layout (``flatten_mesh``); analytic
material groups only.
"""
import dataclasses

import torch

from pylabfea_tpu_torch.ops import constitutive as con
from pylabfea_tpu_torch.ops import dual
from pylabfea_tpu_torch.ops import fe_kernels as fek
from pylabfea_tpu_torch.ops.calibrate import levenberg_marquardt, \
    ravel_theta


def _respond_ft(md, mats, CVs, sig0, epl0, deps, maxiter, nsub=4):
    """Groups-aware return map in the fixed-trip form: one material and
    stiffness, or tuples of them aligned with ``md.groups`` (the element
    rows gathered by ``perm`` into blocks, the results gathered back by
    ``inv_perm``)."""
    def one(m, C, s, e, d):
        return con.response_fast(m, (s, e), d, C, maxiter, nsub,
                                 fixed_trip=True)

    if md.groups is None:
        return one(mats, CVs, sig0, epl0, deps)
    p = md.perm
    parts = [one(mats[k], CVs[k], sig0[p][a:a + n], epl0[p][a:a + n],
                 deps[p][a:a + n])
             for k, (a, n) in enumerate(md.groups) if n]
    return tuple(torch.cat([q[i] for q in parts])[md.inv_perm]
                 for i in range(4))


def flatten_mesh(md):
    """Structured MeshData -> its flat twin (``grid=None``): the planes
    layout (2, nnX, nnY) ravels to exactly the flat dof order (dof = comp
    * nnode + node), so only the BC tensors change shape, and the element
    dofs are added.  femu runs on the flat path whatever the mesh: its
    meshes are DIC-sized, far below where multigrid pays."""
    if md.grid is None:
        return md
    NX, NY = md.grid[:2]
    return dataclasses.replace(
        md, grid=None, fixed=md.fixed.reshape(-1),
        fixed_val=md.fixed_val.reshape(-1), force=md.force.reshape(-1),
        dofs=torch.as_tensor(fek.grid_dofs(NX, NY), device=md.device))


def _k_full(md, Ke, v):
    """Full K v including the coupling to fixed dofs (``k_apply`` makes
    fixed rows and columns identity, right for the solver but not for the
    equilibrium residual)."""
    fe = torch.einsum('eij,ej->ei', Ke, fek.gather_element(md, v))
    return fek.scatter_element(md, fe)


def _as_cv(C, like):
    if isinstance(C, (torch.Tensor, dual.Dual)):
        return C if C.dtype == like.dtype else C.to(like.dtype)
    return torch.as_tensor(C, dtype=like.dtype, device=like.device)


class _Step:
    """The residual of one step and its pieces, for fixed start state."""

    def __init__(self, md, mats, CVs, sig0, epl0, bc_inc, maxiter):
        self.md, self.mats, self.sig0, self.epl0 = md, mats, sig0, epl0
        self.bc_inc, self.maxiter = bc_inc, maxiter
        like = dual.value(bc_inc)
        self.CVs = (_as_cv(CVs, like) if md.groups is None
                    else tuple(_as_cv(c, like) for c in CVs))
        # residual row scale: free rows carry force units, bc rows
        # displacement units
        cv0 = self.CVs if md.groups is None else self.CVs[0]
        self.scale_r = torch.max(torch.abs(cv0)) * md.jacw

    def csec(self, du):
        deps = fek.element_deps(self.md, du)
        return _respond_ft(self.md, self.mats, self.CVs, self.sig0,
                           self.epl0, deps, self.maxiter)[3]

    def residual(self, du):
        Ke = fek.element_stiffness(self.md, self.csec(du))
        r = _k_full(self.md, Ke, du) / self.scale_r
        return torch.where(self.md.fixed, du - self.bc_inc, r)


def _values(step):
    """The same step with every Dual replaced by its value."""
    return _rebuild(step, [dual.value(f) for f in _flat_inputs(step)])


def _solve_forward(step, n_inner, cg_tol, cg_maxiter):
    """Elastic flat solve, then ``n_inner`` secant-Picard rounds (response
    -> secant field -> Jacobi-CG from the previous du)."""
    md = step.md
    elastic = fek.init_state(md, step.CVs, dtype=step.bc_inc.dtype).elstiff
    du, _, _ = fek.solve_linear(md, elastic, step.bc_inc, cg_tol=cg_tol,
                                cg_maxiter=cg_maxiter)
    for _ in range(n_inner):
        du, _, _ = fek.solve_linear(md, step.csec(du), step.bc_inc,
                                    cg_tol=cg_tol, cg_maxiter=cg_maxiter,
                                    x0=du)
    return du


def bicgstab(A, b, tol=1e-5, maxiter=None):
    """BiCGStab from x0 = 0, unpreconditioned, on the K columns of ``b``
    (K, n) at once, each column exactly as
    ``jax.scipy.sparse.linalg.bicgstab`` runs it alone: it stops at
    |r|^2 <= tol^2 |b|^2, at ``maxiter`` (default 10 n) or at a breakdown
    (rho, alpha or omega = 0), and a column that stopped keeps its
    iterate while the others go on.  ``A`` maps (K, n) -> (K, n).  The
    active columns are read to the host once an iteration."""
    K, n = b.shape
    maxiter = 10 * n if maxiter is None else maxiter

    def vdot(u, w):
        return torch.sum(u * w, dim=1, keepdim=True)

    atol2 = tol * tol * vdot(b, b)
    x = torch.zeros_like(b)
    r = b - A(x)
    rhat, p, q = r, r, r
    one = b.new_ones((K, 1))
    rho, alpha, omega = one, one, one
    k = torch.zeros((K, 1), dtype=torch.long, device=b.device)
    while True:
        active = (vdot(r, r) > atol2) & (k < maxiter) & (k >= 0)
        if not bool(active.any()):
            return x
        rho_ = vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        q_ = A(p_)
        alpha_ = rho_ / vdot(rhat, q_)
        s = r - alpha_ * q_
        early = vdot(s, s) < atol2
        t = A(s)
        omega_ = vdot(t, s) / vdot(t, t)
        x_ = torch.where(early, x + alpha_ * p_,
                         x + (alpha_ * p_ + omega_ * s))
        r_ = torch.where(early, s, s - omega_ * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0), -11, k + 1)
        k_ = torch.where(rho_ == 0, -10, k_)
        x, r, p, q = (torch.where(active, new, old) for new, old in
                      ((x_, x), (r_, r), (p_, p), (q_, q)))
        rho, alpha, omega, k = (torch.where(active, new, old) for new, old
                                in ((rho_, rho), (alpha_, alpha),
                                    (omega_, omega), (k_, k)))


def _tangent_operator(step, du):
    """The linearized residual v -> dG/ddu v at ``du`` on (K, ndof)
    columns: the secant's per-element derivative w.r.t. the element
    strain D (Nel, 6, 6, 6) from one forward-mode pass of the return map
    with the 6 unit strains broadcast over the elements, then per product
    [K(C_sec) v + K(D deps(v)) du] / scale_r on free rows, v on fixed
    ones."""
    md = step.md
    deps = fek.element_deps(md, du)
    eye = torch.eye(6, dtype=du.dtype, device=du.device)
    out = _respond_ft(md, step.mats, step.CVs, step.sig0, step.epl0,
                      dual.Dual(deps, eye[:, None, :].expand(6, *deps.shape)),
                      step.maxiter)[3]
    csec, D = out.v, out.t                      # (Nel,6,6), (6,Nel,6,6)
    Ke = fek.element_stiffness(md, csec)

    def A(V):
        cols = []
        for v in V:
            dsec = torch.einsum('keij,ek->eij', D, fek.element_deps(md, v))
            r = (_k_full(md, Ke, v)
                 + _k_full(md, fek.element_stiffness(md, dsec), du))
            cols.append(torch.where(md.fixed, v, r / step.scale_r))
        return torch.stack(cols)
    return A


def _tangents(step, du, tan_tol, tan_maxiter):
    """(K, ndof) tangents of the converged du for the K tangent columns
    carried by the Duals of ``step``: BiCGStab on dG/ddu x = -dG/dp."""
    dG = step.residual(du)
    if not isinstance(dG, dual.Dual):
        return None
    A = _tangent_operator(_values(step), du)
    return bicgstab(A, -dG.t, tol=tan_tol, maxiter=tan_maxiter)


_MAT_FIELDS = ('hill', 'sy', 'khard', 'drucker', 'voce_r', 'voce_b',
               'scale_seq')


class _StepImplicit(torch.autograd.Function):
    """The converged du of one step as one node: its forward derivative is
    the implicit tangent solve at du (``_tangents``).  Inputs: the step
    (a ``_Step`` with plain tensors, as a non-tensor argument), the
    solver settings, then the tensors that may carry tangents (``flat``,
    see ``_flat_inputs``)."""

    @staticmethod
    def forward(step, settings, *flat):
        return _solve_forward(_rebuild(step, flat), *settings[:3])

    @staticmethod
    def setup_context(ctx, inputs, output):
        step, settings, *flat = inputs
        ctx.step, ctx.settings = step, settings
        ctx.save_for_forward(output, *flat)

    @staticmethod
    def jvp(ctx, dstep, dsettings, *dflat):
        du, *flat = ctx.saved_tensors
        duals = [f if d is None else dual.Dual(f, d[None])
                 for f, d in zip(flat, dflat)]
        step = _rebuild(ctx.step, duals)
        t = _tangents(step, du, *ctx.settings[3:])
        return torch.zeros_like(du) if t is None else t[0]

    @staticmethod
    def backward(ctx, gdu):
        raise NotImplementedError(
            'femu.step_implicit: forward mode only (reverse mode needs a '
            'transposed tangent solve)')


def _mat_list(step):
    return [step.mats] if step.md.groups is None else list(step.mats)


def _flat_inputs(step):
    """The tensors of a step that may carry tangents, in a fixed order:
    every material's fields, the stiffnesses, sig0, epl0 and bc_inc."""
    flat = []
    for m in _mat_list(step):
        flat += [getattr(m, k) for k in _MAT_FIELDS]
    flat += [step.CVs] if step.md.groups is None else list(step.CVs)
    return flat + [step.sig0, step.epl0, step.bc_inc]


def _rebuild(step, flat):
    """``step`` with the tensors of ``_flat_inputs`` replaced by ``flat``."""
    out = _Step.__new__(_Step)
    out.md, out.maxiter = step.md, step.maxiter
    ms, pos = [], 0
    for m in _mat_list(step):
        ms.append(dataclasses.replace(m, **dict(zip(
            _MAT_FIELDS, flat[pos:pos + len(_MAT_FIELDS)]))))
        pos += len(_MAT_FIELDS)
    ncv = 1 if step.md.groups is None else len(step.CVs)
    cvs = flat[pos:pos + ncv]
    pos += ncv
    out.mats = ms[0] if step.md.groups is None else tuple(ms)
    out.CVs = cvs[0] if step.md.groups is None else tuple(cvs)
    out.sig0, out.epl0, out.bc_inc = flat[pos:pos + 3]
    cv0 = out.CVs if step.md.groups is None else out.CVs[0]
    out.scale_r = torch.max(torch.abs(cv0)) * step.md.jacw
    return out


def _tensorize(step):
    """Every float material field of ``step`` as a 0-d tensor (the
    autograd.Function's inputs must be tensors)."""
    like = dual.value(step.bc_inc)
    flat = [f if isinstance(f, (torch.Tensor, dual.Dual)) else
            like.new_tensor(float(f)) for f in _flat_inputs(step)]
    return _rebuild(step, flat)


def step_implicit(md, mats, CVs, sig0, epl0, bc_inc, maxiter=40,
                  n_inner=14, cg_tol=None, cg_maxiter=600,
                  tan_tol=1e-8, tan_maxiter=1200):
    """One displacement-controlled load step with implicit derivatives on
    a flat mesh (``flatten_mesh``).

    ``bc_inc``: the step's prescribed increment on the fixed dofs (the
    layout of ``md.fixed_val``; free entries ignored).  Returns (du, sig_n,
    epl_n), forward-differentiable w.r.t. the tensors of ``mats`` and
    ``CVs``, ``sig0``, ``epl0`` and ``bc_inc``: through ``forward_ad`` or
    ``torch.func.jvp`` (one column), or with ``dual.Dual`` inputs (every
    column in one pass)."""
    step = _tensorize(_Step(md, mats, CVs, sig0, epl0, bc_inc, maxiter))
    settings = (n_inner, cg_tol, cg_maxiter, tan_tol, tan_maxiter)
    flat = _flat_inputs(step)
    if dual.is_dual(*flat):
        plain = _values(step)
        du = _solve_forward(plain, n_inner, cg_tol, cg_maxiter)
        t = _tangents(step, du, tan_tol, tan_maxiter)
        du = du if t is None else dual.Dual(du, t)
    else:
        du = _StepImplicit.apply(step, settings, *flat)
    deps = fek.element_deps(md, du)
    _, sig_n, depl, _ = _respond_ft(md, step.mats, step.CVs, step.sig0,
                                    step.epl0, deps, maxiter)
    return du, sig_n, step.epl0 + depl


def simulate(md, mats, CVs, load_fracs, dtype=torch.float64, maxiter=40,
             **step_kw):
    """``len(load_fracs)`` displacement-controlled steps from the virgin
    state on the flat twin of ``md``; returns (u, sig, epl, du of each
    step), u and the du in the layout of ``md.fixed``, all
    forward-differentiable w.r.t. the material parameters.  Use
    production-sized increments: one step far past yield makes the
    secant-Picard iteration diverge, two half steps converge."""
    shape_in = md.fixed.shape
    md = flatten_mesh(md)
    sig = torch.zeros((md.nel, 6), dtype=dtype, device=md.device)
    epl = torch.zeros_like(sig)
    u = torch.zeros(md.fixed.shape, dtype=dtype, device=md.device)
    dus = []
    for frac in load_fracs:
        bc_inc = md.fixed_val.to(dtype) * frac
        du, sig, epl = step_implicit(md, mats, CVs, sig, epl, bc_inc,
                                     maxiter=maxiter, **step_kw)
        u = u + du
        dus.append(du.reshape(shape_in))
    return u.reshape(shape_in), sig, epl, dus


def fit_field(md, build_mats, theta0, CVs, load_fracs, u_meas, steps=10,
              maxiter=40, **step_kw):
    """Identify material parameters from a measured displacement field
    (virtual DIC / FEMU): Levenberg-Marquardt on r(theta) = (u_sim(theta)
    - u_meas) / max|u_meas|, with the Jacobian from forward mode through
    the implicit steps (``dual.jacfwd``: every column in one pass, one
    tangent solve a step and column).  ``build_mats(theta)`` maps a dict
    of tensors to a DeviceMaterial (or a tuple per mesh group).  Returns
    (theta*, info with the cost history 'loss' and the seconds of each LM
    step 'step_s')."""
    x0, unravel = ravel_theta(theta0)
    scale = max(float(torch.max(torch.abs(u_meas))), 1e-30)

    def resid(x):
        u, _, _, _ = simulate(md, build_mats(unravel(x)), CVs, load_fracs,
                              dtype=u_meas.dtype, maxiter=maxiter, **step_kw)
        return ((u - u_meas) / scale).reshape(-1)

    x, hist, secs = levenberg_marquardt(
        resid, lambda x: dual.jacfwd(resid, x)[1], x0, steps, 12)
    return unravel(x), {'loss': hist, 'step_s': secs}
