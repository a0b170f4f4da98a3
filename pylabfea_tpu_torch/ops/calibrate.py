"""Plastic-parameter identification by derivatives through the return map
(the port of ``pylabfea_tpu.ops.calibrate``).

The stress response along measured strain paths is integrated with
``constitutive.response_fast(fixed_trip=True)`` (no host read, exactly
``maxiter`` Newton trips), or with a backward-Euler projection whose
derivative comes from the implicit-function theorem (``integrator=
'implicit'``), and the stress misfit is minimized over the yield strength,
the six Hill coefficients, the hardening modulus and optionally Voce
saturation, the Drucker coefficient and the 21 elastic constants, by
Levenberg-Marquardt with the Jacobian from forward mode (``dual.jacfwd``:
every column in one batched pass).  The implicit projection is also a
``torch.autograd.Function`` whose ``jvp`` and ``backward`` are the
implicit formulas, so ``torch.autograd``, ``forward_ad`` and
``torch.func`` take its derivatives too.

    params, info = calibrate.fit_plasticity(deps_paths, sig_paths, CV)

``deps_paths`` and ``sig_paths`` are (npaths, nsteps, 6): per-step strain
increments (Voigt, engineering shear) and the stresses after each step.
Every function follows the device of its tensor inputs; numpy inputs go
to the card unless ``device`` names another device.

The fit shards over paths (``fit_plasticity(ranks=...)``): each rank holds
its own paths, and what is global is reduced over the ranks (the seed's
statistics on the gathered paths, the strain scale, the stress scale, the
weights' mean, the cost and the normal equations J'J, J'r), so every rank
takes the same Levenberg-Marquardt steps to the same parameters.
"""
import time

import numpy as np
import torch

from pylabfea_tpu_torch.config import resolve_device
from pylabfea_tpu_torch.ops import constitutive as con
from pylabfea_tpu_torch.ops import dual
from pylabfea_tpu_torch.ops import graphs
from pylabfea_tpu_torch.ops import jtensors as jt


def _softplus(x):
    """log(1 + exp(x)) without a linear cut-off (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _material_of(theta, peeq_ref=1.):
    """Positive-parameterized analytic DeviceMaterial whose scalars are
    0-d tensors that carry derivatives: sy = exp(log_sy), hill =
    exp(log_hill), khard = softplus(raw_dsy) / peeq_ref (the hardening
    parameter at stress scale); optional keys 'raw_vr' (voce_r =
    softplus) and 'log_vb_peeq' (voce_b = exp / peeq_ref) switch on Voce
    saturation, 'drucker' (raw) the Drucker term."""
    x = theta['log_sy']
    zeros = x.new_zeros
    sy = torch.exp(x)
    voce = 'raw_vr' in theta
    return con.DeviceMaterial(
        hill=torch.exp(theta['log_hill']), sv=zeros((1, 6)), dc=zeros(1),
        sy=sy, khard=_softplus(theta['raw_dsy']) / peeq_ref,
        drucker=theta['drucker'] if 'drucker' in theta else zeros(()),
        rho=0., gamma=1., scale_seq=sy,
        voce_r=_softplus(theta['raw_vr']) if voce else zeros(()),
        voce_b=(torch.exp(theta['log_vb_peeq']) / peeq_ref if voce
                else x.new_ones(())),
        is_svc=False)


#: sqrt of a typical stiffness entry: keeps the Cholesky parameters O(1)
_CV_SCALE = 450.
_TRIL = np.tril_indices(6)


def _cv_of(raw):
    """Symmetric positive-definite 6x6 stiffness C = L L^T from a raw
    21-vector of the lower triangle (row-major order), scaled so that O(1)
    entries give O(2e5) moduli.  L is placed by a 0/1 selection product,
    so the map runs under ``torch.func`` transforms."""
    S = np.zeros((21, 36))
    S[np.arange(21), _TRIL[0] * 6 + _TRIL[1]] = 1.
    S = torch.as_tensor(S, dtype=raw.dtype, device=raw.device)
    L = ((raw * _CV_SCALE) @ S).reshape(6, 6)
    return L @ L.T


def _cv_raw_of(CV):
    """Inverse of ``_cv_of``: the raw 21-vector of an SPD stiffness."""
    CV = CV.detach().cpu().numpy() if isinstance(CV, torch.Tensor) else CV
    L = np.linalg.cholesky(np.asarray(CV, float))
    return L[_TRIL] / _CV_SCALE


# -----------------------------------------------------------------
# backward-Euler projection with implicit derivatives
# -----------------------------------------------------------------
_MAT_KEYS = ('hill', 'sy', 'khard', 'drucker', 'voce_r', 'voce_b')


def _be_residual(z, plastic, sig_tr, epl_in, CV, scale_r, hill, sy, khard,
                 drucker, voce_r, voce_b):
    """Residual of the closest-point projection per lane, z = [sig (6),
    dlam]: R_sig = sig - sig_tr + dlam C a(sig), R_f = f(sig, peeq(epl_in
    + dlam a)) / scale_r on plastic lanes; elastic lanes pinned to the
    trial stress and dlam = 0."""
    m = con.DeviceMaterial(hill=hill, sv=hill.new_zeros((1, 6)),
                           dc=hill.new_zeros(1), sy=sy, khard=khard,
                           drucker=drucker, rho=0., gamma=1., scale_seq=sy,
                           voce_r=voce_r, voce_b=voce_b)
    sig, dlam = z[..., :6], z[..., 6]
    a = con.fgrad(m, sig)
    peeq = jt.eps_eq(epl_in + dlam[..., None] * a)
    r_sig = sig - sig_tr + dlam[..., None] * (a @ CV.T)
    r_f = con.yf(m, sig, peeq) / scale_r
    r_pl = torch.cat([r_sig, r_f[..., None]], -1)
    r_el = torch.cat([sig - sig_tr, dlam[..., None]], -1)
    return torch.where(plastic[..., None], r_pl, r_el)


def _lane_jac(f, z):
    """Per-lane (N, 7, 7) Jacobian of a lane-diagonal map at ``z``: one
    evaluation on a Dual with the 7 one-hot tangents broadcast over the
    lanes."""
    eye = torch.eye(7, dtype=z.dtype, device=z.device)
    return torch.movedim(f(dual.Dual(z, eye[:, None, :].expand(
        7, *z.shape))).t, 0, -1)


def _solve7(J, r):
    """Batched 7x7 solve with no host synchronization."""
    return torch.linalg.solve_ex(J, r[..., None])[0][..., 0]


def _be_solve_eager(z0, iters, plastic, args):
    def f(z):
        return _be_residual(z, plastic, *args)
    z = z0
    for _ in range(iters):
        z = z - _solve7(_lane_jac(f, z), f(z))
    return z


def _be_tangent_eager(z, plastic, args, dargs):
    dr = _be_residual(z, plastic, *dargs)
    J = _lane_jac(lambda zz: _be_residual(zz, plastic, *args), z)
    return -_solve7(J.expand(dr.t.shape[0], *J.shape), dr.t)


#: ``iters`` Newton steps on the projection residual from ``z0``
#: (replayed from CUDA graphs on the card, ``graphs.Graphed``)
_be_solve = graphs.Graphed(_be_solve_eager)
#: implicit tangents of z* for the argument tangents ``dargs`` (K columns
#: of Duals): dz = -J^-1 dR/dargs dargs, J = dR/dz at z*
_be_tangent = graphs.Graphed(_be_tangent_eager)


class _BEProject(torch.autograd.Function):
    """z* with R(z*) = 0 by ``iters`` Newton steps, recorded as one node:
    its forward-mode and reverse-mode derivatives are one batched 7x7
    solve each with the lane Jacobian dR/dz at z* (the implicit-function
    theorem), so they are bounded whatever the iteration count and cost
    no memory per iteration (the JAX ``lax.custom_root``)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(z0, iters, plastic, *args):
        return _be_solve(z0, iters, plastic, tuple(args))

    @staticmethod
    def setup_context(ctx, inputs, output):
        z0, iters, plastic, *args = inputs
        ctx.save_for_forward(output, plastic, *args)
        ctx.save_for_backward(output, plastic, *args)

    @staticmethod
    def jvp(ctx, dz0, diters, dplastic, *dargs):
        z, plastic, *args = ctx.saved_tensors
        duals = tuple(a if d is None else dual.Dual(a, d[None])
                      for a, d in zip(args, dargs))
        return _be_tangent(z, plastic, tuple(args), tuple(duals))[0]

    @staticmethod
    def backward(ctx, gz):
        z, plastic, *args = ctx.saved_tensors
        J = _lane_jac(lambda zz: _be_residual(zz, plastic, *args), z)
        w = _solve7(J.transpose(-1, -2), gz)
        _, vjp_fn = torch.func.vjp(lambda *a: _be_residual(z, plastic, *a),
                                   *args)
        grads = vjp_fn(-w)
        return (None, None, None) + tuple(
            g if a.requires_grad else None for g, a in zip(grads, args))


def _be_project(m, sig_in, epl_in, deps, CV, iters=12):
    """One backward-Euler closest-point projection with implicit
    derivatives (``_BEProject``; on Dual inputs the same implicit tangents
    directly); elastic lanes keep the trial stress.  Returns (sig, depl)."""
    sig_tr = sig_in + deps @ CV.T
    peeq_in = jt.eps_eq(epl_in)
    toler = con.flow_stress(m, peeq_in) * 5e-3
    plastic = con.yf(m, sig_tr, peeq_in) > toler
    scale_r = torch.max(torch.abs(CV))
    v_tr = dual.value(sig_tr)
    z0 = torch.cat([v_tr, v_tr.new_zeros(v_tr.shape[:-1] + (1,))], -1)
    mats = tuple(x if isinstance(x, (torch.Tensor, dual.Dual)) else
                 v_tr.new_tensor(x) for x in (getattr(m, k)
                                              for k in _MAT_KEYS))
    args = (sig_tr, epl_in, CV, scale_r) + mats
    if dual.is_dual(*args):
        vals = tuple(dual.value(a) for a in args)
        z = _be_solve(z0, int(iters), plastic, vals)
        z = dual.Dual(z, _be_tangent(z, plastic, vals, args))
    else:
        z = _BEProject.apply(z0, int(iters), plastic, *args)
    sig, dlam = z[..., :6], z[..., 6]
    depl = torch.where(plastic[..., None], dlam[..., None] * con.fgrad(m, sig),
                       0.)
    return torch.where(plastic[..., None], sig, sig_tr), depl


def simulate_paths(theta, CV, deps_paths, maxiter=12, nsub=1, peeq_ref=1.,
                   integrator='unrolled'):
    """Integrate the return map along strain paths (npaths, nsteps, 6);
    returns the (npaths, nsteps, 6) stresses after each step,
    differentiable w.r.t. the tensors of ``theta`` (and ``CV``).  A theta
    key 'cv_raw' (Cholesky 21-vector) overrides ``CV``.

    ``integrator='unrolled'`` differentiates through the production
    cutting-plane loop (``response_fast(fixed_trip=True)``); 'implicit'
    uses the backward-Euler projection with implicit derivatives
    (``_be_project``), bounded near the Drucker cone apex where the
    unrolled derivative expands."""
    if 'cv_raw' in theta:
        CV = _cv_of(theta['cv_raw'])
    m = _material_of(theta, peeq_ref)
    sig = deps_paths.new_zeros((deps_paths.shape[0], 6))
    epl = torch.zeros_like(sig)
    hist = []
    for k in range(deps_paths.shape[1]):
        if integrator == 'implicit':
            sig, depl = _be_project(m, sig, epl, deps_paths[:, k], CV,
                                    iters=maxiter)
        else:
            _, sig, depl, _ = con.response_fast(
                m, (sig, epl), deps_paths[:, k], CV, maxiter, nsub,
                fixed_trip=True)
        epl = epl + depl
        hist.append(sig)
    return torch.stack(hist, 1)


def _np(x):
    return x.detach().cpu().double().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, float)


def _seq_np(sig):
    return jt.seq_j2_voigt(torch.as_tensor(_np(sig))).numpy()


def _eeq_np(eps):
    return jt.eps_eq(torch.as_tensor(_np(eps))).numpy()


def estimate_init(deps_paths, sig_paths, hardening='linear',
                  fit_drucker=False):
    """Slope-based {sy, hill, khard [, voce_r, voce_b, drucker]} seed from
    the raw data (the JAX ``estimate_init``, on the host): per path the
    elastic slope of the first two samples and the hardening slope over
    the last quarter give khard (series compliance) and sy (the legs'
    intersection); Voce and Drucker seeds come from one least-squares
    fit of the pooled flow curve per node of a grid over voce_b."""
    seq_p = _seq_np(sig_paths)
    eeq_p = _eeq_np(np.cumsum(_np(deps_paths), axis=1))
    nst = seq_p.shape[1]
    if nst < 4:
        init = {'sy': 0.9 * float(seq_p.max()), 'hill': np.ones(6),
                'khard': 1.0}
        if hardening == 'voce':
            init.update(voce_r=0.3 * init['sy'], voce_b=100.)
        if fit_drucker:
            init['drucker'] = 0.
        return init
    tail = max(nst // 4, 2)
    khs, sys_, sels = [], [], []
    for s, e in zip(seq_p, eeq_p):
        s_el = (s[1] - s[0]) / max(e[1] - e[0], 1e-16)
        s_pl = (s[-1] - s[-tail]) / max(e[-1] - e[-tail], 1e-16)
        if 0. < s_pl < 0.9 * s_el:
            khs.append(1. / max(1. / s_pl - 1. / s_el, 1e-16))
            e_y = (s[-1] - s_pl * e[-1]) / (s_el - s_pl)
            sys_.append(s_el * e_y)
            sels.append(s_el)
    if not khs:
        return {'sy': 0.9 * float(seq_p.max()), 'hill': np.ones(6),
                'khard': 1.0}
    init = {'sy': float(np.median(sys_)), 'hill': np.ones(6),
            'khard': float(np.median(khs))}
    voce = hardening == 'voce'
    if not (voce or fit_drucker):
        return init
    s_el = float(np.median(sels))
    pe, sq, i1 = [], [], []
    for s, e, sg in zip(seq_p, eeq_p, _np(sig_paths)):
        p = e - s / s_el
        sel = p > 0.05 * p[-1] if p[-1] > 0 else p > 0
        pe.append(p[sel])
        sq.append(s[sel])
        i1.append(sg[sel, 0:3].sum(axis=-1))
    pe, sq, i1 = np.concatenate(pe), np.concatenate(sq), np.concatenate(i1)
    fallback_vb = 2. / max(float(pe.max()) if pe.size else 0., 1e-4)
    if pe.size < 8:
        if voce:
            init.update(voce_r=0.3 * init['sy'], voce_b=fallback_vb)
        if fit_drucker:
            init['drucker'] = 0.
        return init
    cols = [np.ones_like(pe), pe]
    if fit_drucker:
        cols.append(-i1 / 3.)
    best = None
    vb_grid = (np.geomspace(0.25 / pe.max(), 25. / pe.max(), 24) if voce
               else [None])
    for vb in vb_grid:
        A = np.stack(cols + ([-np.expm1(-vb * pe)] if voce else []), axis=1)
        coef, *_ = np.linalg.lstsq(A, sq, rcond=None)
        r = float(np.sum((A @ coef - sq) ** 2))
        if (not voce or coef[-1] >= 0.) and (best is None or r < best[0]):
            best = (r, coef, vb)
    if best is None:
        if voce:
            init.update(voce_r=0.3 * init['sy'], voce_b=fallback_vb)
        if fit_drucker:
            init['drucker'] = 0.
        return init
    _, coef, vb0 = best
    init.update(sy=max(float(coef[0]), 1e-3),
                khard=max(float(coef[1]), 1e-3))
    k = 2
    if fit_drucker:
        init['drucker'] = float(coef[k])
        k += 1
    if voce:
        init.update(voce_r=max(float(coef[k]), 1e-3), voce_b=float(vb0))
    return init


def ravel_theta(theta):
    """(x, unravel): the tensors of ``theta`` raveled in sorted key order
    (``jax.flatten_util.ravel_pytree``'s order for a dict) and the inverse
    map x -> dict of views."""
    keys = sorted(theta)
    shapes = [tuple(theta[k].shape) for k in keys]
    sizes = [int(np.prod(s)) for s in shapes]
    x = torch.cat([theta[k].reshape(-1) for k in keys])

    def unravel(v):
        out, pos = {}, 0
        for k, s, n in zip(keys, shapes, sizes):
            out[k] = v[pos:pos + n].reshape(s)
            pos += n
        return out
    return x, unravel


def _identity(t):
    return t


def levenberg_marquardt(resid, jac, x, steps, tries, reduce=_identity):
    """Levenberg-Marquardt on r(x): damping from 1e-3, x0.3 on a
    descending step, x4 on a failed try (``tries`` a step); stops at a
    cost below 1e-24 or a damping above 1e18.  ``reduce`` sums the cost
    and the normal equations over the ranks of a sharded residual
    (``RankMesh.sum``).  Returns (x, cost history, seconds of each
    step)."""
    r = resid(x)
    cost = float(reduce(r @ r))
    hist, secs = [cost], []
    lam = 1e-3
    for _ in range(steps):
        t0 = time.perf_counter()
        J = jac(x)
        JTJ, JTr = reduce(J.T @ J), reduce(J.T @ r)
        for _ in range(tries):
            A = JTJ + lam * torch.diag(torch.clamp(torch.diagonal(JTJ),
                                                   min=1e-12))
            dx = torch.linalg.solve(A, -JTr)
            r_new = resid(x + dx)
            c_new = float(reduce(r_new @ r_new))
            if c_new < cost:
                x, r, cost = x + dx, r_new, c_new
                lam = max(lam * 0.3, 1e-14)
                break
            lam *= 4.
        hist.append(cost)
        secs.append(time.perf_counter() - t0)
        if cost < 1e-24 or lam > 1e18:
            break
    return x, hist, secs


def _inv_softplus(v):
    return float(np.log(np.expm1(v) + 1e-300)) if v < 30. else v


def _placed(a, dtype=None, device=None):
    """``a`` as a tensor: a tensor keeps its device (and dtype unless one
    is given), anything else goes to ``device`` (the card when None)."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=dtype or a.dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=resolve_device(device))


def fit_plasticity(deps_paths, sig_paths, CV, init=None, steps=80,
                   maxiter=40, nsub=1, weights=None, gauge='uniax_x',
                   hardening='linear', deviatoric=False,
                   fit_drucker=False, fit_CV=False, integrator='unrolled',
                   device=None, ranks=None):
    """Identify {sy, hill (6), khard} (and, as asked, Voce's voce_r and
    voce_b, the Drucker coefficient, the elastic CV) from measured stress
    paths (the JAX ``fit_plasticity``): Levenberg-Marquardt on the stacked
    relative stress residual, with the Jacobian from forward mode through
    the return-map scan (``dual.jacfwd``, every column in one pass).

    ``init`` seeds {'sy', 'hill', 'khard'} (default ``estimate_init``);
    ``weights`` (npaths,) reweights paths; ``maxiter`` is the projection
    budget, large enough that every lane converges (12 strands the fit).
    ``gauge='uniax_x'`` pins the exact Hill gauge ray (hill c, sy sqrt(c),
    khard sqrt(c)) by 0.5 (hill[0] + hill[2]) = 1.  ``deviatoric`` fits the
    deviatoric stresses only.  ``fit_drucker`` wants paths with bounded
    hydrostatic drift (the unrolled derivative expands near the Drucker
    cone apex, which ``integrator='implicit'`` avoids).

    ``ranks`` (a ``parallel.distributed.RankMesh``) shards the fit over
    paths: ``deps_paths``, ``sig_paths`` (and ``weights``) are this rank's
    paths (at least one), every rank returns the same parameters, and
    info['sim'] holds the rank's own paths.

    Returns (params dict with 'sy'/'hill'/'khard' [+'voce_r'/'voce_b',
    'drucker', 'CV'], info dict with the cost history 'loss', the
    simulated paths 'sim', 'param_std' and the seconds of each LM step
    'step_s')."""
    deps_paths = _placed(deps_paths, device=device)
    dt, dev = deps_paths.dtype, deps_paths.device
    sig_paths = _placed(sig_paths, dt, dev).to(dev)
    CV = _placed(CV, dt, dev).to(dev)
    if ranks is None or ranks.size == 1:
        ranks = None
        rsum, rmax = _identity, _identity
    else:
        rsum, rmax = ranks.sum, ranks.max
    if init is None:
        init = estimate_init(_gather_paths(ranks, deps_paths),
                             _gather_paths(ranks, sig_paths), hardening,
                             fit_drucker)
    eps_tot = torch.cumsum(deps_paths, dim=1)
    peeq_ref = float(rmax(torch.max(jt.eps_eq(eps_tot.reshape(-1, 6))))) \
        or 1.
    dsy0 = max(float(init['khard']) * peeq_ref, 1e-6)

    def ten(v):
        return torch.as_tensor(np.asarray(v, float), dtype=dt, device=dev)

    theta = {'log_sy': ten(np.log(float(init['sy']))),
             'log_hill': ten(np.log(np.asarray(init['hill'], float))),
             'raw_dsy': ten(_inv_softplus(dsy0))}
    if hardening == 'voce':
        vr0 = max(float(init.get('voce_r', 0.5 * dsy0 / peeq_ref)), 1e-3)
        vb0 = max(float(init.get('voce_b', 2. / peeq_ref)), 1e-6)
        theta['raw_vr'] = ten(_inv_softplus(vr0))
        theta['log_vb_peeq'] = ten(np.log(vb0 * peeq_ref))
    elif hardening != 'linear':
        raise ValueError(f'unknown hardening model {hardening!r}')
    if fit_drucker:
        theta['drucker'] = ten(float(init.get('drucker', 0.)))
    if fit_CV:
        theta['cv_raw'] = ten(_cv_raw_of(CV))
    scale = torch.clamp(torch.sqrt(_mean(ranks, sig_paths ** 2)), min=1e-12)
    if weights is None:
        w = torch.ones((), dtype=dt, device=dev)
    else:
        w = ten(weights)
        w = (w / _mean(ranks, w))[:, None, None]
    x0, unravel = ravel_theta(theta)

    def _dev(s):
        if not deviatoric:
            return s
        p = torch.mean(s[..., 0:3], dim=-1, keepdim=True)
        return torch.cat([s[..., 0:3] - p, s[..., 3:]], -1)

    sig_cmp = _dev(sig_paths)

    def resid(x):
        sim = simulate_paths(unravel(x), CV, deps_paths, maxiter, nsub,
                             peeq_ref, integrator)
        return (torch.sqrt(w) * (_dev(sim) - sig_cmp) / scale).reshape(-1)

    def jac(x):
        return dual.jacfwd(resid, x)[1]

    x, hist, secs = levenberg_marquardt(resid, jac, x0, steps, 16, rsum)
    theta = unravel(x)
    params = {'sy': float(torch.exp(theta['log_sy'])),
              'hill': _np(torch.exp(theta['log_hill'])),
              'khard': float(_softplus(theta['raw_dsy'])) / peeq_ref}
    if hardening == 'voce':
        params['voce_r'] = float(_softplus(theta['raw_vr']))
        params['voce_b'] = float(torch.exp(theta['log_vb_peeq'])) / peeq_ref
    if fit_drucker:
        params['drucker'] = float(theta['drucker'])
    if fit_CV:
        params['CV'] = _np(_cv_of(theta['cv_raw']))
    if gauge == 'uniax_x':
        c = 0.5 * (params['hill'][0] + params['hill'][2])
        rc = float(np.sqrt(c))
        params['sy'] = params['sy'] / rc
        params['hill'] = params['hill'] / c
        params['khard'] = params['khard'] / rc
        if 'voce_r' in params:
            params['voce_r'] = params['voce_r'] / rc
        if 'drucker' in params:
            params['drucker'] = params['drucker'] / rc
    with torch.no_grad():
        sim = simulate_paths(theta, CV, deps_paths, maxiter, nsub, peeq_ref,
                             integrator)
    info = {'loss': hist, 'sim': _np(sim), 'step_s': secs,
            'param_std': _param_std(jac, x, hist[-1], theta, peeq_ref,
                                    rsum)}
    return params, info


def _mean(ranks, t):
    """The mean of ``t`` over every rank's entries (a 0-d tensor)."""
    if ranks is None:
        return torch.mean(t)
    tot = ranks.sum(torch.stack([torch.sum(t), t.new_tensor(t.numel())]))
    return tot[0] / tot[1]


def _gather_paths(ranks, t):
    """Every rank's paths (npaths_r, nsteps, 6) in position order (the
    paths themselves where ``ranks`` is None): counts, then the paths
    padded to the largest count, exchanged."""
    if ranks is None:
        return t
    counts = ranks.exchange(torch.tensor([t.shape[0]], device=t.device))
    counts = [int(c) for c in counts.reshape(-1)]
    pad = t.new_zeros((max(counts),) + tuple(t.shape[1:]))
    pad[:t.shape[0]] = t
    allp = ranks.exchange(pad)
    return torch.cat([allp[p, :n] for p, n in enumerate(counts)])


def _sigmoid(x):
    return 1. / (1. + np.exp(-x))


def _param_std(jac, x, cost, theta, peeq_ref, reduce=_identity):
    """Gauss-Newton standard errors of the natural parameters at the
    optimum: cov = s^2 pinv(J'J) with s^2 = cost / (m - n), mapped through
    each transform by the delta method, in the raw gauge (the gauge ray
    is a null direction of J'J, which the pseudo-inverse drops).  None at
    an exact-interpolation floor.  ``reduce`` sums J'J and the row count
    m over the ranks of a sharded fit."""
    Jt = jac(x)
    J = _np(Jt)
    JTJ = J.T @ J
    m, n = J.shape
    if reduce is not _identity:
        JTJ = _np(reduce(torch.as_tensor(JTJ, device=Jt.device)))
        m = int(reduce(torch.tensor(float(m), dtype=torch.float64,
                                    device=Jt.device)))
    if m <= n or cost < 1e-22:
        return None
    cov = np.linalg.pinv(JTJ, rcond=1e-10) * (cost / (m - n))
    if not np.all(np.isfinite(cov)):
        return None
    sd = np.sqrt(np.maximum(np.diag(cov), 0.))
    out, pos = {}, 0
    for k in sorted(theta):
        size = int(np.prod(theta[k].shape)) or 1
        s = sd[pos:pos + size]
        v = _np(theta[k]).reshape(-1)
        if k == 'log_sy':
            out['sy'] = float(np.exp(v[0]) * s[0])
        elif k == 'log_hill':
            out['hill'] = np.exp(v) * s
        elif k == 'raw_dsy':
            out['khard'] = float(_sigmoid(v[0]) * s[0]) / peeq_ref
        elif k == 'raw_vr':
            out['voce_r'] = float(_sigmoid(v[0]) * s[0])
        elif k == 'log_vb_peeq':
            out['voce_b'] = float(np.exp(v[0]) * s[0]) / peeq_ref
        elif k == 'drucker':
            out['drucker'] = float(s[0])
        elif k == 'cv_raw':
            out['cv_raw'] = s
        pos += size
    return out


def resample_paths(records, nsteps=30, eps_max=None, cluster=2.0,
                   dtype=torch.float64, device=None):
    """Rectangularize per-load-case curves for the fit: records {key:
    {'Stress': (N, 6), 'Strain_Total': (N, 6)}} (onset-only or shorter
    than 4 rows skipped), each re-interpolated onto ``nsteps`` increments
    of total equivalent strain up to ``eps_max`` (default: the shortest
    case's reach), power-law clustered toward zero strain (node j at
    cap (j/n)^cluster).  Returns (deps_paths, sig_paths) tensors (npaths,
    nsteps, 6) on the card, or on ``device``."""
    curves = []
    for rec in records.values():
        eps = np.asarray(rec.get('Strain_Total', np.zeros((0, 6))),
                         dtype=float)
        if eps.ndim != 2 or eps.shape[0] < 4:
            continue
        sig = np.asarray(rec['Stress'], dtype=float)
        arc = _eeq_np(eps)
        # strictly increasing arc length: keep the points above the running
        # maximum
        run = np.maximum.accumulate(arc)
        keep = arc > np.concatenate([[-np.inf], run[:-1] + 1e-12])
        curves.append((arc[keep], eps[keep], sig[keep]))
    if not curves:
        raise ValueError('no full-curve load cases in records')
    reach = min(arc[-1] for arc, _, _ in curves)
    cap = reach if eps_max is None else min(eps_max, reach)
    grid = cap * (np.arange(1, nsteps + 1) / nsteps) ** cluster
    eps_r = np.zeros((len(curves), nsteps, 6))
    sig_r = np.zeros((len(curves), nsteps, 6))
    for p, (arc, eps, sig) in enumerate(curves):
        for k in range(6):
            eps_r[p, :, k] = np.interp(grid, arc, eps[:, k])
            sig_r[p, :, k] = np.interp(grid, arc, sig[:, k])
    deps = np.diff(eps_r, axis=1, prepend=np.zeros((len(curves), 1, 6)))
    device = resolve_device(device)
    return (torch.as_tensor(deps, dtype=dtype, device=device),
            torch.as_tensor(sig_r, dtype=dtype, device=device))


def fit_from_data(db, CV=None, nsteps=30, eps_max=None,
                  shear_convention='engineering', deviatoric=True,
                  device=None, **fit_kw):
    """Identify {sy, hill, khard} from a database: any object with the
    full-curve records ``lc_data`` (and optionally the fitted
    ``mat_data['elast_const']``), or a bare records dict (then ``CV`` is
    required unless the convention is 'tensor').  The fit is deviatoric by
    default.  ``shear_convention='tensor'`` (CPFEM databases storing
    tensor shear components eps_ij) doubles the shear strains and refits
    the elastic stiffness from the pre-yield samples of the converted
    paths (an explicit ``CV`` must be engineering-convention).  Remaining
    kwargs go to ``fit_plasticity``; info['CV'] is the stiffness used."""
    records = getattr(db, 'lc_data', None)
    if records is None:
        if isinstance(db, dict):
            records = db
        else:
            raise ValueError('database carries no load-case records '
                             '(lc_data is unset)')
    deps, sig = resample_paths(records, nsteps, eps_max, device=device)
    if shear_convention == 'tensor':
        deps = torch.cat([deps[..., :3], 2. * deps[..., 3:]], -1)
    elif shear_convention != 'engineering':
        raise ValueError(f'unknown shear_convention {shear_convention!r}')
    if CV is None and shear_convention == 'engineering':
        CV = getattr(db, 'mat_data', {}).get('elast_const')
    if CV is None:
        seq = _seq_np(sig)
        eps_c = np.cumsum(_np(deps), axis=1)
        keep = seq < 0.5 * seq.max(axis=1, keepdims=True)
        if keep.sum() < 12:
            raise ValueError('too few pre-yield samples to fit the elastic '
                             'stiffness: pass CV explicitly')
        from pylabfea_tpu_torch.dataio import get_elastic_coefficients
        CV = get_elastic_coefficients(eps_c[keep], _np(sig)[keep])
    params, info = fit_plasticity(deps, sig, _np(CV), deviatoric=deviatoric,
                                  **fit_kw)
    info['CV'] = _np(CV)
    return params, info
