"""Batched constitutive update (subset of ``pylabfea_tpu.ops.constitutive``).

Ported: the analytic Hill/J2/Drucker criterion on 6-D Voigt stresses with
linear and Voce hardening; the SVC yield function on 6-D stress features
(``dev_only`` both ways, no work hardening, no texture) with its fused
value + gradient through kernel A (``svc_kernels.svc_f_grad``); and the
production cutting-plane return map ``response_fast`` with the exact
path-secant tangent, for both kinds.  sdim=3 (principal-space) materials,
work-hardening and texture SVC features raise ``NotImplementedError``.
"""
from dataclasses import dataclass

import torch

from pylabfea_tpu_torch.config import yf_tolerance
from pylabfea_tpu_torch.ops import jtensors as jt
from pylabfea_tpu_torch.ops.svc_kernels import svc_f_grad

#: scale on the cutting-plane projection's exit tolerance (1.0 = the
#: reference's yf_tolerance band), as in the JAX module
PROJ_TOL_SCALE = 1.0


@dataclass
class DeviceMaterial:
    """Material parameters on one device (the JAX ``DeviceMaterial``).

    Tensors live on the device the return map runs on; ``gamma``, ``rho``,
    ``sy``, ``khard``, ``drucker``, ``scale_seq``, ``scale_wh`` and the
    Voce constants are host floats, so no kernel call reads a scalar back
    from the device.  Analytic materials hold dummy (1, 6) / (1,) SVC
    tensors, as in the JAX package."""
    hill: torch.Tensor       # (6,)
    sv: torch.Tensor         # (nsv, F) SVC support vectors
    dc: torch.Tensor         # (nsv,) dual coefficients
    sy: float
    khard: float
    drucker: float
    rho: float               # SVC intercept
    gamma: float             # SVC kernel width
    scale_seq: float         # feature scale (stress)
    scale_wh: float = 1.     # feature scale (plastic strain, WH)
    voce_r: float = 0.
    voce_b: float = 1.
    is_svc: bool = False
    dev_only: bool = False   # deviatoric stress features
    sdim3: bool = False


def _require_ported(m: DeviceMaterial):
    """Raise for the material kinds the port does not have yet."""
    if m.sdim3:
        raise NotImplementedError('sdim=3 (principal-space) materials are '
                                  'not ported yet')
    if m.is_svc and m.sv.shape[-1] != 6:
        raise NotImplementedError(
            'the torch port supports 6-D stress SVC features only (no '
            f'cylindrical, work-hardening or texture features); got '
            f'{m.sv.shape[-1]} features')


# -----------------------------------------------------------------
# SVC yield function
# -----------------------------------------------------------------
def svc_decision(m: DeviceMaterial, x):
    """SVC decision function on feature rows x (N, F)."""
    return svc_f_grad(x, m.sv, m.dc, m.gamma, m.rho, with_grad=False)[0]


def svc_gradient(m: DeviceMaterial, x):
    """Gradient of the SVC decision function w.r.t. features (N, F)."""
    return svc_f_grad(x, m.sv, m.dc, m.gamma, m.rho)[1]


def svc_decision_and_gradient(m: DeviceMaterial, x):
    """Decision function and its gradient from one fused pass (kernel A on
    the card, the plain expansion formula on the CPU)."""
    return svc_f_grad(x, m.sv, m.dc, m.gamma, m.rho)


def _features(m: DeviceMaterial, sig, epl=None):
    """6-D stress feature rows: (deviatoric if ``dev_only``) sig/scale_seq."""
    s = jt.sig_dev(sig) if m.dev_only else sig
    return s / m.scale_seq


def _svc_stress_grad(m: DeviceMaterial, sig, g_feat):
    """Chain rule from feature space to stress space (host convention: the
    stress-feature components / scale_seq, no deviatoric chain term)."""
    return g_feat[:, 0:6] / m.scale_seq


def flow_stress(m: DeviceMaterial, peeq):
    """sflow(peeq) = sy + khard*peeq + voce_r*(1 - exp(-voce_b*peeq))."""
    return m.sy + peeq * m.khard + m.voce_r * (-torch.expm1(-m.voce_b * peeq))


def hard_modulus(m: DeviceMaterial, peeq):
    """d sflow / d peeq = khard + voce_r*voce_b*exp(-voce_b*peeq)."""
    return m.khard + m.voce_r * m.voce_b * torch.exp(-m.voce_b * peeq)


def khard_of(m: DeviceMaterial, g_feat, mask=None):
    """Hardening modulus: the material's static khard (work-hardening SVC
    features, whose batch-mean rate the JAX twin derives, are not
    supported)."""
    return m.khard


# -----------------------------------------------------------------
# analytic Hill / J2 / Drucker criterion
# -----------------------------------------------------------------
def seq_hill(m: DeviceMaterial, sig):
    """Hill equivalent stress with Drucker hydrostatic term on Voigt
    stresses (..., 6) (the 6-parameter form; sdim=3 is not ported)."""
    return _seq_hill_of(m, sig, sig)


def _seq_hill_of(m: DeviceMaterial, sig, s):
    """Hill equivalent stress of the rows ``s``; ``sig`` supplies the I1
    trace."""
    hp = m.hill
    sh3, sh4, sh5 = s[..., 3], s[..., 4], s[..., 5]
    I2 = 0.5 * (hp[0] * (s[..., 0] - s[..., 1]) ** 2 +
                hp[1] * (s[..., 1] - s[..., 2]) ** 2 +
                hp[2] * (s[..., 2] - s[..., 0]) ** 2 +
                6. * hp[3] * sh3 ** 2 +
                6. * hp[4] * sh4 ** 2 +
                6. * hp[5] * sh5 ** 2)
    I1 = m.drucker * torch.sum(sig[..., 0:3], dim=-1) / 3.
    return jt.safe_sqrt(I2) + I1


def _seq_grad_analytic(m: DeviceMaterial, sig):
    """(seq, d seq / d sig) of the analytic criterion; the gradient at
    zero stress (a sqrt kink) is guarded to stay finite."""
    hp = m.hill
    seq = _seq_hill_of(m, sig, sig)
    seqg = torch.where(seq <= 0., 1., seq)
    sdev = jt.sig_dev(sig)
    d3 = m.drucker / 3.
    g0 = ((hp[0] + hp[2]) * sdev[..., 0] - hp[0] * sdev[..., 1]
          - hp[2] * sdev[..., 2]) / (2. * seqg) + d3
    g1 = ((hp[1] + hp[0]) * sdev[..., 1] - hp[0] * sdev[..., 0]
          - hp[1] * sdev[..., 2]) / (2. * seqg) + d3
    g2 = ((hp[2] + hp[1]) * sdev[..., 2] - hp[2] * sdev[..., 0]
          - hp[1] * sdev[..., 1]) / (2. * seqg) + d3
    g3 = 3. * hp[3] * sdev[..., 3] / seqg
    g4 = 3. * hp[4] * sdev[..., 4] / seqg
    g5 = 3. * hp[5] * sdev[..., 5] / seqg
    return seq, torch.stack([g0, g1, g2, g3, g4, g5], dim=-1)


def yf(m: DeviceMaterial, sig, peeq, epl=None):
    """Yield function: SVC decision value or seq - sflow; sig (N, 6),
    peeq (N,)."""
    _require_ported(m)
    if m.is_svc:
        return svc_decision(m, _features(m, sig, epl))
    return seq_hill(m, sig) - flow_stress(m, peeq)


def fgrad(m: DeviceMaterial, sig, epl=None):
    """Yield-surface gradient in stress space; sig (N, 6)."""
    _require_ported(m)
    if m.is_svc:
        return _svc_stress_grad(m, sig,
                                svc_gradient(m, _features(m, sig, epl)))
    return _seq_grad_analytic(m, sig)[1]


def yf_and_fgrad(m: DeviceMaterial, sig, peeq, epl=None):
    """Fused yield function + stress gradient + hardening modulus (one
    kernel pass for SVC).  Returns (f, g (N, 6), khard: a float for SVC,
    (N,) for analytic hardening)."""
    _require_ported(m)
    if m.is_svc:
        f, g = svc_decision_and_gradient(m, _features(m, sig, epl))
        return f, _svc_stress_grad(m, sig, g), khard_of(m, g)
    seq, g = _seq_grad_analytic(m, sig)
    return seq - flow_stress(m, peeq), g, hard_modulus(m, peeq)


# -----------------------------------------------------------------
# small dense helpers
# -----------------------------------------------------------------
def _inv3x3(A):
    """Closed-form 3x3 inverse (adjugate over determinant), batched."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c02 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c10 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c20 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c21 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = A[..., 0, 0] * c00 + A[..., 0, 1] * c01 + A[..., 0, 2] * c02
    rows = torch.stack([torch.stack([c00, c10, c20], dim=-1),
                        torch.stack([c01, c11, c21], dim=-1),
                        torch.stack([c02, c12, c22], dim=-1)], dim=-2)
    return rows / det[..., None, None]


def _inv6x6_spd(CV):
    """Inverse of a 6x6 elastic tensor by a Schur complement over 3x3
    blocks; rows/columns with an empty diagonal (plane-stress reduced CV)
    are decoupled, making this a pseudo-inverse on the active subspace."""
    empty = torch.abs(torch.diagonal(CV)) <= 1.
    keep = (~empty).to(CV.dtype)
    C = CV * (keep[:, None] * keep[None, :]) + torch.diag(empty.to(CV.dtype))
    A, B = C[0:3, 0:3], C[0:3, 3:6]
    Bt, D = C[3:6, 0:3], C[3:6, 3:6]
    Ai = _inv3x3(A)
    Si = _inv3x3(D - Bt @ Ai @ B)
    TR = -Ai @ B @ Si
    TL = Ai - TR @ Bt @ Ai
    top = torch.cat([TL, TR], dim=1)
    bot = torch.cat([TR.T, Si], dim=1)
    return torch.cat([top, bot], dim=0) * (keep[:, None] * keep[None, :])


def _compliance(CV):
    """Pseudo-compliance of the excess-stress correction (handles
    plane-stress CV with empty rows)."""
    SV = torch.zeros_like(CV)
    full3 = CV[2, 2] > 1.
    pad = torch.diag(torch.tensor([0., 0., 1.], dtype=CV.dtype,
                                  device=CV.device))
    inv3 = _inv3x3(torch.where(full3, CV[0:3, 0:3], CV[0:3, 0:3] + pad))
    d2 = CV[0, 0] * CV[1, 1] - CV[0, 1] * CV[1, 0]
    inv2 = torch.stack([torch.stack([CV[1, 1], -CV[0, 1]]),
                        torch.stack([-CV[1, 0], CV[0, 0]])]) / d2
    top2 = torch.zeros((3, 3), dtype=CV.dtype, device=CV.device)
    top2[0:2, 0:2] = inv2
    SV[0:3, 0:3] = torch.where(full3, inv3, top2)
    for k in range(3, 6):
        SV[k, k] = torch.where(CV[k, k] > 1., 1. / CV[k, k], 0.)
    return SV


# -----------------------------------------------------------------
# production return map
# -----------------------------------------------------------------
def response_fast(m: DeviceMaterial, state, deps, CV, maxiter=12, nsub=1):
    """Cutting-plane closest-point return map (Simo & Hughes alg. 3.5.2),
    ``nsub`` equal substeps, then the exact path-secant tangent; the JAX
    ``response_fast`` with its early-exit Newton loop, for SVC and analytic
    materials.

    state = (sig (N, 6), epl (N, 6)); deps (N, 6); CV (6, 6) tensor.
    Returns (f_end, sig, depl, tangent (N, 6, 6))."""
    _require_ported(m)
    sig0, epl0 = state
    dt = sig0.dtype
    N = sig0.shape[0]
    # trust region on the per-iteration stress correction (SVC decision
    # surfaces flatten outside the training band); analytic criteria are
    # 1-homogeneous and convex and run uncapped
    cap = 0.1 * m.scale_seq if m.is_svc else 1.e6 * m.scale_seq
    deps_s = deps / nsub
    CVT = CV.T
    cv_floor = 1e-12 * torch.max(torch.abs(CV))

    def project(sig_in, depl_in, f0):
        """One cutting-plane projection of the substep trial state; ``f0``
        is the yield function at the substep start.  Costs 1 + n_newton
        fused f/grad kernel passes."""
        peeq_in = jt.eps_eq(epl0 + depl_in)
        # SVC values are dimensionless; analytic f carries stress units
        toler = yf_tolerance * PROJ_TOL_SCALE
        if not m.is_svc:
            toler = toler * flow_stress(m, peeq_in)
        sig_tr = sig_in + deps_s @ CVT
        epl_in = epl0 + depl_in
        f_tr, a_tr, kh_tr = yf_and_fgrad(m, sig_tr, peeq_in, epl_in)
        plastic = f_tr > toler
        # elastic fraction of the substep (linear interpolation of f)
        alpha = torch.where(
            plastic & (f0 < 0.),
            -f0 / torch.where(f_tr - f0 == 0., 1., f_tr - f0),
            torch.where(plastic, 0., 1.).to(dt))
        alpha = torch.clamp(alpha, 0., 1.)

        sig, depl, f, a, kh = sig_tr, depl_in, f_tr, a_tr, kh_tr
        it = 0
        # host read of the active-lane flag once per Newton trip (the JAX
        # while_loop decides on the device)
        while it < maxiter and bool((plastic & (torch.abs(f) > toler))
                                    .any()):
            ca = a @ CVT
            denom = torch.maximum(torch.sum(ca * a, dim=-1) + kh, cv_floor)
            act = plastic & (torch.abs(f) > toler)
            lam = torch.where(act, f / denom, 0.)
            dsig_norm = torch.abs(lam) * torch.sqrt(torch.sum(ca * ca,
                                                              dim=-1))
            scale = torch.where(dsig_norm > cap, cap / torch.where(
                dsig_norm == 0., 1., dsig_norm), 1.)
            lam = lam * scale
            sig = sig - lam[:, None] * ca
            depl = depl + lam[:, None] * a
            f, a, kh = yf_and_fgrad(m, sig, jt.eps_eq(epl0 + depl),
                                    epl0 + depl)
            it += 1
        sig = torch.where(plastic[:, None], sig, sig_tr)
        depl = torch.where(plastic[:, None], depl, depl_in)
        if not m.is_svc:
            # radial excess-stress fallback: scale an overshooting stress
            # back to the locus (seq is 1-homogeneous, one factor is exact)
            # and book the compensating plastic strain through the
            # pseudo-compliance
            seq_c = seq_hill(m, sig)
            over_c = plastic & (f > toler) & (seq_c > 1e-8)
            fac = torch.where(over_c, f / torch.where(seq_c == 0., 1., seq_c),
                              0.)
            dsig_x = sig * fac[:, None]
            sig = sig - dsig_x
            depl = depl + dsig_x @ _compliance(CV).T
            f, a, kh = yf_and_fgrad(m, sig, jt.eps_eq(epl0 + depl),
                                    epl0 + depl)
        # substep tangent: alpha-blend of elastic stiffness and the
        # consistent tangent at the substep end state
        ca = a @ CVT
        denom = torch.maximum(torch.sum(ca * a, dim=-1) + kh, cv_floor)
        Ct = CV[None] - ca[:, :, None] * ca[:, None, :] / denom[:, None, None]
        Cs = (alpha[:, None, None] * CV[None]
              + (1. - alpha)[:, None, None] * Ct)
        return sig, depl, f, plastic, Cs

    sig = sig0
    depl = torch.zeros_like(sig0)
    f_end = yf(m, sig0, jt.eps_eq(epl0), epl0)
    if nsub == 1:
        sig, depl, f_end, any_plastic, grad = project(sig, depl, f_end)
    else:
        any_plastic = torch.zeros(N, dtype=torch.bool, device=sig0.device)
        grad = torch.zeros((N, 6, 6), dtype=dt, device=sig0.device)
        for _ in range(nsub):
            sig, depl, f_end, pl, Cs = project(sig, depl, f_end)
            any_plastic = any_plastic | pl
            grad = grad + Cs / nsub

    # exact path secant C_sec = CV - w w^T / (w . deps), w = CV deps - dsig,
    # with the denominator clamped to (1 + mu) w^T CV^-1 w (dtype-aware
    # condition cap); lanes with den <= 0 keep the blended tangent
    mu = 1e-5 if dt == torch.float64 else 1e-4
    w = deps @ CVT - (sig - sig0)
    den = torch.sum(w * deps, dim=-1)
    q = torch.sum((w @ _inv6x6_spd(CV).T) * w, dim=-1)
    ok = any_plastic & (den > 0.) & (q > 0.)
    dsafe = torch.where(ok, torch.maximum(den, (1. + mu) * q), 1.)
    grad = torch.where(ok[:, None, None],
                       CV[None] - w[:, :, None] * w[:, None, :]
                       / dsafe[:, None, None], grad)
    return f_end, sig, depl, grad


def response_fast_chunked(m: DeviceMaterial, state, deps, CV, maxiter=12,
                          nsub=1, chunk=1 << 21):
    """``response_fast`` over chunks of ``chunk`` points: bounds the live
    per-point temporaries of very large batches.  Lanes are independent,
    so chunking does not change any result."""
    sig0, epl0 = state
    N = sig0.shape[0]
    if N <= chunk:
        return response_fast(m, state, deps, CV, maxiter, nsub)
    parts = [response_fast(m, (sig0[s:s + chunk], epl0[s:s + chunk]),
                           deps[s:s + chunk], CV, maxiter, nsub)
             for s in range(0, N, chunk)]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(4))
