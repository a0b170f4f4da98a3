"""Batched constitutive update (subset of ``pylabfea_tpu.ops.constitutive``).

Ported: the analytic Hill/J2/Drucker criterion on 6-D Voigt stresses with
linear and Voce hardening; the SVC yield function on every feature layout
of the JAX package (cylindrical sdim=3 ``(seq/scale_seq - 1, theta/pi)``
with 2 features, 6-D stress with ``dev_only`` both ways, stress + work
hardening with 15, and texture-conditioned ones with 6 + tdim or 15 +
tdim through the fitted StandardScaler, PCA-whitened ADV descriptors
included) through the SVC kernels of ``svc_kernels`` (D for the decision
function alone, A for the fast path's fused value + gradient, E for the
faithful flow rule's, G for the yield-locus distance), with the
batch-mean work-hardening rate ``khard_of``; the production
cutting-plane return map ``response_fast`` with the exact path-secant
tangent; and the reference-faithful substepped return map ``response``
with the yield-locus distance ``ml_yf_dist`` (bracket marching + Brent
per lane, kernel G), for both kinds.  Analytic sdim=3 materials evaluate
the Hill quadratic on the principal stresses, and cylindrical SVC
features come from them (the closed-form eigensolver of ``jtensors``);
``yf``, ``fgrad``, ``yf_and_fgrad``, ``ml_yf_dist`` and ``yf_dist`` of a
cylindrical material also take (N, 3) principal stresses.
"""
import dataclasses
import math
from dataclasses import dataclass

import torch

from pylabfea_tpu_torch.config import yf_tolerance
from pylabfea_tpu_torch.ops import graphs
from pylabfea_tpu_torch.ops import jtensors as jt
from pylabfea_tpu_torch.ops import svc_kernels as sk
from pylabfea_tpu_torch.utils import profiling

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
    tensors, as in the JAX package.  The feature layout follows from the
    shapes: 2 features are the cylindrical ones, 6 + tdim the stress
    (and texture) ones, 15 + tdim add the work-hardening block."""
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
    # texture-conditioned SVC: the StandardScaler's mean and scale (F,) and
    # the fixed texture descriptor (tdim,); empty (0,) otherwise
    feat_mean: torch.Tensor = None
    feat_scale: torch.Tensor = None
    tex: torch.Tensor = None

    def __post_init__(self):
        for k in ('feat_mean', 'feat_scale', 'tex'):
            if getattr(self, k) is None:
                setattr(self, k, self.hill.new_zeros(0))


def material_to(m: DeviceMaterial, dtype) -> DeviceMaterial:
    """The material with its tensors cast to ``dtype`` and its host floats
    kept (the float64 copy of a float64 commit)."""
    return dataclasses.replace(
        m, hill=m.hill.to(dtype), sv=m.sv.to(dtype), dc=m.dc.to(dtype),
        feat_mean=m.feat_mean.to(dtype), feat_scale=m.feat_scale.to(dtype),
        tex=m.tex.to(dtype))


# -----------------------------------------------------------------
# SVC yield function
# -----------------------------------------------------------------
def svc_decision(m: DeviceMaterial, x):
    """SVC decision function on feature rows x (N, F) (kernel D on the
    card, the plain expansion formula on the CPU)."""
    return sk.svc_decision(x, m.sv, m.dc, m.gamma, m.rho)


def svc_gradient(m: DeviceMaterial, x):
    """Gradient of the SVC decision function w.r.t. features (N, F)."""
    return sk.svc_f_grad(x, m.sv, m.dc, m.gamma, m.rho)[1]


def svc_decision_and_gradient(m: DeviceMaterial, x):
    """Decision function and its gradient from one fused pass (kernel A on
    the card, the plain expansion formula on the CPU)."""
    return sk.svc_f_grad(x, m.sv, m.dc, m.gamma, m.rho)


def _has_wh(m: DeviceMaterial):
    """Does the feature vector carry the work-hardening block?"""
    return m.sv.shape[-1] - 6 - m.tex.shape[0] == 9


def _features(m: DeviceMaterial, sig, epl=None):
    """SVC feature rows from stress (and plastic strain / texture), the
    host ``create_scaled_input`` conventions: cylindrical (seq/scale_seq -
    1, theta/pi) for 2 features, from Voigt (N, 6) or principal (N, 3)
    rows alike; else the stress (deviatoric if ``dev_only``), without
    texture over scale_seq with the epl/scale_wh block and three zero
    columns (acc_strain, max_stress, flag: the FE solver's defaults) for
    work hardening, with texture the raw feature row through the fitted
    StandardScaler."""
    if m.sv.shape[-1] == 2:
        if sig.shape[-1] == 6:
            seq = jt.seq_j2_voigt(sig)
            sp = jt.sig_princ_vals(sig)
        else:
            seq = jt.seq_j2_princ(sig)
            sp = sig
        theta = jt.polar_ang_princ(sp)
        return torch.stack([seq / m.scale_seq - 1., theta / math.pi], dim=-1)
    s = jt.sig_dev(sig) if m.dev_only else sig
    N = sig.shape[0]
    zeros3 = sig.new_zeros((N, 3))
    if _has_wh(m) and epl is None:
        epl = torch.zeros_like(sig)
    tdim = m.tex.shape[0]
    if tdim > 0:
        parts = [s, epl, zeros3] if _has_wh(m) else [s]
        parts.append(m.tex.to(sig.dtype).expand(N, tdim))
        return (torch.cat(parts, dim=-1) - m.feat_mean) / m.feat_scale
    x = s / m.scale_seq
    if m.sv.shape[-1] == 6:
        return x
    return torch.cat([x, epl / m.scale_wh, zeros3], dim=-1)


def _khard_lanes(m: DeviceMaterial, g_feat):
    """Per-lane work-hardening-rate contributions -sum_c dgrad_c
    scale_seq/scale_wh over the plastic-strain features; the host's
    scalar khard is their (masked) batch mean clipped at 0."""
    return -torch.sum(g_feat[:, 6:12], dim=-1) * m.scale_seq / m.scale_wh


def _jac_cyl(sp):
    """Jacobian (N, 3, 3) of the (seq, theta, p) transform of principal
    rows (the host ``Material._jac_cyl``), with its all-ones rows for
    nearly hydrostatic states (vn <= 0.1)."""
    av = torch.as_tensor(jt.a_vec, dtype=sp.dtype, device=sp.device)
    bv = torch.as_tensor(jt.b_vec, dtype=sp.dtype, device=sp.device)
    dev = jt.sig_dev(sp)
    vn = torch.linalg.vector_norm(dev, dim=-1) * math.sqrt(1.5)
    big = vn > 0.1
    dseqds = 3. * dev / torch.where(big, vn, 1.)[:, None]
    dsa = sp @ av
    dsb = sp @ bv
    den = dsa ** 2 + dsb ** 2
    den = torch.where(den == 0., 1., den)
    col1 = (bv[None, :] * dsa[:, None] - av[None, :] * dsb[:, None]) \
        / den[:, None]
    ones = torch.ones_like(dseqds)
    big = big[:, None]
    return torch.stack([torch.where(big, dseqds, ones),
                        torch.where(big, col1, ones),
                        torch.where(big, 1. / 3., ones)], dim=-1)


def _svc_stress_grad(m: DeviceMaterial, sig, g_feat):
    """Chain rule from feature space to 6-D stress space (host
    conventions): the stress-feature components over scale_seq, or over
    the StandardScaler's per-component scales for texture materials, with
    no deviatoric chain term; for cylindrical features (1, dtheta) mapped
    through ``_jac_cyl`` into the normal components, the shear ones zero."""
    if m.sv.shape[-1] == 2:
        sp = jt.sig_princ_vals(sig) if sig.shape[-1] == 6 else sig
        one = torch.ones_like(g_feat[:, 0])
        vec = torch.stack([one, g_feat[:, 1], torch.zeros_like(one)], dim=-1)
        a3 = torch.einsum('nij,nj->ni', _jac_cyl(sp), vec)
        return torch.cat([a3, a3.new_zeros((sig.shape[0], 3))], dim=-1)
    if m.tex.shape[0] > 0:
        return g_feat[:, 0:6] / m.feat_scale[0:6]
    return g_feat[:, 0:6] / m.scale_seq


def flow_stress(m: DeviceMaterial, peeq):
    """sflow(peeq) = sy + khard*peeq + voce_r*(1 - exp(-voce_b*peeq))."""
    return m.sy + peeq * m.khard + m.voce_r * (-torch.expm1(-m.voce_b * peeq))


def hard_modulus(m: DeviceMaterial, peeq):
    """d sflow / d peeq = khard + voce_r*voce_b*exp(-voce_b*peeq)."""
    return m.khard + m.voce_r * m.voce_b * torch.exp(-m.voce_b * peeq)


def khard_of(m: DeviceMaterial, g_feat, mask=None):
    """Hardening modulus: for work-hardening SVC features the batch mean
    of ``_khard_lanes`` clipped at 0, a 0-d tensor like the host's
    ``self.khard`` side effect (over the ``mask`` lanes when given); the
    material's static khard otherwise.  Being a mean over the batch, it
    makes a lane's result depend on the lanes beside it: the chunked
    return maps keep the JAX package's chunks for such materials."""
    if not m.is_svc or not _has_wh(m):
        return m.khard
    lanes = _khard_lanes(m, g_feat)
    if mask is None:
        return torch.clamp(torch.mean(lanes), min=0.)
    cnt = torch.clamp(torch.sum(mask), min=1)
    return torch.clamp(torch.sum(torch.where(mask, lanes, 0.)) / cnt, min=0.)


# -----------------------------------------------------------------
# analytic Hill / J2 / Drucker criterion
# -----------------------------------------------------------------
def _hill_rows(m: DeviceMaterial, sig):
    """The rows the Hill quadratic acts on: the principal stresses (..., 3)
    of an sdim=3 material (the host's sdim=3 convention), else the Voigt
    components themselves."""
    if m.sdim3 and sig.shape[-1] == 6:
        return jt.sig_princ_vals(sig)
    return sig


def seq_hill(m: DeviceMaterial, sig):
    """Hill equivalent stress with Drucker hydrostatic term on Voigt
    stresses (..., 6): the 6-parameter form on the components, or for
    sdim=3 materials the 3-parameter form on the principal stresses (J2
    coincides in both)."""
    return _seq_hill_of(m, sig, _hill_rows(m, sig))


def _seq_hill_of(m: DeviceMaterial, sig, s):
    """Hill equivalent stress of the rows ``s`` (Voigt or principal);
    ``sig`` supplies the I1 trace."""
    hp = m.hill
    if s.shape[-1] == 3:
        sh3 = sh4 = sh5 = 0.
    else:
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
    """(seq, d seq / d sig) of the analytic criterion in whole-row
    operations: with the rows s (Voigt, or principal for sdim=3), d = (s0
    - s1, s1 - s2, s2 - s0) and hd = hill[:3] d, I2 = 0.5 (hd.d + 6
    hill[3:].s_sh^2) and the normal gradient (hd - roll(hd)) / (2 seq);
    the gradient at zero stress (a sqrt kink) is guarded to stay finite.
    For sdim=3 the principal-space gradient fills the normal Voigt slots
    and the shear slots stay zero (the reference's convention, no
    back-rotation)."""
    hp = m.hill
    s = _hill_rows(m, sig)
    s3 = s[..., 0:3]
    d = s3 - torch.roll(s3, -1, -1)
    hd = hp[..., 0:3] * d
    I2 = 0.5 * torch.sum(hd * d, dim=-1)
    if s.shape[-1] == 6:
        ssh = s[..., 3:6]
        hsh = hp[..., 3:6] * ssh
        I2 = I2 + 3. * torch.sum(hsh * ssh, dim=-1)
    seq = jt.safe_sqrt(I2) + m.drucker * torch.sum(sig[..., 0:3], dim=-1) / 3.
    seqg = 2. * torch.where(seq <= 0., 1., seq)[..., None]
    gn = (hd - torch.roll(hd, 1, -1)) / seqg + m.drucker / 3.
    gs = 6. * hsh / seqg if s.shape[-1] == 6 else torch.zeros_like(gn)
    return seq, torch.cat([gn, gs], dim=-1)


def yf(m: DeviceMaterial, sig, peeq, epl=None):
    """Yield function: SVC decision value or seq - sflow; sig (N, 6) (or
    principal (N, 3) for cylindrical SVC features), peeq (N,)."""
    if m.is_svc:
        return svc_decision(m, _features(m, sig, epl))
    return seq_hill(m, sig) - flow_stress(m, peeq)


def fgrad(m: DeviceMaterial, sig, epl=None):
    """Yield-surface gradient (N, 6) in stress space; sig as in ``yf``."""
    if m.is_svc:
        return _svc_stress_grad(m, sig,
                                svc_gradient(m, _features(m, sig, epl)))
    return _seq_grad_analytic(m, sig)[1]


def hessian(m: DeviceMaterial, sig, epl=None):
    """Hessian (N, 6, 6) of the SVC yield function w.r.t. stress (the JAX
    ``hessian``, the device twin of ``Material.calc_hessian``): the RBF
    Hessian of the feature rows (``svc.decision_hessian``, direct
    differences), its stress block scaled by the host's conventions: a
    single 1/scale_seq without a StandardScaler (the reference's
    convention, material.py:645-650), and (1/scale_seq)^2 per component
    with one, as the JAX package writes it.  SVC materials with 6-D
    stress features only; no kernel (none in the JAX package either)."""
    from pylabfea_tpu_torch.ops.svc import decision_hessian
    if not m.is_svc or m.sv.shape[-1] == 2:
        raise NotImplementedError('hessian: SVC materials with 6-D stress '
                                  'features only')
    h6 = decision_hessian(m.sv, m.dc, m.gamma,
                          _features(m, sig, epl))[:, 0:6, 0:6]
    if m.tex.shape[0] > 0:
        sf = 1. / (sig.new_ones(6) * m.scale_seq)
        return h6 * (sf[:, None] * sf[None, :])[None]
    return h6 / m.scale_seq


def epl_dot(m: DeviceMaterial, sig, peeq, CV, deps, epl=None):
    """Associated plastic strain increment (Crisfield ch. 6; the JAX
    ``epl_dot``): lam a with lam = (C a).deps / (a.C a + khard) on the
    lanes whose trial stress sig + C deps yields, 0 elsewhere."""
    yfun = yf(m, sig + deps @ CV.T, peeq, epl)
    _, a, kh = yf_and_fgrad(m, sig, peeq, epl)
    ca = a @ CV.T
    hh = torch.sum(ca * a, dim=-1) + kh
    lam = torch.sum(ca * deps, dim=-1) / hh
    return torch.where((yfun > yf_tolerance)[:, None], lam[:, None] * a, 0.)


def c_tan(m: DeviceMaterial, sig, CV, epl=None):
    """Consistent tangent Ct = C - (C a)(C a)^T / (a.C a + khard) at zero
    equivalent plastic strain (the JAX ``c_tan``), (N, 6, 6)."""
    _, a, kh = yf_and_fgrad(m, sig, sig.new_zeros(sig.shape[0]), epl)
    ca = a @ CV.T
    hh = torch.sum(ca * a, dim=-1) + kh
    return CV[None] - ca[:, :, None] * ca[:, None, :] / hh[:, None, None]


def yf_and_fgrad(m: DeviceMaterial, sig, peeq, epl=None):
    """Fused yield function + stress gradient + hardening modulus (one
    kernel pass for SVC).  Returns (f, g (N, 6), khard: a float for SVC, a
    0-d tensor for work-hardening SVC features, (N,) for analytic
    hardening)."""
    if m.is_svc:
        f, g = svc_decision_and_gradient(m, _features(m, sig, epl))
        return f, _svc_stress_grad(m, sig, g), khard_of(m, g)
    seq, g = _seq_grad_analytic(m, sig)
    return seq - flow_stress(m, peeq), g, hard_modulus(m, peeq)


def _root_features(m: DeviceMaterial, su, epl):
    """Kernel G's feature map of the rows ``x * su``: the stress-derived
    leading features (seq_J2 for cylindrical materials, the stress block
    otherwise, through the texture scaler where there is one) and, as
    per-lane constants, the features that stay fixed while the stress
    scales: theta/pi of the direction (cylindrical; theta(x su) =
    theta(su)), the plastic-strain block, the zero columns and the
    texture (the host's ``find_yloc`` convention)."""
    F = m.sv.shape[-1]
    if F == 2:
        return sk.FeatureMap(m.scale_seq, cyl=True,
                             extra=_features(m, su)[:, 1:].contiguous())
    tex = m.tex.shape[0] > 0
    return sk.FeatureMap(
        m.scale_seq, dev_only=m.dev_only,
        mean=m.feat_mean[0:6].contiguous() if tex else None,
        scale=m.feat_scale[0:6].contiguous() if tex else None,
        extra=_features(m, su, epl)[:, 6:].contiguous() if F > 6 else None)


def ml_yf_dist(m: DeviceMaterial, sig, peeq, epl=None, khard=None,
               maxmarch=400, root=sk.svc_yf_root):
    """Distance of stresses (Voigt (N, 6), or principal (N, 3) for a
    cylindrical material) to the SVC yield locus along their own loading
    direction (the JAX ``ml_yf_dist``): geometric bracket marching (x0 *=
    0.98 down, x1 *= 1.02 up) then Brent, per lane in ``root`` (kernel G
    on the card, one launch and no host read; its plain version on the
    CPU, which ``root=sk.svc_yf_root_plain`` also runs on the card), each
    march at most ``maxmarch`` steps; lanes with a vanishing stress
    (``seq < 0.01``), no root or a root beyond 4 sflow take the fallback
    ``seq - 0.85 sflow``.  The plastic-strain and texture features stay
    fixed while the stress scales."""
    _seq = jt.seq_j2_voigt if sig.shape[-1] == 6 else jt.seq_j2_princ
    seq = _seq(sig)
    kh = m.khard if khard is None else khard
    sflow = m.sy + peeq * kh
    small = seq < 0.01
    su = sig / torch.where(small, 1., seq)[:, None]
    start = torch.where(su[:, 0] * su[:, 1] < -1.e-5, 0.5 * sflow, sflow)
    xs, ok = root(su, start, 5. * sflow, m.sv, m.dc, m.gamma, m.rho,
                  _root_features(m, su, epl), xtol=1.e-5, maxmarch=maxmarch)
    good = ok & (xs < 4. * sflow) & ~small
    return torch.where(good, seq - xs * _seq(su), seq - 0.85 * sflow)


def yf_dist(m: DeviceMaterial, sig, peeq, epl=None, khard=None):
    """Distance-type yield function: the ML root find for SVC, plain yf
    otherwise."""
    if m.is_svc:
        return ml_yf_dist(m, sig, peeq, epl, khard)
    return yf(m, sig, peeq)


def _flow_tan(m: DeviceMaterial, sig, peeq, CV, deps, epl):
    """Flow increment and consistent tangent of the faithful return map
    (the JAX ``_flow_tan``): the plastic strain increment on the lanes
    that yield under the trial stress, and Ct = CV - ca ca^T / (a.ca + kh).
    For SVC the gradient comes from one expansion-distance pass (kernel E
    on the card).  Returns (pdot, Ct, khard)."""
    dsig = deps @ CV.T
    yld = yf(m, sig + dsig, peeq, epl) > yf_tolerance
    if m.is_svc:
        _, gfeat = sk.svc_f_grad_mm(_features(m, sig, epl), m.sv, m.dc,
                                    m.gamma, m.rho)
        a = _svc_stress_grad(m, sig, gfeat)
        kh_sub = khard_of(m, gfeat, mask=yld)
        kh_full = khard_of(m, gfeat)
    else:
        a = fgrad(m, sig)
        kh_sub = kh_full = hard_modulus(m, peeq)
    ca = a @ CV.T
    aca = torch.sum(ca * a, dim=-1)
    lam = torch.sum(ca * deps, dim=-1) / (aca + kh_sub)
    pdot = torch.where(yld[:, None], lam[:, None] * a, 0.)
    Ct = CV[None] - ca[:, :, None] * ca[:, None, :] \
        / (aca + kh_full)[:, None, None]
    return pdot, Ct, kh_full


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


def _solve3x3(A, b):
    """Closed-form solve of (..., 3, 3) @ x = (..., 3)."""
    return torch.einsum('...ij,...j->...i', _inv3x3(A), b)


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
    plane-stress CV with empty rows).  Built without in-place writes, so
    it also runs under ``torch.func`` transforms of ``CV``."""
    full3 = CV[2, 2] > 1.
    z, o = CV.new_zeros(()), CV.new_ones(())
    pad = torch.diag(torch.stack([z, z, o]))
    inv3 = _inv3x3(torch.where(full3, CV[0:3, 0:3], CV[0:3, 0:3] + pad))
    d2 = CV[0, 0] * CV[1, 1] - CV[0, 1] * CV[1, 0]
    zero = torch.zeros_like(d2)
    top2 = torch.stack([torch.stack([CV[1, 1], -CV[0, 1], zero]) / d2,
                        torch.stack([-CV[1, 0], CV[0, 0], zero]) / d2,
                        torch.stack([zero, zero, zero])])
    tl = torch.where(full3, inv3, top2)
    d = torch.diagonal(CV)[3:6]
    br = torch.diag(torch.where(d > 1., 1. / torch.where(d > 1., d, 1.), 0.))
    z3 = torch.zeros_like(tl)
    return torch.cat([torch.cat([tl, z3], 1), torch.cat([z3, br], 1)], 0)


# -----------------------------------------------------------------
# production return map
# -----------------------------------------------------------------
def carries_derivative(*tensors):
    """Does any of ``tensors`` take part in a derivative: reverse mode
    (``requires_grad`` with grad mode on), forward mode (a dual tensor)
    or a ``torch.func`` transform, or is it a ``dual.Dual``?"""
    from torch.autograd import forward_ad
    from pylabfea_tpu_torch.ops.dual import Dual
    for t in tensors:
        if isinstance(t, Dual):
            return True
        if not isinstance(t, torch.Tensor):
            continue
        if torch._C._functorch.is_functorch_wrapped_tensor(t):
            return True
        if t.requires_grad and torch.is_grad_enabled():
            return True
        if forward_ad.unpack_dual(t).tangent is not None:
            return True
    return False


def response_fast(m: DeviceMaterial, state, deps, CV, maxiter=12, nsub=1,
                  fixed_trip=False):
    """Cutting-plane closest-point return map (Simo & Hughes alg. 3.5.2),
    ``nsub`` equal substeps, then the exact path-secant tangent; the JAX
    ``response_fast`` with its early-exit Newton loop, for SVC and analytic
    materials.

    ``fixed_trip=True`` runs exactly ``maxiter`` Newton trips with every
    plastic lane active (polished to machine zero instead of frozen
    inside the tolerance band) and no host read: the differentiable form
    that ``ops.calibrate`` and ``ops.femu`` take derivatives through (any
    of ``torch.autograd``, ``forward_ad`` and ``torch.func``), analytic
    materials only.  An SVC material raises when a derivative is asked
    for: the derivative of its return map needs the second derivative of
    the decision function inside the kernels (``hessian`` gives it on
    its own), and the kernels take no derivative.

    On the card an analytic fixed-trip call replays its launches from a
    CUDA graph (``graphs.Graphed``, one per input signature) when no
    tensor takes part in ``torch.autograd`` or a transform; ``dual.Dual``
    inputs replay too.

    state = (sig (N, 6), epl (N, 6)); deps (N, 6); CV (6, 6) tensor.
    Returns (f_end, sig, depl, tangent (N, 6, 6))."""
    sig0, epl0 = state
    if m.is_svc and carries_derivative(sig0, epl0, deps, CV, m.sv, m.dc,
                                       m.hill):
        raise NotImplementedError(
            'response_fast: a derivative through an SVC return map needs '
            'the second derivative of the decision function (hessian) '
            'inside the kernels, which take no derivative; derivatives are '
            'taken of analytic materials only')
    profiling.count('return_map_calls')
    with profiling.span('return_map', outermost=True):
        if fixed_trip and not m.is_svc:
            return _FIXED_TRIP(m, state, deps, CV, maxiter, nsub)
        return _response_fast(m, state, deps, CV, maxiter, nsub,
                              fixed_trip)


def _response_fast(m: DeviceMaterial, state, deps, CV, maxiter, nsub,
                   fixed_trip):
    """The body of ``response_fast``."""
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
        # while_loop decides on the device); none in the fixed-trip form
        with profiling.span('newton'):
            while it < maxiter and (fixed_trip or profiling.host_read(
                    (plastic & (torch.abs(f) > toler)).any(), 'newton')):
                ca = a @ CVT
                denom = torch.maximum(torch.sum(ca * a, dim=-1) + kh,
                                      cv_floor)
                act = plastic if fixed_trip else \
                    plastic & (torch.abs(f) > toler)
                lam = torch.where(act, f / denom, 0.)
                dsig_norm = torch.abs(lam) * torch.sqrt(
                    torch.sum(ca * ca, dim=-1))
                scale = torch.where(dsig_norm > cap, cap / torch.where(
                    dsig_norm == 0., 1., dsig_norm), 1.)
                lam = lam * scale
                sig = sig - lam[:, None] * ca
                depl = depl + lam[:, None] * a
                f, a, kh = yf_and_fgrad(m, sig, jt.eps_eq(epl0 + depl),
                                        epl0 + depl)
                it += 1
        profiling.count('newton_trips', it)
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


def _fixed_trip_call(m, state, deps, CV, maxiter, nsub):
    return _response_fast(m, state, deps, CV, maxiter, nsub, True)


_FIXED_TRIP = graphs.Graphed(_fixed_trip_call)


#: the JAX package's chunk sizes of ``response_fast_chunked`` and
#: ``response_chunked``, which work-hardening materials keep
JAX_FAST_CHUNK = 1 << 21
JAX_FAITHFUL_CHUNK = 65536


def _chunked(m: DeviceMaterial, fn, state, deps, chunk):
    """``fn(state, deps)`` over chunks of ``chunk`` points.  Lanes are
    independent unless the material has work-hardening features, whose
    batch-mean khard (``khard_of``) is taken over a chunk: for those the
    batch is zero-padded to whole chunks, as the JAX package's
    ``lax.map`` does, and the padded lanes enter the means; otherwise the
    last chunk is ragged, which changes no result."""
    sig0, epl0 = state
    N = sig0.shape[0]
    if N <= chunk:
        return fn(state, deps)
    arrays = (sig0, epl0, deps)
    if m.is_svc and _has_wh(m):
        pad = (-N) % chunk
        arrays = tuple(torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
                       for a in arrays)
    sig, epl, dep = arrays
    parts = [fn((sig[s:s + chunk], epl[s:s + chunk]), dep[s:s + chunk])
             for s in range(0, N, chunk)]
    return tuple(torch.cat([p[i] for p in parts])[:N] for i in range(4))


def response_fast_chunked(m: DeviceMaterial, state, deps, CV, maxiter=12,
                          nsub=1, chunk=JAX_FAST_CHUNK):
    """``response_fast`` over chunks of ``chunk`` points (``_chunked``):
    bounds the live per-point temporaries of very large batches."""
    return _chunked(m, lambda st, d: response_fast(m, st, d, CV, maxiter,
                                                   nsub), state, deps, chunk)


# -----------------------------------------------------------------
# reference-faithful return map
# -----------------------------------------------------------------
def _min_norm_inverse(deps_r):
    """Inverse of G = A A^T (with its singular-lane guard) of the min-norm
    tangent correction, A the (3, 6) strain-projection matrix of the
    normal components d of ``deps_r``.  Returns (d, s2 = |d|^2, G^-1)."""
    d = deps_r[:, 0:3]
    s2 = torch.sum(d * d, dim=-1)
    # G = s2 I + d_i d_j off the diagonal (A includes the shear columns,
    # which contribute d_k^2 to every diagonal entry)
    eye3 = torch.eye(3, dtype=d.dtype, device=d.device)[None]
    G = d[:, :, None] * d[:, None, :] * (1. - eye3) \
        + s2[:, None, None] * eye3
    Gsafe = G + eye3 * torch.where(s2 < 1e-30, 1., 0.)[:, None, None]
    return d, s2, _inv3x3(Gsafe)


def _min_norm_correction(d, s2, Ginv, dsig_x):
    """Symmetric (N, 6, 6) tangent correction x = A^T y with (A A^T) y =
    dsig_x[:, 0:3] in the normal-normal block."""
    yv = torch.einsum('...ij,...j->...i', Ginv, dsig_x[:, 0:3])
    yv = torch.where((s2 > 1e-30)[:, None], yv, 0.)
    x0 = d[:, 0] * yv[:, 0]
    x1 = d[:, 1] * yv[:, 1]
    x2 = d[:, 2] * yv[:, 2]
    x3 = d[:, 2] * yv[:, 1] + d[:, 1] * yv[:, 2]
    x4 = d[:, 2] * yv[:, 0] + d[:, 0] * yv[:, 2]
    x5 = d[:, 1] * yv[:, 0] + d[:, 0] * yv[:, 1]
    blk = torch.stack([torch.stack([x0, x5, x4], -1),
                       torch.stack([x5, x1, x3], -1),
                       torch.stack([x4, x3, x2], -1)], -2)
    Ct = torch.zeros((d.shape[0], 6, 6), dtype=d.dtype, device=d.device)
    Ct[:, 0:3, 0:3] = blk
    return Ct


def response(m: DeviceMaterial, state, deps, CV, maxit=50):
    """Reference-faithful batched return map (the JAX ``response``, the
    host ``Material.response_batch`` control flow with masked lanes):
    elastic predictor on the yield-locus distance, step split at the
    locus, one trial step deciding subdivision into ``maxit`` substeps,
    then the substeps with excess-stress correction and the min-norm
    tangent correction.

    state = (sig (N, 6), epl (N, 6)); deps (N, 6); CV (6, 6) tensor.
    JAX runs all ``maxit`` substeps with the finished lanes frozen; this
    runs the largest substep count of any lane (one host read), which
    gives the same result.  Returns (fy, sig, depl, tangent (N, 6, 6))."""
    sig0, epl0 = state
    N = sig0.shape[0]
    dt = sig0.dtype
    peeq0 = jt.eps_eq(epl0)
    toler = yf_tolerance * flow_stress(m, peeq0)
    dsig = deps @ CV.T
    fy_pred = yf_dist(m, sig0 + dsig, peeq0, epl0)
    elastic = fy_pred < toler

    # plastic branch (computed for all lanes, masked at the end)
    fy0 = yf(m, sig0, peeq0, epl0)
    split = fy0 < -0.15
    if m.is_svc:
        # host convention: the split distance is evaluated at ZERO plastic
        # strain (response_batch passes zeros_like(epl))
        fy0_d = ml_yf_dist(m, sig0, torch.zeros(N, dtype=dt,
                                                device=sig0.device),
                           torch.zeros_like(epl0))
        fy0 = torch.where(split, fy0_d, fy0)
    seq_dsig = jt.seq_j2_voigt(dsig) if m.is_svc else seq_hill(m, dsig)
    st_scal = torch.where(split, 1. + fy0 / seq_dsig, 1.)
    deps_el = deps * (1. - st_scal)[:, None]
    sig = sig0 + deps_el @ CV.T
    grad = torch.where(split[:, None, None],
                       CV[None] * (1. - st_scal)[:, None, None], 0.)
    deps_r = deps - deps_el

    # trial with the full remaining step -> subdivide?
    ddepl_t, t_st_t, kh_t = _flow_tan(m, sig, peeq0, CV, deps_r, epl0)
    sig_t = sig + torch.einsum('nij,nj->ni', t_st_t, deps_r)
    fy_t = yf_dist(m, sig_t, jt.eps_eq(epl0 + ddepl_t), epl0 + ddepl_t,
                   kh_t)
    sub = fy_t > toler
    deps_r = torch.where(sub[:, None], deps_r / maxit, deps_r)
    nsteps = torch.where(sub, maxit, 1)
    w_step = (st_scal / nsteps)[:, None, None]
    SV = _compliance(CV)
    d, s2, Ginv = _min_norm_inverse(deps_r)

    depl = torch.zeros_like(sig)
    fy = fy_t
    for it in range(int(nsteps.max())):
        act = it < nsteps
        ddepl, t_st, kh_it = _flow_tan(m, sig, peeq0, CV, deps_r, epl0)
        eplt = epl0 + depl + ddepl
        sig_n = sig + torch.einsum('nij,nj->ni', t_st, deps_r)
        fy_n = yf_dist(m, sig_n, jt.eps_eq(eplt), eplt, kh_it)
        over = fy_n > toler
        seq_n = jt.seq_j2_voigt(sig_n) if m.is_svc else seq_hill(m, sig_n)
        seq_n = torch.where(seq_n == 0., 1., seq_n)
        dsig_x = torch.where(over[:, None], sig_n * (fy_n / seq_n)[:, None],
                             0.)
        sig_c = sig_n - dsig_x
        ddepl_c = ddepl + dsig_x @ SV.T
        t_st_c = t_st - torch.where(over[:, None, None],
                                    _min_norm_correction(d, s2, Ginv,
                                                         dsig_x), 0.)
        eplt_c = epl0 + depl + ddepl_c
        fy_c = yf_dist(m, sig_c, jt.eps_eq(eplt_c), eplt_c, kh_it)
        # freeze the lanes whose substeps are done
        sig = torch.where((act & over)[:, None], sig_c,
                          torch.where(act[:, None], sig_n, sig))
        depl = depl + torch.where(act[:, None], torch.where(
            over[:, None], ddepl_c, ddepl), 0.)
        grad = torch.where(act[:, None, None], grad + t_st_c * w_step, grad)
        fy = torch.where(act, torch.where(over, fy_c, fy_n), fy)

    # merge elastic and plastic lanes
    return (torch.where(elastic, fy_pred, fy),
            torch.where(elastic[:, None], sig0 + dsig, sig),
            torch.where(elastic[:, None], 0., depl),
            torch.where(elastic[:, None, None], CV[None], grad))


def response_chunked(m: DeviceMaterial, state, deps, CV, maxit=50,
                     chunk=None):
    """``response`` over chunks of ``chunk`` points (``_chunked``): bounds
    the live per-point temporaries of very large batches.  On the card the
    kernels write no (N, nsv) matrix, so the default keeps 2^20 points,
    one 1024^2 mesh, in one chunk; for work-hardening materials it is the
    JAX package's ``JAX_FAITHFUL_CHUNK``, a part of their result."""
    if chunk is None:
        chunk = JAX_FAITHFUL_CHUNK if m.is_svc and _has_wh(m) else 1 << 20
    return _chunked(m, lambda st, d: response(m, st, d, CV, maxit), state,
                    deps, chunk)
