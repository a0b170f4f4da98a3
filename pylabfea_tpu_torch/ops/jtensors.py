"""Batched stress/strain helpers (the port of ``pylabfea_tpu.ops.jtensors``).

Batch-first tensors ``(N, 6)`` in Voigt order (11, 22, 33, 23, 13, 12).
Principal stresses come from a closed-form 3x3 eigensolver (Cardano
eigenvalues, cross-product eigenvectors): elementwise arithmetic, so a
batch on the card runs no cuSOLVER call.  The eigen-pairs are assigned to
the material axes by the permutation that best aligns the eigenvectors
with them, applied as a gather (the JAX module's one-hot contractions
avoid TPU gathers and give the same values).
"""
import numpy as np
import torch

a_vec = np.array([1., -0.5, -0.5]) / np.sqrt(1.5)
b_vec = np.array([0., 0.5, -0.5]) * np.sqrt(2)

#: the six axis assignments and their parities
_AXIS_PERMS = np.array([[0, 1, 2], [0, 2, 1], [1, 0, 2],
                        [1, 2, 0], [2, 0, 1], [2, 1, 0]])
_PERM_SIGNS = np.array([1., -1., -1., 1., 1., -1.])


def safe_sqrt(x):
    """sqrt that is exactly 0 at x == 0 (value-identical to ``sqrt`` for
    x >= 0); the JAX twin also keeps the derivative finite there."""
    pos = x > 0.
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.)), 0.)


def voigt_to_tensor(sv):
    """(..., 6) Voigt -> (..., 3, 3) symmetric tensor."""
    s = sv
    row0 = torch.stack([s[..., 0], s[..., 5], s[..., 4]], dim=-1)
    row1 = torch.stack([s[..., 5], s[..., 1], s[..., 3]], dim=-1)
    row2 = torch.stack([s[..., 4], s[..., 3], s[..., 2]], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def seq_j2_voigt(sig):
    """J2 equivalent stress from full Voigt stresses (..., 6)."""
    d12 = sig[..., 0] - sig[..., 1]
    d23 = sig[..., 1] - sig[..., 2]
    d31 = sig[..., 2] - sig[..., 0]
    sh = sig[..., 3] ** 2 + sig[..., 4] ** 2 + sig[..., 5] ** 2
    return safe_sqrt(0.5 * (d12 ** 2 + d23 ** 2 + d31 ** 2) + 3. * sh)


def seq_j2_princ(sp):
    """J2 equivalent stress from principal stresses (..., 3)."""
    d12 = sp[..., 0] - sp[..., 1]
    d23 = sp[..., 1] - sp[..., 2]
    d31 = sp[..., 2] - sp[..., 0]
    return safe_sqrt(0.5 * (d12 ** 2 + d23 ** 2 + d31 ** 2))


def _det3(a):
    """Determinant of (..., 3, 3) batches by the rule of Sarrus, in the
    order of ``jnp.linalg.det``'s 3x3 case (elementwise; a batched
    ``torch.linalg.det`` is an LU)."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2] +
            a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0] +
            a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1] -
            a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0] -
            a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1] -
            a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _two_square(s):
    """s * s as an exact pair (hi, lo), hi = fl(s * s) (Dekker's product
    with Veltkamp's split; no fused multiply-add needed)."""
    c = 134217729. * s                  # 2^27 + 1
    sh = c - (c - s)
    sl = s - sh
    hi = s * s
    return hi, ((sh * sh - hi) + 2. * (sh * sl)) + sl * sl


def _sqrt_rn(x):
    """The correctly rounded square root of float64 x >= 0.  PyTorch's CPU
    ``sqrt`` may land an ulp off (the card's is correctly rounded), and
    Cardano's arccos near r = +-1 turns one ulp of p into a 1e-8 split of a
    degenerate eigenvalue pair; ``torch.sqrt``'s root s moves to a
    neighbour when the exact residual x - s^2 puts the root beyond the
    midpoint between them."""
    s = torch.sqrt(x)
    if x.dtype != torch.float64:
        return s
    up = torch.nextafter(s, torch.full_like(s, np.inf))
    dn = torch.nextafter(s, torch.zeros_like(s))
    hi, lo = _two_square(s)
    e1 = x - hi                         # exact: hi lies within 2x of x
    uu, ud = up - s, s - dn
    fin = torch.isfinite(x) & (s > 0.)
    go_up = fin & ((e1 - s * uu) > lo + 0.25 * uu * uu)
    go_dn = fin & ((e1 + s * ud) < lo + 0.25 * ud * ud)
    return torch.where(go_up, up, torch.where(go_dn, dn, s))


def _eigh_sym3_closed(st):
    """Closed-form eigendecomposition of symmetric 3x3 batches: Cardano
    (trigonometric) eigenvalues and cross-product eigenvectors (the best
    of the three row pairs of A - lambda I).  Where an eigenvector is
    ill-defined (near-degenerate pairs, the spherical limit) the identity
    frame stands in, which the axis assignment treats as the aligned
    case.  Returns (w ascending (..., 3), v (..., 3, 3) column
    eigenvectors)."""
    dt = st.dtype
    q = torch.diagonal(st, dim1=-2, dim2=-1).sum(-1) / 3.
    eye = torch.eye(3, dtype=dt, device=st.device)
    B = st - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.
    p = _sqrt_rn(torch.clamp(p2, min=0.))
    psafe = torch.where(p2 > 0., p, 1.)
    r = torch.clamp(_det3(B) / (2. * psafe ** 3), -1., 1.)
    phi = torch.arccos(r) / 3.
    w_hi = q + 2. * p * torch.cos(phi)
    w_lo = q + 2. * p * torch.cos(phi + 2. * np.pi / 3.)
    w_mid = 3. * q - w_hi - w_lo
    w = torch.stack([w_lo, w_mid, w_hi], dim=-1)
    scale = torch.clamp(torch.sum(st * st, dim=(-2, -1)), min=1e-30) ** 1.5

    def eigvec(lmbda):
        A = st - lmbda[..., None, None] * eye
        r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
        c01 = torch.linalg.cross(r0, r1)
        c12 = torch.linalg.cross(r1, r2)
        c20 = torch.linalg.cross(r2, r0)
        n01 = torch.sum(c01 * c01, dim=-1)
        n12 = torch.sum(c12 * c12, dim=-1)
        n20 = torch.sum(c20 * c20, dim=-1)
        best = torch.where(((n01 >= n12) & (n01 >= n20))[..., None], c01,
                           torch.where((n12 >= n20)[..., None], c12, c20))
        nb = torch.maximum(n01, torch.maximum(n12, n20))
        nrm = torch.sqrt(torch.sum(best * best, dim=-1))
        return (best / torch.where(nrm == 0., 1., nrm)[..., None],
                nb > 1e-24 * scale)

    v0, ok0 = eigvec(w_lo)
    v1, ok1 = eigvec(w_mid)
    v2, ok2 = eigvec(w_hi)
    v = torch.stack([v0, v1, v2], dim=-1)
    good = (ok0 & ok1 & ok2 & (p2 > 0.))[..., None, None]
    return w, torch.where(good, v, eye.expand(v.shape))


def _axis_choice(v):
    """Index (...,) into ``_AXIS_PERMS`` of the assignment that maximizes
    sum_r |v[r, perm[r]]| (each material axis gets the eigenvector that
    dominates it), the first maximum on ties as ``argmax`` gives it."""
    absv = torch.abs(v)
    scores = torch.stack(
        [absv[..., 0, p[0]] + absv[..., 1, p[1]] + absv[..., 2, p[2]]
         for p in _AXIS_PERMS], dim=-1)
    return torch.argmax(scores, dim=-1)


def _assignment(sig):
    """Eigen-decomposition of Voigt rows and their axis assignment: (w, v,
    choice (...,), perm (..., 3) with spa[i] = w[perm[i]])."""
    w, v = _eigh_sym3_closed(voigt_to_tensor(sig))
    best = _axis_choice(v)
    perm = torch.as_tensor(_AXIS_PERMS, device=sig.device)[best]
    return w, v, best, perm


def sig_princ_vals(sig):
    """Principal stresses (..., 3) of Voigt rows (..., 6), assigned to the
    material axes (``spa[i] = w[perm[i]]``); no eigenvectors."""
    w, _, _, perm = _assignment(sig)
    return torch.gather(w, -1, perm)


def sig_princ_device(sig):
    """Principal stresses (..., 3) and eigenvectors (..., 3, 3) of Voigt
    rows, the eigen-pairs assigned to the material axes by the alignment
    that maximizes sum_r |v[r, perm[r]]|, the frame made right-handed."""
    w, v, best, perm = _assignment(sig)
    spa = torch.gather(w, -1, perm)
    eva = torch.gather(v, -1, perm[..., None, :].expand(v.shape))
    c0, c1, c2 = v[..., :, 0], v[..., :, 1], v[..., :, 2]
    detv = torch.sum(c0 * torch.linalg.cross(c1, c2), dim=-1)
    psign = torch.as_tensor(_PERM_SIGNS, dtype=sig.dtype,
                            device=sig.device)[best]
    eva = torch.where((detv * psign < 0)[..., None, None], -eva, eva)
    return spa, eva


def polar_ang_princ(sp):
    """Polar angle in the deviatoric plane from principal stresses."""
    dev = sp - torch.sum(sp, dim=-1, keepdim=True) / 3.
    vn = torch.linalg.vector_norm(dev, dim=-1)
    vn = torch.where(vn < 1.e-4, 1., vn)
    du = dev / vn[..., None]
    dsa = du @ torch.as_tensor(a_vec, dtype=sp.dtype, device=sp.device)
    dsb = du @ torch.as_tensor(b_vec, dtype=sp.dtype, device=sp.device)
    return torch.atan2(dsb, dsa)


def sig_dev(sig):
    """Deviatoric stress for Voigt (..., 6) or principal (..., 3) input."""
    p = torch.sum(sig[..., 0:3], dim=-1, keepdim=True) / 3.
    if sig.shape[-1] == 3:
        return sig - p
    return torch.cat([sig[..., 0:3] - p, sig[..., 3:]], dim=-1)


def eps_eq(eps):
    """Equivalent strain for Voigt (..., 6) or principal (..., 3) input."""
    if eps.shape[-1] == 6:
        return safe_sqrt(2. * (torch.sum(eps[..., 0:3] ** 2, dim=-1) +
                               0.5 * torch.sum(eps[..., 3:6] ** 2, dim=-1))
                         / 3.)
    return safe_sqrt(2. * torch.sum(eps[..., 0:3] ** 2, dim=-1) / 3.)
