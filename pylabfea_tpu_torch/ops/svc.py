"""RBF-SVC decision function, gradient and Hessian on tensors (the plain
versions of ``pylabfea_tpu.ops.svc`` ``decision_function_jax`` /
``decision_gradient_jax`` / ``decision_hessian``), their numpy copies for
the host profile (``decision_function_np`` / ``decision_gradient_np`` /
``decision_hessian_np``, the JAX package's numpy ``decision_function`` /
``decision_gradient`` / ``decision_hessian`` with the same arithmetic),
and the reduced-set compression ``reduce_svc``.

A trained SVC is its support vectors ``sv`` (nsv, F), dual coefficients
``dc`` (nsv,), intercept ``rho`` and kernel width ``gamma``.  The return
map's hot path goes through the fused kernels in ``svc_kernels`` instead;
the Hessian and the compression have no kernel (they have no Pallas
kernel in the JAX package either).
"""
from dataclasses import dataclass

import numpy as np
import torch

from pylabfea_tpu_torch.config import resolve_device
from pylabfea_tpu_torch.ops.svc_kernels import rbf_d2


@dataclass
class SVCParams:
    """Parameters of a trained RBF-kernel SVC decision function, as numpy
    arrays and floats (the JAX ``SVCParams``)."""
    support_vectors: np.ndarray  # (nsv, F)
    dual_coef: np.ndarray        # (nsv,)
    intercept: float
    gamma: float

    @classmethod
    def from_sklearn(cls, clf):
        """The parameters of a fitted ``sklearn.svm.SVC``."""
        return cls(support_vectors=np.array(clf.support_vectors_),
                   dual_coef=np.array(clf.dual_coef_[0]),
                   intercept=float(clf.intercept_[0]),
                   gamma=float(clf._gamma if hasattr(clf, "_gamma")
                               else clf.gamma))


def decision_function_np(params: SVCParams, x):
    """Host decision function f(x) = sum_i dc_i exp(-gamma ||x - sv_i||^2)
    + rho of x (N, F) in numpy float64, with direct squared distances (as
    libsvm accumulates them).  Returns (N,)."""
    x = np.asarray(x, dtype=float)
    sv = params.support_vectors
    diff = x[:, None, :] - sv[None, :, :]
    d2 = np.sum(diff * diff, axis=2)
    k = np.exp(-params.gamma * d2)
    return k @ params.dual_coef + params.intercept


def decision_gradient_np(params: SVCParams, x):
    """Host gradient of the decision function w.r.t. x, (N, F):
    dK/dx = -2 gamma (x - sv) K summed with the dual coefficients."""
    x = np.asarray(x, dtype=float)
    sv = params.support_vectors
    diff = x[:, None, :] - sv[None, :, :]
    k = np.exp(-params.gamma * np.sum(diff * diff, axis=2))
    w = params.dual_coef[None, :] * k
    return -2. * params.gamma * np.einsum('ns,nsd->nd', w, diff)


def decision_hessian_np(params: SVCParams, x):
    """Host Hessian of the decision function w.r.t. x, (N, F, F)."""
    x = np.asarray(x, dtype=float)
    sv = params.support_vectors
    diff = sv[None, :, :] - x[:, None, :]
    k = np.exp(-params.gamma * np.sum(diff * diff, axis=2))
    w = params.dual_coef[None, :] * k
    g = params.gamma
    h = 4. * g * g * np.einsum('ns,nsi,nsj->nij', w, diff, diff)
    trace_term = 2. * g * np.sum(w, axis=1)
    idx = np.arange(x.shape[1])
    h[:, idx, idx] -= trace_term[:, None]
    return h


def decision_function(sv, dc, rho, gamma, x):
    """f(x) = sum_s dc_s exp(-gamma |x - sv_s|^2) + rho for x (N, F)."""
    return torch.exp(-gamma * rbf_d2(x, sv)) @ dc + rho


def decision_gradient(sv, dc, gamma, x):
    """df/dx (N, F) with direct differences x - sv_s."""
    diff = x[:, None, :] - sv[None, :, :]
    k = torch.exp(-gamma * torch.sum(diff * diff, dim=2))
    w = dc[None, :] * k
    return -2. * gamma * torch.einsum('ns,nsd->nd', w, diff)


def decision_hessian(sv, dc, gamma, x):
    """Hessian of the decision function w.r.t. x, (N, F, F): 4 gamma^2
    sum_s w_s d_s d_s^T - 2 gamma sum_s w_s I with d_s = sv_s - x and w_s
    = dc_s exp(-gamma |d_s|^2) (the JAX ``decision_hessian``, direct
    differences)."""
    diff = sv[None, :, :] - x[:, None, :]
    k = torch.exp(-gamma * torch.sum(diff * diff, dim=2))
    w = dc[None, :] * k
    h = 4. * gamma * gamma * torch.einsum('ns,nsi,nsj->nij', w, diff, diff)
    tr = 2. * gamma * torch.sum(w, dim=1)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    return h - tr[:, None, None] * eye


def _rbf_kernel(A, B, gamma):
    """exp(-gamma |A_i - B_j|^2) with matmul-expansion distances."""
    return torch.exp(-gamma * rbf_d2(A, B))


def _q(X, a, Z, gamma):
    """q(Z) = (Kzx a)^T Kzz^-1 (Kzx a) with the 1e-10 jitter: the part of
    |w|_H^2 that the centers Z capture once their coefficients are
    projected."""
    b = _rbf_kernel(Z, X, gamma) @ a
    Kzz = _rbf_kernel(Z, Z, gamma)
    eye = torch.eye(Z.shape[0], dtype=Z.dtype, device=Z.device)
    c = torch.linalg.solve(Kzz + 1e-10 * eye, b)
    return torch.dot(b, c)


def _refine_centers(X, a, Z0, gamma, iters=300, lr=0.02):
    """Adam ascent of q(Z) (the JAX ``_refine_centers``), the gradient
    from ``torch.autograd`` in the dtype of the tensors (float64), on
    their device: ``iters`` steps of rate ``lr`` with the JAX moments
    (0.9, 0.999) and 1e-8."""
    Z = Z0.clone()
    mom = torch.zeros_like(Z)
    vel = torch.zeros_like(Z)
    for t in range(1, iters + 1):
        Zr = Z.detach().requires_grad_(True)
        with torch.enable_grad():
            gr, = torch.autograd.grad(-_q(X, a, Zr, gamma), Zr)
        mom = 0.9 * mom + 0.1 * gr
        vel = 0.999 * vel + 0.001 * gr * gr
        mh = mom / (1. - 0.9 ** t)
        vh = vel / (1. - 0.999 ** t)
        Z = Z - lr * mh / (torch.sqrt(vh) + 1e-8)
    return Z


def _lloyd(X, wgt, Z, iters=25):
    """|a|-weighted Lloyd iterations: each center moves to the weighted
    mean of the support vectors nearest to it; a center with none stays."""
    k = Z.shape[0]
    for _ in range(iters):
        # unclipped expansion distances, as the JAX Lloyd step takes them
        lab = torch.argmin(torch.sum(X * X, dim=1)[:, None]
                           + torch.sum(Z * Z, dim=1)[None] - 2. * X @ Z.T,
                           dim=1)
        num = torch.zeros_like(Z).index_add_(0, lab, wgt[:, None] * X)
        den = torch.zeros(k, dtype=Z.dtype, device=Z.device).index_add_(
            0, lab, wgt)
        Z = torch.where((den > 0.)[:, None],
                        num / torch.where(den > 0., den, 1.)[:, None], Z)
    return Z


def reduce_svc(params: SVCParams, n_out=None, tol=1e-3, seed=0,
               max_rounds=60, abs_tol=None, device=None):
    """Reduced-set compression of a trained RBF SVC (the JAX
    ``reduce_svc``): approximates w = sum_i a_i phi(x_i) by w~ = sum_j c_j
    phi(z_j) with fewer centers.  The centers are |a|-weighted seeds
    (``np.random.default_rng(seed).choice``, in numpy so that both
    packages start from the same ones), 25 Lloyd iterations, then Adam
    ascent of q(Z) (``_refine_centers``); the coefficients are the exact
    projection c = Kzz^-1 Kzx a, from whichever of the refined and the
    k-means set projects better.  Since K(x, x) = 1 the RKHS distance
    bounds the decision-function error everywhere: |f(x) - f~(x)| <=
    |w - w~|_H.

    ``n_out`` fixes the center count; otherwise the count doubles from 16
    until the relative RKHS error |w - w~|_H / |w|_H meets ``tol`` (or
    ``abs_tol / |w|_H`` when ``abs_tol`` bounds the absolute error), and
    k >= nsv copies the support vectors exactly.  ``max_rounds`` is
    accepted for the JAX signature and unused there too.  The arithmetic
    runs in float64 on ``device`` (the card unless given).  Returns
    (reduced SVCParams, relative RKHS error)."""
    dev = resolve_device(device)
    f64 = torch.float64
    Xn = np.asarray(params.support_vectors, float)
    an = np.asarray(params.dual_coef, float)
    g = float(params.gamma)
    m = Xn.shape[0]
    X = torch.as_tensor(Xn, dtype=f64, device=dev)
    a = torch.as_tensor(an, dtype=f64, device=dev)
    wnorm2 = float(a @ (_rbf_kernel(X, X, g) @ a))
    if abs_tol is not None:
        tol = float(abs_tol) / np.sqrt(max(wnorm2, 1e-300))

    def project(Zc):
        Kzz = _rbf_kernel(Zc, Zc, g)
        Kzxa = _rbf_kernel(Zc, X, g) @ a
        eye = torch.eye(Zc.shape[0], dtype=f64, device=dev)
        c = torch.linalg.solve(Kzz + 1e-10 * eye, Kzxa)
        e2 = wnorm2 - 2. * float(c @ Kzxa) + float(c @ (Kzz @ c))
        return c, float(np.sqrt(max(e2, 0.) / max(wnorm2, 1e-300)))

    def fit(k):
        if k >= m:
            # exact: the full SV set reproduces w identically
            return X.clone(), a.clone(), 0.
        rng = np.random.default_rng(seed)
        wgt = np.abs(an) + 1e-12
        pick = rng.choice(m, size=min(k, m), replace=False,
                          p=wgt / wgt.sum())
        Zkm = _lloyd(X, torch.as_tensor(wgt, dtype=f64, device=dev),
                     X[torch.as_tensor(pick, device=dev)])
        Z = _refine_centers(X, a, Zkm, g)
        c, rel = project(Z)
        c_km, rel_km = project(Zkm)
        if rel_km < rel:
            Z, c, rel = Zkm, c_km, rel_km
        return Z, c, rel

    if n_out is not None:
        Z, c, rel = fit(int(n_out))
    else:
        k = 16
        while True:
            Z, c, rel = fit(k)
            if rel <= tol or k >= m:
                break
            k = min(2 * k, m)
    red = SVCParams(support_vectors=Z.cpu().numpy(),
                    dual_coef=c.cpu().numpy(),
                    intercept=float(params.intercept), gamma=g)
    return red, rel
