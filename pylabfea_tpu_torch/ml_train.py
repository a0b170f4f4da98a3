"""SVC training on the card: projected-gradient ascent on the RBF-SVM dual
(the port of ``pylabfea_tpu.ml_train``).

    max_a  1^T a - 1/2 a^T Q a,   0 <= a_i <= C,
    Q_ij = y_i y_j (K(x_i, x_j) + 1)

The "+1" folds the bias into the kernel, so the feasible set is a box and
projected gradient with the spectral step 1 / ||Q||_2 (30 power
iterations) converges.  The decision function is f(x) = sum_i a_i y_i
K(x, x_i) + b with b = sum_i a_i y_i.  The Gram matrix comes from the
expansion |x|^2 + |y|^2 - 2 x.y (clipped at 0), and every product
(``X @ X.T``, ``Q @ a``, ``A @ Qm``) is a plain ``torch.matmul``, with
TF32 off (``config``).  Training needs neither scikit-learn nor JAX.
"""
import numpy as np
import torch

from pylabfea_tpu_torch.config import DTYPE_DEVICE, resolve_device


def _kernel(X, gamma):
    """K + 1 = exp(-gamma max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0)) + 1."""
    sq = torch.sum(X * X, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2. * (X @ X.T)
    return torch.exp(-gamma * torch.clamp(d2, min=0.)) + 1.


def _power_step(Q, v):
    """Spectral step 1 / max(v.Qv, 1e-12) after 30 power iterations from
    ``v``."""
    for _ in range(30):
        w = Q @ v
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    return 1. / torch.clamp(torch.dot(v, Q @ v), min=1e-12)


def _fit_dual(X, y, C, gamma, iters):
    """Dual variables a (n,) after ``iters`` projected gradient steps."""
    n = X.shape[0]
    Q = (y[:, None] * y[None, :]) * _kernel(X, gamma)
    v = torch.ones(n, dtype=X.dtype, device=X.device) / torch.sqrt(
        torch.tensor(float(n), dtype=X.dtype, device=X.device))
    step = _power_step(Q, v)
    a = torch.zeros(n, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        a = torch.clamp(a + step * (1. - Q @ a), 0., C)
    return a


def _as_tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):
        return a.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def fit_svc(X, y, C=10., gamma=1., iters=3000, sv_tol=1e-6,
            dtype=DTYPE_DEVICE, device=None):
    """Train an RBF SVC (the JAX ``fit_svc_jax``) on the card, or on
    ``device``.  Returns (params, a): params a dict of float64 numpy
    support vectors ``sv``, dual coefficients ``dc`` and floats ``rho``,
    ``gamma`` (the keys ``convert.material_from_params`` takes), a the
    dual variables as float64 numpy.  Support vectors are the points with
    a_i > sv_tol C."""
    device = resolve_device(device)
    Xt = _as_tensor(X, dtype, device)
    yt = _as_tensor(y, dtype, device)
    a = _fit_dual(Xt, yt, float(C), float(gamma), int(iters))
    a_np = a.cpu().double().numpy()
    y_np = yt.cpu().double().numpy()
    X_np = Xt.cpu().double().numpy()
    keep = a_np > sv_tol * C
    params = dict(sv=X_np[keep], dc=(a_np * y_np)[keep],
                  rho=float(np.sum(a_np * y_np)), gamma=float(gamma))
    return params, a_np


def _fold_grid_acc(X, y, train_mask, Cs, gamma, iters):
    """Validation accuracies of every C of ``Cs`` for one (fold, gamma)
    pair.  Held-out points leave the problem through the box bound
    a_i <= mask_i C (their duals stay 0); all C lanes share one Q, so a
    step is one (nC, n) x (n, n) product."""
    K = _kernel(X, gamma)
    Q = (y[:, None] * y[None, :]) * K
    Qm = Q * train_mask[:, None] * train_mask[None, :]
    v = train_mask / torch.clamp(torch.linalg.vector_norm(train_mask),
                                 min=1e-30)
    step = _power_step(Qm, v)
    ub = train_mask[None, :] * Cs[:, None]
    A = torch.zeros_like(ub)
    for _ in range(iters):
        A = torch.minimum(torch.clamp(A + step * (1. - A @ Qm), min=0.), ub)
    F = (A * y[None, :]) @ K
    correct = (torch.where(F > 0., 1., -1.) == y[None, :]).to(X.dtype)
    vm = 1. - train_mask
    return (correct * vm[None, :]).sum(dim=1) / torch.clamp(vm.sum(), min=1.)


def gridsearch_svc(X, y, cvals, gvals, n_splits=5, iters=2000,
                   dtype=DTYPE_DEVICE, seed=13, device=None):
    """K-fold cross-validated (C, gamma) search with the dual solver (the
    JAX ``gridsearch_svc_jax``, the same folds from the same seed).
    Returns (best_C, best_gamma, scores) with ``scores[g, c]`` the mean
    validation accuracy of (gvals[g], cvals[c])."""
    device = resolve_device(device)
    Xt = _as_tensor(X, dtype, device)
    yt = _as_tensor(y, dtype, device)
    n = Xt.shape[0]
    folds = np.array_split(np.random.default_rng(seed).permutation(n),
                           n_splits)
    Cs = torch.as_tensor(np.asarray(cvals, float), dtype=dtype,
                         device=device)
    scores = np.zeros((len(gvals), len(cvals)))
    for fold in folds:
        mask = np.ones(n)
        mask[fold] = 0.
        tm = torch.as_tensor(mask, dtype=dtype, device=device)
        for gi, gamma in enumerate(gvals):
            scores[gi] += _fold_grid_acc(Xt, yt, tm, Cs, float(gamma),
                                         int(iters)).cpu().double().numpy()
    scores /= n_splits
    gi, ci = np.unravel_index(int(np.argmax(scores)), scores.shape)
    return float(cvals[ci]), float(gvals[gi]), scores


def train_svc(X_train, y_train, sy, scale_seq=None, C=10., gamma=1.,
              iters=3000, dev_only=False, dtype=DTYPE_DEVICE, device=None):
    """Fit the SVC on the card (``fit_svc``) and return it as the port's
    ML yield function: (DeviceMaterial with stress features over
    ``scale_seq`` (default ``sy``), training accuracy in percent by the
    material's own decision function, params of ``fit_svc``).  ``X_train``
    holds the scaled features (stress / scale_seq, the host
    ``create_scaled_input``), ``y_train`` the labels +-1."""
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import constitutive as con
    device = resolve_device(device)
    params, _ = fit_svc(X_train, y_train, C=C, gamma=gamma, iters=iters,
                        dtype=dtype, device=device)
    mat = convert.material_from_params(
        dict(hill=np.ones(6), sy=sy, khard=0., drucker=0.,
             scale_seq=sy if scale_seq is None else scale_seq, **params),
        is_svc=True, dev_only=dev_only, dtype=dtype, device=device)
    f = con.svc_decision(mat, _as_tensor(X_train, dtype, device))
    pred = torch.where(f > 0., 1., -1.).cpu().double().numpy()
    score = 100. * float(np.mean(pred == np.asarray(y_train, float)))
    return mat, score, params


def fit_svc_jax(X, y, C=10., gamma=1., iters=3000, sv_tol=1e-6,
                dtype=DTYPE_DEVICE, device=None):
    """``fit_svc`` under the JAX package's name and return type (the card's
    trainer; 'jax' names it in the JAX API): (SVCParams, dual variables)."""
    from pylabfea_tpu_torch.ops.svc import SVCParams
    p, a = fit_svc(X, y, C=C, gamma=gamma, iters=iters, sv_tol=sv_tol,
                   dtype=dtype, device=device)
    return SVCParams(support_vectors=p['sv'], dual_coef=p['dc'],
                     intercept=p['rho'], gamma=p['gamma']), a


def train_svc_jax(material, X_train, y_train, C=10., gamma=1., iters=3000,
                  dtype=DTYPE_DEVICE, device=None, score=True):
    """Fit the SVC on the card (or ``device``) and install it as a host
    ``Material``'s ML yield function, as the JAX ``train_svc_jax`` does:
    ``_svc`` the SVCParams, ``svm_yf`` None, ``ML_yf``, ``gam_yf``,
    ``C_yf``.  Returns the training accuracy in percent by the host's
    numpy decision function (None with ``score=False``: the host pass
    costs about as much as the fit on the card at 15,000 points)."""
    from pylabfea_tpu_torch.ops.svc import decision_function_np
    params, _ = fit_svc_jax(X_train, y_train, C=C, gamma=gamma, iters=iters,
                            dtype=dtype, device=device)
    material._svc = params
    material.svm_yf = None
    material.ML_yf = True
    material.gam_yf = float(gamma)
    material.C_yf = float(C)
    if not score:
        return None
    pred = np.where(decision_function_np(params, X_train) > 0, 1., -1.)
    return 100. * float(np.mean(pred == np.asarray(y_train)))
