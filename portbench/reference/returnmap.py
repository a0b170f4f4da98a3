"""Yield functions and the cutting-plane return map, in plain PyTorch.

Two criteria, as a configuration file states them:

* ``svc``: the trained support-vector classifier of pyLabFEA's machine
  learning yield function, f(sig) = sum_s dc_s exp(-gamma |x - sv_s|^2) +
  rho on the features x = sig / scale_seq (the deviator of sig with
  ``dev_only``); dimensionless, plastic where f > yf_tol.
* ``j2``: von Mises with linear hardening, f = seq - (sy + khard * peeq),
  plastic where f > yf_tol * (sy + khard * peeq).

``response`` is the closest-point return map by cutting planes (Simo and
Hughes, algorithm 3.5.2) over ``nsub`` equal substeps, at most ``maxiter``
trips each, with the trust region of 0.1 scale_seq on a trip's stress
correction for the SVC, the radial fallback of the analytic criterion and
the exact path-secant tangent.  Every operation runs in the dtype of the
inputs.
"""
from dataclasses import dataclass

import numpy as np
import torch

#: rows of the SVC decision function evaluated at once
CHUNK = 1 << 18


@dataclass
class Criterion:
    """A yield criterion with its parameters (host floats and float64
    numpy arrays)."""
    kind: str                 # 'svc' or 'j2'
    sy: float
    yf_tol: float
    khard: float = 0.
    sv: np.ndarray = None     # (nsv, F)
    dc: np.ndarray = None     # (nsv,)
    rho: float = 0.
    gamma: float = 1.
    scale_seq: float = 1.
    dev_only: bool = False


def criterion_from(cfg, root):
    """The criterion of a configuration's ``material`` block; an SVC reads
    its raw file (a path relative to ``root``)."""
    m = cfg['material']
    tol = float(cfg['yf_tolerance'])
    if m['criterion'] == 'j2':
        return Criterion('j2', float(m['sy']), tol, float(m['khard']))
    with np.load(f'{root}/{m["svc_file"]}') as z:
        return Criterion('svc', float(z['sy']), tol, 0.,
                         np.asarray(z['support_vectors'], np.float64),
                         np.asarray(z['dual_coef'], np.float64),
                         float(z['intercept']), float(z['gamma']),
                         float(z['scale_seq']), bool(z['dev_only']))


def elastic_stiffness(E, nu):
    """Isotropic Voigt stiffness (6, 6), engineering shears, float64."""
    lam = E * nu / ((1. + nu) * (1. - 2. * nu))
    mu = E / (2. * (1. + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[range(3), range(3)] = lam + 2. * mu
    C[range(3, 6), range(3, 6)] = mu
    return C


def deviator(sig):
    p = sig[..., :3].mean(-1, keepdim=True)
    return torch.cat([sig[..., :3] - p, sig[..., 3:]], -1)


def seq_j2(sig):
    s = deviator(sig)
    ss = (s[..., :3] ** 2).sum(-1) + 2. * (s[..., 3:] ** 2).sum(-1)
    return torch.sqrt(1.5 * ss)


def eps_eq(e):
    """Equivalent strain of Voigt rows with engineering shears."""
    return torch.sqrt(2. / 3. * ((e[..., :3] ** 2).sum(-1)
                                 + 0.5 * (e[..., 3:] ** 2).sum(-1)))


def _svc(c: Criterion, sig, grad):
    dt, dev = sig.dtype, sig.device
    sv = torch.as_tensor(c.sv, dtype=dt, device=dev)
    dc = torch.as_tensor(c.dc, dtype=dt, device=dev)
    x = (deviator(sig) if c.dev_only else sig) / c.scale_seq
    fs, gs = [], []
    for i in range(0, x.shape[0], CHUNK):
        xi = x[i:i + CHUNK]
        diff = xi[:, None, :] - sv[None, :, :]
        k = dc * torch.exp(-c.gamma * (diff * diff).sum(-1))
        fs.append(k.sum(-1) + c.rho)
        if grad:
            gs.append(-2. * c.gamma * (k[:, :, None] * diff).sum(1))
    f = torch.cat(fs)
    if not grad:
        return f, None
    g = torch.cat(gs) / c.scale_seq
    if c.dev_only:
        g = deviator(g)
    return f, g


def yield_value(c: Criterion, sig, epl):
    """(f, f / scale) with the scale of the tolerance band: 1 for the SVC,
    the flow stress for J2."""
    if c.kind == 'svc':
        f = _svc(c, sig, False)[0]
        return f, f
    sflow = c.sy + c.khard * eps_eq(epl)
    f = seq_j2(sig) - sflow
    return f, f / sflow


def f_grad(c: Criterion, sig, epl):
    """(f, df/dsig with engineering-shear flow components, hardening
    modulus, tolerance) of every row."""
    if c.kind == 'svc':
        f, a = _svc(c, sig, True)
        return f, a, 0., c.yf_tol
    sflow = c.sy + c.khard * eps_eq(epl)
    seq = seq_j2(sig)
    s = deviator(sig)
    safe = torch.where(seq > 0., seq, 1.)
    a = torch.cat([1.5 * s[:, :3], 3. * s[:, 3:]], -1) / safe[:, None]
    return seq - sflow, a, c.khard, c.yf_tol * sflow


def response(c: Criterion, sig0, epl0, deps, C, maxiter=12, nsub=1):
    """The return map of every row from (sig0, epl0) under the strain
    increment ``deps``.  Returns (f at the end, sig, plastic strain
    increment, tangent (N, 6, 6))."""
    dt = sig0.dtype
    N = sig0.shape[0]
    C = C.to(dt)
    Cinv = torch.linalg.inv(C.double()).to(dt)
    cap = 0.1 * c.scale_seq if c.kind == 'svc' else float('inf')
    floor = 1e-12 * float(C.abs().max())
    d_s = deps / nsub
    sig, depl = sig0, torch.zeros_like(sig0)
    f0 = yield_value(c, sig0, epl0)[0]
    any_pl = torch.zeros(N, dtype=torch.bool, device=sig0.device)
    tan = torch.zeros((N, 6, 6), dtype=dt, device=sig0.device)
    for _ in range(nsub):
        sig_in, depl_in = sig, depl
        sig_tr = sig_in + d_s @ C.T
        f, a, kh, tol = f_grad(c, sig_tr, epl0 + depl_in)
        plastic = f > tol
        denom_f = torch.where(f - f0 == 0., 1., f - f0)
        alpha = torch.where(plastic & (f0 < 0.), -f0 / denom_f,
                            torch.where(plastic, 0., 1.).to(dt))
        alpha = alpha.clamp(0., 1.)
        sig, depl = sig_tr, depl_in
        for _ in range(maxiter):
            act = plastic & (f.abs() > tol)
            if not bool(act.any()):
                break
            ca = a @ C.T
            den = torch.clamp((ca * a).sum(-1) + kh, min=floor)
            lam = torch.where(act, f / den, 0.)
            step = lam.abs() * torch.linalg.vector_norm(ca, dim=-1)
            lam = lam * torch.where(step > cap, cap / torch.where(
                step == 0., 1., step), 1.)
            sig = sig - lam[:, None] * ca
            depl = depl + lam[:, None] * a
            f, a, kh, tol = f_grad(c, sig, epl0 + depl)
        sig = torch.where(plastic[:, None], sig, sig_tr)
        depl = torch.where(plastic[:, None], depl, depl_in)
        if c.kind == 'j2':
            seq = seq_j2(sig)
            over = plastic & (f > tol) & (seq > 1e-8)
            fac = torch.where(over, f / torch.where(seq == 0., 1., seq), 0.)
            dx = sig * fac[:, None]
            sig = sig - dx
            depl = depl + dx @ Cinv.T
            f, a, kh, tol = f_grad(c, sig, epl0 + depl)
        ca = a @ C.T
        den = torch.clamp((ca * a).sum(-1) + kh, min=floor)
        Ct = C[None] - ca[:, :, None] * ca[:, None, :] / den[:, None, None]
        tan = tan + (alpha[:, None, None] * C[None]
                     + (1. - alpha)[:, None, None] * Ct) / nsub
        any_pl = any_pl | plastic
        f0 = f
    mu = 1e-5 if dt == torch.float64 else 1e-4
    w = deps @ C.T - (sig - sig0)
    den = (w * deps).sum(-1)
    q = ((w @ Cinv.T) * w).sum(-1)
    ok = any_pl & (den > 0.) & (q > 0.)
    dsafe = torch.where(ok, torch.maximum(den, (1. + mu) * q), 1.)
    sec = C[None] - w[:, :, None] * w[:, None, :] / dsafe[:, None, None]
    tan = torch.where(ok[:, None, None], sec, tan)
    return f, sig, depl, tan
