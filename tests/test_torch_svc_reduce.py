"""PyTorch port: the reduced-set SVC compression (``ops.svc.reduce_svc``),
the decision-function Hessian and the flow-rule helpers (``hessian``,
``epl_dot``, ``c_tan``) against the JAX package, in float64 on the CPU.

``reduce_svc`` on the 135-SV SVC of ``REF_SOLVE_svc.npz``: the same
center count as JAX in its fixed (``n_out``) and ``abs_tol`` forms, and
the reduced decision function on 1024 probes within 1e-6 of the decision
values' scale of JAX's (Adam ascends q(Z) for 300 steps from the same
seeds in both; their gradients differ in the last bits, which the ascent
carries to ~1e-7); the RKHS bound |f - f~| <= |w - w~|_H holds on the
probes; k >= nsv copies the support vectors exactly."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import svc as jsvc
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.config import yf_tolerance
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import svc as tsvc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, 'REF_SOLVE_svc.npz')
T64 = dict(dtype=torch.float64, device='cpu')


def _params():
    z = np.load(NPZ)
    args = (z['support_vectors'], z['dual_coef'], float(z['intercept']),
            float(z['gamma']))
    return jsvc.SVCParams(*args), tsvc.SVCParams(*args)


def _probes(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return u * rng.uniform(0.3, 1.5, (n, 1))


def _f(p, x):
    return jsvc.decision_function(jsvc.SVCParams(
        p.support_vectors, p.dual_coef, p.intercept, p.gamma), x)


@pytest.mark.parametrize('kw', [dict(n_out=32), dict(abs_tol=0.05)],
                         ids=['n_out', 'abs_tol'])
def test_reduce_svc_matches_jax(kw):
    pj, pt = _params()
    rj, relj = jsvc.reduce_svc(pj, **kw)
    rt, relt = tsvc.reduce_svc(pt, device='cpu', **kw)
    assert rt.support_vectors.shape == rj.support_vectors.shape
    assert abs(relt - relj) <= 1e-6 * max(relj, 1e-12)
    P = _probes()
    f0, fj, ft = _f(pt, P), _f(rj, P), _f(rt, P)
    scale = np.abs(f0).max()
    assert np.abs(ft - fj).max() <= 1e-6 * scale
    # the RKHS distance bounds the decision-function error everywhere
    K = np.exp(-pt.gamma * np.maximum(
        np.sum(pt.support_vectors ** 2, 1)[:, None]
        + np.sum(pt.support_vectors ** 2, 1)[None]
        - 2. * pt.support_vectors @ pt.support_vectors.T, 0.))
    wnorm = np.sqrt(pt.dual_coef @ K @ pt.dual_coef)
    assert np.abs(ft - f0).max() <= relt * wnorm * (1. + 1e-9) + 1e-12
    if 'abs_tol' in kw:
        assert relt * wnorm <= kw['abs_tol'] * (1. + 1e-9)


def test_reduce_svc_full_count_is_exact_and_compress_specs(monkeypatch):
    _, pt = _params()
    red, rel = tsvc.reduce_svc(pt, n_out=500, device='cpu')
    assert rel == 0.
    np.testing.assert_array_equal(red.support_vectors, pt.support_vectors)
    np.testing.assert_array_equal(red.dual_coef, pt.dual_coef)
    # 'auto' and True = abs_tol of 10 % of the yield-tolerance band (bool
    # checked before int), a float = abs_tol, an int = n_out, False = the
    # raw set
    calls = []
    monkeypatch.setattr(tsvc, 'reduce_svc',
                        lambda p, **kw: calls.append(kw) or (p, 0.5))
    for spec in ('auto', True, 0.02, 12):
        assert convert.resolve_compress(pt, spec, device='cpu') == (pt, 0.5)
    assert convert.resolve_compress(pt, False, device='cpu') == (pt, 0.)
    assert calls == [dict(abs_tol=0.1 * yf_tolerance, device='cpu')] * 2 \
        + [dict(abs_tol=0.02, device='cpu'), dict(n_out=12, device='cpu')]
    assert [convert._compress_spec(s) for s in (True, 'auto', 12, 12.)] \
        == ['auto', 'auto', '12', '12.0']


def _materials():
    """The REF_SOLVE SVC (6-D stress features) and a Hill + Voce analytic
    material, as JAX and port materials."""
    z = np.load(NPZ)
    svc = dict(hill=np.ones(6), sy=float(z['sy']), khard=0., drucker=0.,
               sv=z['support_vectors'], dc=z['dual_coef'],
               rho=float(z['intercept']), gamma=float(z['gamma']),
               scale_seq=float(z['scale_seq']))
    hill = dict(hill=np.array([0.7, 1., 1.4, 1.1, 0.9, 1.]), sy=150.,
                khard=300., drucker=0.1, voce_r=40., voce_b=200.)
    out = []
    for params, is_svc in ((svc, True), (hill, False)):
        t = convert.material_from_params(params, is_svc=is_svc, **T64)
        full = dict(dict(sv=np.zeros((1, 6)), dc=np.zeros(1), rho=0.,
                         gamma=1., scale_seq=params['sy'], scale_wh=1.,
                         voce_r=0., voce_b=1.), **params)
        j = jcon.DeviceMaterial(
            **{k: jnp.asarray(v, jnp.float64) for k, v in full.items()},
            feat_mean=jnp.zeros(0), feat_scale=jnp.zeros(0),
            tex=jnp.zeros(0), is_svc=is_svc)
        out.append((t, j))
    return out, np.asarray(z['CV'])


def _states(n=64, seed=1, sy=150.):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * sy * rng.uniform(0.6, 1.3, (n, 1))
    return (sig, rng.normal(0., 1e-3, (n, 6)), rng.normal(0., 2e-4, (n, 6)),
            rng.uniform(0., 2e-3, n))


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.)


def test_decision_hessian_matches_jax():
    _, pt = _params()
    x = _probes(50, seed=2)
    h = tsvc.decision_hessian(*(torch.as_tensor(v) for v in (
        pt.support_vectors, pt.dual_coef)), pt.gamma, torch.as_tensor(x))
    hj = jsvc.decision_hessian(jsvc.SVCParams(
        pt.support_vectors, pt.dual_coef, pt.intercept, pt.gamma), x)
    _close(h, hj)
    # symmetric, and the derivative of the gradient
    _close(h, h.transpose(1, 2))
    g = lambda y: jsvc.decision_gradient(jsvc.SVCParams(  # noqa: E731
        pt.support_vectors, pt.dual_coef, pt.intercept, pt.gamma), y)
    e = 1e-6
    fd = (g(x + e * np.eye(6)[3]) - g(x - e * np.eye(6)[3])) / (2. * e)
    assert np.abs(h.numpy()[:, :, 3] - fd).max() < 1e-6 * np.abs(fd).max()


def test_hessian_epl_dot_c_tan_match_jax():
    mats, CV = _materials()
    sig, _, deps, peeq = _states()
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    CVt = t(CV)
    for (tm, jm), is_svc in zip(mats, (True, False)):
        if is_svc:
            _close(tcon.hessian(tm, t(sig)), jcon.hessian(jm, sig))
        else:
            with pytest.raises(NotImplementedError):
                tcon.hessian(tm, t(sig))
        _close(tcon.epl_dot(tm, t(sig), t(peeq), CVt, t(deps)),
               jcon.epl_dot(jm, sig, peeq, CV, deps))
        _close(tcon.c_tan(tm, t(sig), CVt), jcon.c_tan(jm, sig, CV))
