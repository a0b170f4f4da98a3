"""PyTorch port, kernels A, D and E: the SVC decision function (D) and the
decision function + gradient (A: exact distances, E: matmul expansion).

The port's plain versions (what the kernel wrappers run on CPU tensors) are
held against the TPU kernels ``svc_f_grad_pallas``,
``svc_decision_pallas`` and ``svc_f_grad_pallas_mxu`` in interpret mode
(f32) and against the JAX ``constitutive`` and ``svc`` functions (f64).
Inputs are made with numpy from a seed and handed to both.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import svc as jsvc
from pylabfea_tpu.ops.pallas_kernels import (svc_decision_pallas,
                                             svc_f_grad_pallas,
                                             svc_f_grad_pallas_mxu)
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import svc as tsvc
from pylabfea_tpu_torch.ops import svc_kernels as sk

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'REF_SOLVE_svc.npz')


def _svc(nsv):
    """(sv, dc, gamma, rho): the trained 135-SV SVC, or a seeded one."""
    if nsv == 135:
        z = np.load(NPZ)
        return (z['support_vectors'], z['dual_coef'], float(z['gamma']),
                float(z['intercept']))
    rng = np.random.default_rng(3)
    sv = rng.normal(size=(nsv, 6)) * 0.8
    dc = rng.choice([-1., 1.], nsv) * rng.uniform(0.1, 1., nsv)
    return sv, dc, 2.5, 0.3


def _points(n=300, seed=4):
    return np.random.default_rng(seed).normal(size=(n, 6)) * 0.6


def _jax_material(dev_only=False):
    z = np.load(NPZ)
    f64 = jnp.float64
    return jcon.DeviceMaterial(
        hill=jnp.ones(6, f64), sy=jnp.asarray(float(z['sy']), f64),
        khard=jnp.asarray(0., f64), drucker=jnp.asarray(0., f64),
        sv=jnp.asarray(z['support_vectors'], f64),
        dc=jnp.asarray(z['dual_coef'], f64),
        rho=jnp.asarray(float(z['intercept']), f64),
        gamma=jnp.asarray(float(z['gamma']), f64),
        scale_seq=jnp.asarray(float(z['scale_seq']), f64),
        scale_wh=jnp.asarray(1., f64), feat_mean=jnp.zeros(0, f64),
        feat_scale=jnp.zeros(0, f64), tex=jnp.zeros(0, f64), is_svc=True,
        dev_only=dev_only)


def _torch_material(dm):
    params = {k: np.asarray(v) for k, v in dm._asdict().items()
              if k not in ('is_svc', 'dev_only', 'sdim3')}
    return convert.material_from_params(params, is_svc=dm.is_svc,
                                        dev_only=dm.dev_only,
                                        dtype=torch.float64, device='cpu')


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize('with_grad', [True, False])
@pytest.mark.parametrize('nsv', [64, 135])
def test_plain_matches_pallas_kernel_f32(nsv, with_grad):
    """f32, N=300 (no tile multiple).  The port's plain version uses the
    matmul-expansion distances, the Pallas kernel exact subtract-square:
    atol 2e-5 max(1, sum|dc|) on f; g carries the extra factor
    2 gamma max|x - sv| of its definition."""
    sv, dc, gamma, rho = _svc(nsv)
    x = _points()
    f32 = np.float32
    fj, gj = svc_f_grad_pallas(jnp.asarray(x, f32), jnp.asarray(sv, f32),
                               jnp.asarray(dc, f32), gamma, rho,
                               with_grad=with_grad, interpret=True)
    ft, gt = sk.svc_f_grad(torch.tensor(x, dtype=torch.float32),
                           torch.tensor(sv, dtype=torch.float32),
                           torch.tensor(dc, dtype=torch.float32), gamma, rho,
                           with_grad=with_grad)
    tol = 2e-5 * max(1., np.abs(dc).sum())
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=tol)
    if with_grad:
        gtol = tol * 2. * gamma * (np.abs(x).max() + np.abs(sv).max())
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                                   atol=gtol)
    else:
        assert gt is None
        assert not np.asarray(gj).any()


@pytest.mark.parametrize('nsv', [64, 135])
def test_plain_decision_matches_pallas_kernel_f32(nsv):
    """Kernel D's plain version against ``svc_decision_pallas`` (both the
    matmul expansion), f32, N=300: atol 2e-5 max(1, sum|dc|)."""
    sv, dc, gamma, rho = _svc(nsv)
    x = _points(seed=8)
    f32 = np.float32
    fj = svc_decision_pallas(jnp.asarray(x, f32), jnp.asarray(sv, f32),
                             jnp.asarray(dc, f32), gamma, rho, interpret=True)
    ft = sk.svc_decision(*(torch.tensor(a, dtype=torch.float32)
                           for a in (x, sv, dc)), gamma, rho)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0,
                               atol=2e-5 * max(1., np.abs(dc).sum()))


@pytest.mark.parametrize('nsv', [64, 135])
def test_plain_mm_matches_pallas_mxu_kernel_f32(nsv):
    """Kernel E's plain version against ``svc_f_grad_pallas_mxu``, f32,
    N=300, under the bounds of the kernel A test."""
    sv, dc, gamma, rho = _svc(nsv)
    x = _points(seed=9)
    f32 = np.float32
    fj, gj = svc_f_grad_pallas_mxu(jnp.asarray(x, f32), jnp.asarray(sv, f32),
                                   jnp.asarray(dc, f32), gamma, rho,
                                   interpret=True)
    ft, gt = sk.svc_f_grad_mm(*(torch.tensor(a, dtype=torch.float32)
                                for a in (x, sv, dc)), gamma, rho)
    tol = 2e-5 * max(1., np.abs(dc).sum())
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=tol)
    gtol = tol * 2. * gamma * (np.abs(x).max() + np.abs(sv).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=gtol)


@pytest.mark.parametrize('nsv', [64, 135])
def test_plain_decision_matches_jax_f64(nsv):
    """Kernel D's and E's plain versions against the JAX SVC module's
    decision function and gradient, f64, 1e-12."""
    sv, dc, gamma, rho = _svc(nsv)
    x = _points(seed=10)
    p = jsvc.SVCParams(support_vectors=sv, dual_coef=dc, intercept=rho,
                       gamma=gamma)
    args = tuple(torch.tensor(a) for a in (x, sv, dc))
    fj = jsvc.decision_function_jax(p, x, dtype=jnp.float64)
    _close(sk.svc_decision(*args, gamma, rho), fj, 1e-12)
    ft, gt = sk.svc_f_grad_mm(*args, gamma, rho)
    _close(ft, fj, 1e-12)
    _close(gt, jsvc.decision_gradient_jax(p, x, dtype=jnp.float64), 1e-12)


def test_decision_and_gradient_match_jax_f64():
    dm = _jax_material()
    mat = _torch_material(dm)
    x = _points(seed=5)
    fj, gj = jcon.svc_decision_and_gradient(dm, jnp.asarray(x))
    ft, gt = tcon.svc_decision_and_gradient(mat, torch.tensor(x))
    _close(ft, fj, 1e-12)
    _close(gt, gj, 1e-12)
    _close(tcon.svc_decision(mat, torch.tensor(x)),
           jcon.svc_decision(dm, jnp.asarray(x)), 1e-12)
    _close(tcon.svc_gradient(mat, torch.tensor(x)),
           jcon.svc_gradient(dm, jnp.asarray(x)), 1e-12)


def test_svc_module_matches_jax_f64():
    sv, dc, gamma, rho = _svc(64)
    x = _points(seed=6)
    p = jsvc.SVCParams(support_vectors=sv, dual_coef=dc, intercept=rho,
                       gamma=gamma)
    svt, dct, xt = (torch.tensor(a) for a in (sv, dc, x))
    _close(tsvc.decision_function(svt, dct, rho, gamma, xt),
           jsvc.decision_function_jax(p, x), 1e-12)
    _close(tsvc.decision_gradient(svt, dct, gamma, xt),
           jsvc.decision_gradient_jax(p, x), 1e-12)


@pytest.mark.parametrize('dev_only', [False, True])
def test_yield_function_and_gradient_match_jax_f64(dev_only):
    """Stress features with and without the deviatoric projection."""
    dm = _jax_material(dev_only)
    mat = _torch_material(dm)
    rng = np.random.default_rng(7)
    sig = rng.normal(size=(200, 6)) * 100.
    peeq = np.zeros(200)
    fj, aj, khj = jcon.yf_and_fgrad(dm, jnp.asarray(sig), jnp.asarray(peeq))
    ft, at, kht = tcon.yf_and_fgrad(mat, torch.tensor(sig), torch.tensor(peeq))
    _close(ft, fj, 1e-12)
    _close(at, aj, 1e-12)
    assert kht == float(khj)
    _close(tcon.yf(mat, torch.tensor(sig), torch.tensor(peeq)),
           jcon.yf(dm, jnp.asarray(sig), jnp.asarray(peeq)), 1e-12)


def test_material_from_npz_matches_params():
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=torch.float64,
                                             device='cpu')
    ref = _torch_material(_jax_material())
    assert mat.sv.shape == (135, 6) and eps == 0.002 and CV.shape == (6, 6)
    for k in ('sv', 'dc', 'hill'):
        assert torch.equal(getattr(mat, k), getattr(ref, k))
    for k in ('gamma', 'rho', 'scale_seq', 'sy', 'khard', 'is_svc',
              'dev_only'):
        assert getattr(mat, k) == getattr(ref, k)


def test_unported_materials_raise():
    """Criteria without a device form and SVC feature widths the JAX device
    path does not serve raise; its five layouts convert."""
    dm = _jax_material()
    params = {k: np.asarray(v) for k, v in dm._asdict().items()
              if k not in ('is_svc', 'dev_only', 'sdim3')}
    cpu = dict(device='cpu')
    for crit in (dict(tresca=True), dict(barlat=np.ones(18)),
                 dict(lhs=np.zeros(4))):
        with pytest.raises(NotImplementedError):
            convert.material_from_params(dict(params, **crit), is_svc=False,
                                         **cpu)
    for bad in (dict(sv=np.ones((4, 7))), dict(sv=np.ones((4, 3))),
                dict(tex=np.ones(3)),
                dict(sv=np.ones((4, 9)), tex=np.ones(3),
                     feat_mean=np.zeros(9), feat_scale=np.ones(8))):
        with pytest.raises(NotImplementedError, match='got Ndof='):
            convert.material_from_params(dict(params, **bad), is_svc=True,
                                         **cpu)
    for good in (dict(sv=np.ones((4, 2))), dict(sv=np.ones((4, 15))),
                 dict(sv=np.ones((4, 9)), tex=np.ones(3),
                      feat_mean=np.zeros(9), feat_scale=np.ones(9)),
                 dict(sv=np.ones((4, 18)), tex=np.ones(3),
                      feat_mean=np.zeros(18), feat_scale=np.ones(18))):
        mat = convert.material_from_params(dict(params, **good, dc=np.ones(4)),
                                           is_svc=True, sdim3=True, **cpu)
        assert mat.sv.shape == good['sv'].shape
        assert mat.tex.shape == np.shape(good.get('tex', np.zeros(0)))
