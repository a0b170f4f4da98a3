"""PyTorch port: plastic-parameter identification (``ops.calibrate``) and
the fixed-trip return map it differentiates, against the JAX reference in
float64: values, forward-mode Jacobian columns (``jax.jacfwd``) and
reverse-mode gradients (``jax.grad``) through both integrators, a short
Levenberg-Marquardt fit and a database fit in the tensor shear
convention.  The return map runs live in JAX; the Jacobians, gradients
and fits are held against JAX's results committed in
``pylabfea_tpu_torch/data/ref_calibrate.npz``
(``tools/make_torch_ref_fixtures.py calibrate``)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import calibrate as jcal
from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import calibrate as tcal
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import dual

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

HILL = np.array([1.2, 0.9, 1.05, 1.0, 1.0, 1.0])
SY, KHARD = 150., 500.
CPU64 = dict(dtype=torch.float64, device='cpu')
REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pylabfea_tpu_torch', 'data', 'ref_calibrate.npz')
#: theta of the derivative checks: Hill, linear and Voce hardening, and
#: the 21 Cholesky coefficients of the elastic stiffness
THETA = {'log_sy': np.log(SY), 'log_hill': np.log(HILL), 'raw_dsy': 2.0,
         'raw_vr': 3.0, 'log_vb_peeq': 1.0}


def _cv(E=200000., nu=0.3):
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    CV = np.zeros((6, 6))
    CV[:3, :3] = lam
    CV[np.arange(3), np.arange(3)] += 2 * mu
    CV[np.arange(3, 6), np.arange(3, 6)] = mu
    return CV


def _jmat(hill, sy, khard, vr=0., vb=1.):
    return jcon.DeviceMaterial(
        hill=jnp.asarray(hill), sy=jnp.asarray(sy), khard=jnp.asarray(khard),
        drucker=jnp.asarray(0.), sv=jnp.zeros((1, 6)), dc=jnp.zeros(1),
        rho=jnp.asarray(0.), gamma=jnp.asarray(1.),
        scale_seq=jnp.asarray(sy), scale_wh=jnp.asarray(1.),
        feat_mean=jnp.zeros(0), feat_scale=jnp.zeros(0), tex=jnp.zeros(0),
        voce_r=jnp.asarray(vr), voce_b=jnp.asarray(vb),
        is_svc=False, dev_only=False, sdim3=False)


def _tmat(hill, sy, khard, vr=0., vb=1.):
    return convert.material_from_params(
        dict(hill=hill, sy=sy, khard=khard, drucker=0., voce_r=vr,
             voce_b=vb), is_svc=False, **CPU64)


def _paths(npaths, nsteps, seed=0, step=1.6e-3, first=2.5e-4):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(npaths, 6))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    steps = np.full(nsteps, step)
    steps[:3] = first
    return dirs[:, None, :] * steps[None, :, None]


def _simulate(deps, maxiter=40):
    """Stress paths of the hidden Hill material (the JAX return map)."""
    th = {'log_sy': jnp.log(SY), 'log_hill': jnp.log(jnp.asarray(HILL)),
          'raw_dsy': jnp.asarray(float(np.log(np.expm1(KHARD))))}
    return np.asarray(jcal.simulate_paths(th, jnp.asarray(_cv()),
                                          jnp.asarray(deps), maxiter))


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize('nsub', [1, 3])
def test_fixed_trip_matches_jax(nsub):
    """``response_fast(fixed_trip=True)``: every plastic lane polished to
    machine zero, the rest of the outputs within 1e-12 of JAX's."""
    rng = np.random.default_rng(nsub)
    N = 64
    u = rng.normal(size=(N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * SY * rng.uniform(0.3, 1.0, (N, 1))
    epl = np.abs(rng.normal(size=(N, 6))) * 1e-3
    deps = rng.normal(size=(N, 6)) * 1e-3
    args = (HILL, SY, KHARD, 40., 80.)
    out_j = jcon.response_fast(_jmat(*args), (jnp.asarray(sig),
                                              jnp.asarray(epl)),
                               jnp.asarray(deps), jnp.asarray(_cv()), 40,
                               nsub, fixed_trip=True)
    t = lambda a: torch.as_tensor(a)
    out_t = tcon.response_fast(_tmat(*args), (t(sig), t(epl)), t(deps),
                               t(_cv()), 40, nsub, fixed_trip=True)
    plastic = out_t[2].abs().sum(-1) > 0
    assert int(plastic.sum()) > N // 4
    assert float(out_t[0][plastic].abs().max()) < 1e-8
    for a, b in zip(out_t[1:], out_j[1:]):
        _close(a, b, 1e-12)


def test_svc_derivative_raises_and_plain_call_serves():
    """The derivative of an SVC return map needs the decision function's
    second derivative, which the port does not have: asking for one
    raises (reverse or forward mode), it is never served quietly."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mat, CV, _ = convert.material_from_npz(
        os.path.join(root, 'REF_SOLVE_svc.npz'), **CPU64)
    CV = torch.as_tensor(CV)
    sig = torch.full((4, 6), 20., dtype=torch.float64)
    deps = torch.full((4, 6), 1e-4, dtype=torch.float64)
    z = torch.zeros_like(sig)
    out = tcon.response_fast(mat, (sig, z), deps, CV, 40, fixed_trip=True)
    assert torch.isfinite(out[1]).all()
    with pytest.raises(NotImplementedError, match='hessian'):
        tcon.response_fast(mat, (sig, z), deps.requires_grad_(), CV, 40,
                           fixed_trip=True)
    with pytest.raises(NotImplementedError, match='hessian'):
        tcon.response_fast(mat, (sig, z), dual.seed(deps.detach()), CV, 40,
                           fixed_trip=True)


@pytest.fixture(scope='module')
def ref():
    """JAX's results of ``tools/make_torch_ref_fixtures.py calibrate``."""
    with np.load(REF) as z:
        return {k: z[k] for k in z.files}


def _jax_ref(ref, integ):
    """JAX values and forward-mode Jacobian of ``simulate_paths`` with
    ``integ`` (the elastic constants among the parameters), and for the
    unrolled integrator the reverse-mode gradient of the mean square (from
    the committed fixture, whose inputs are checked here)."""
    deps = _paths(4, 8, seed=1)
    th = dict(THETA, cv_raw=tcal._cv_raw_of(_cv()))
    np.testing.assert_array_equal(deps, ref['jac.deps'])
    for k, v in th.items():
        np.testing.assert_array_equal(v, ref[f'jac.theta.{k}'])
    return deps, th, (ref[f'jac.{integ}.y'], ref[f'jac.{integ}.J'],
                      ref.get(f'jac.{integ}.g'))


def _port_fn(deps, th, integ):
    theta = convert.theta_from_arrays(th, **CPU64)
    x0, unravel = tcal.ravel_theta(theta)

    def f(x):
        return tcal.simulate_paths(unravel(x), torch.as_tensor(_cv()),
                                   torch.as_tensor(deps), 40, 1, 0.01,
                                   integ).reshape(-1)
    return f, x0


@pytest.mark.parametrize('integ', ['unrolled', 'implicit'])
def test_simulate_paths_and_jacobian_match_jax(ref, integ):
    """A JAX theta carried by ``convert.theta_from_arrays`` gives the same
    stress paths, and the forward-mode Jacobian (every column in one pass)
    matches ``jax.jacfwd`` within 1e-9."""
    deps, th, out = _jax_ref(ref, integ)
    f, x0 = _port_fn(deps, th, integ)
    val, J = dual.jacfwd(f, x0)
    _close(f(x0), out[0], 1e-12)
    _close(val, out[0], 1e-12)
    _close(J, out[1], 1e-9)


@pytest.mark.parametrize('integ', ['unrolled', 'implicit'])
def test_autograd_gradient_matches_jax(ref, integ):
    """``torch.autograd`` through the return-map scan: against ``jax.grad``
    for the unrolled integrator, and for the implicit one (whose backward
    is the implicit-function formula of ``_BEProject``) against the
    gradient 2/m J^T y of JAX's forward-mode Jacobian."""
    deps, th, (y, J, g) = _jax_ref(ref, integ)
    if g is None:
        g = 2. / y.size * J.T @ y
    f, x0 = _port_fn(deps, th, integ)
    x = x0.clone().requires_grad_(True)
    torch.mean(f(x) ** 2).backward()
    _close(x.grad, g, 1e-9)


def test_implicit_projection_serves_torch_func_and_forward_ad(ref):
    """The implicit projection is a ``torch.autograd.Function``: a
    ``torch.func.jvp`` column and a ``forward_ad`` column through it equal
    ``jax.jacfwd``'s."""
    deps, th, out = _jax_ref(ref, 'implicit')
    f, x0 = _port_fn(deps, th, 'implicit')
    e = torch.zeros_like(x0)
    e[0] = 1.
    _, col = torch.func.jvp(f, (x0,), (e,))
    _close(col, out[1][:, 0], 1e-9)
    from torch.autograd import forward_ad as fwAD
    with fwAD.dual_level():
        y = f(fwAD.make_dual(x0, e))
        col2 = fwAD.unpack_dual(y).tangent
    _close(col2, out[1][:, 0], 1e-9)


def test_gradients_finite_at_virgin_state():
    """Virgin lanes sit on the sqrt kink of every equivalent measure; the
    gradients through the fixed-trip map stay finite there."""
    deps = torch.as_tensor(_paths(4, 3, seed=2))
    sig = torch.as_tensor(_simulate(deps.numpy()))
    theta = {'log_sy': torch.tensor(np.log(SY), dtype=torch.float64,
                                    requires_grad=True),
             'log_hill': torch.tensor(np.log(HILL), requires_grad=True),
             'raw_dsy': torch.tensor(2.0, dtype=torch.float64,
                                     requires_grad=True)}
    loss = torch.mean((tcal.simulate_paths(theta, torch.as_tensor(_cv()),
                                           deps, 40, 1, 0.01) - sig) ** 2)
    loss.backward()
    for k, v in theta.items():
        assert torch.isfinite(v.grad).all(), k


def test_fit_plasticity_matches_jax(ref):
    """Three Levenberg-Marquardt steps from the slope seed land where
    JAX's do, with the same cost history (JAX's data and fit from the
    committed fixture)."""
    deps = _paths(6, 12, seed=3)
    np.testing.assert_array_equal(deps, ref['fit.deps'])
    sig = ref['fit.sig']
    kw = dict(steps=3, maxiter=40)
    pt, it = tcal.fit_plasticity(torch.as_tensor(deps), torch.as_tensor(sig),
                                 _cv(), **kw)
    np.testing.assert_allclose(it['loss'], ref['fit.loss'], rtol=1e-6)
    assert it['loss'][-1] < 1e-3 * it['loss'][0]
    for k in ('sy', 'khard', 'hill'):
        np.testing.assert_allclose(pt[k], ref[f'fit.{k}'], rtol=1e-8)
    _close(it['sim'], ref['fit.sim'], 1e-8)
    for k in ('sy', 'khard', 'hill'):
        np.testing.assert_allclose(it['param_std'][k], ref[f'fit.std.{k}'],
                                   rtol=1e-5)


def test_fit_from_data_tensor_convention_matches_jax(ref):
    """A records dict in the tensor shear convention: the shear strains
    doubled, the elastic stiffness refitted from the pre-yield samples
    (the port's ``dataio.get_elastic_coefficients``) and a short
    deviatoric fit, as JAX does them (JAX's fit from the committed
    fixture)."""
    deps = _paths(6, 16, seed=5, step=1.2e-3, first=2e-4)
    sig = ref['data.sig']
    eps = np.cumsum(deps, axis=1)
    eps[..., 3:] *= 0.5
    np.testing.assert_array_equal(eps, ref['data.eps'])
    records = {f'case{p}': {'Stress': sig[p], 'Strain_Total': eps[p]}
               for p in range(len(deps))}
    kw = dict(nsteps=12, shear_convention='tensor', steps=2)
    pt, it = tcal.fit_from_data(records, device='cpu', **kw)
    _close(it['CV'], ref['data.CV'], 1e-9)
    np.testing.assert_allclose(it['loss'], ref['data.loss'], rtol=1e-6)
    for k in ('sy', 'khard', 'hill'):
        np.testing.assert_allclose(pt[k], ref[f'data.{k}'], rtol=1e-7)
