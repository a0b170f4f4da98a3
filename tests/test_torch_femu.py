"""PyTorch port: differentiable FE (``ops.femu``) against the JAX reference
in float64 on a 4 x 4 two-material inclusion specimen: the implicit load
steps' forward values, the forward-mode column of the implicit tangent
solve against the port's own central differences (on the JAX package's
single-material specimen, where the secant-Picard solve converges to
rounding), and a full-field identification round trip."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import fe_kernels as jfek
from pylabfea_tpu.ops import femu as jfemu
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import dual
from pylabfea_tpu_torch.ops import fe_kernels as tfek
from pylabfea_tpu_torch.ops import femu as tfemu

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

N = 4
SY_T, H0_T = 150., 1.25
FRACS = [0.5, 0.5]
CPU64 = dict(dtype=torch.float64, device='cpu')


def _cv(E, nu=0.3):
    hh = E / ((1 + nu) * (1 - 2 * nu))
    CV = np.zeros((6, 6))
    CV[:3, :3] = nu * hh
    np.fill_diagonal(CV[:3, :3], (1 - nu) * hh)
    CV[3, 3] = CV[4, 4] = CV[5, 5] = (0.5 - nu) * hh
    return CV


CVS = (_cv(200.e3), _cv(60.e3))
MAT_MAP = np.zeros((N, N), dtype=int)
MAT_MAP[1:3, 1:3] = 1


def _jax_build(theta):
    """The JAX femu builder: Hill matrix (sy, h0 free) and an elastic
    inclusion (a yield strength no stress reaches)."""
    sy = jnp.exp(theta['log_sy'])

    def mat(hill, s, kh):
        return jcon.DeviceMaterial(
            hill=jnp.asarray(hill), sy=s, khard=jnp.asarray(kh),
            drucker=jnp.asarray(0.), sv=jnp.zeros((1, 6)), dc=jnp.zeros(1),
            rho=jnp.asarray(0.), gamma=jnp.asarray(1.), scale_seq=s,
            scale_wh=jnp.asarray(1.), feat_mean=jnp.zeros(0),
            feat_scale=jnp.zeros(0), tex=jnp.zeros(0), is_svc=False,
            dev_only=False, sdim3=False)
    hill = jnp.asarray([1., 0.9, 1., 1., 1., 1.]).at[0].set(
        jnp.exp(theta['log_h0']))
    return (mat(hill, sy, 300.),
            mat(jnp.ones(6), jnp.asarray(convert.ELASTIC_SY), 0.))


def _port_build(base):
    """The port's builder over the converted materials ``base``: the
    matrix's sy (and scale_seq) and hill[0] from theta tensors."""
    def build(theta):
        sy = torch.exp(theta['log_sy'])
        hill = torch.cat([torch.exp(theta['log_h0']).reshape(1),
                          base[0].hill[1:]])
        return (dataclasses.replace(base[0], hill=hill, sy=sy, scale_seq=sy),
                base[1])
    return build


def _meshes():
    kw = dict(LX=1., LY=1., uniax='y', eps_tot=0.004, mat_map=MAT_MAP)
    return (jfek.rect_mesh(N, N, dtype=jnp.float64, **kw),
            tfek.rect_mesh(N, N, **CPU64, **kw))


def _truth():
    return {'log_sy': np.log(SY_T), 'log_h0': np.log(H0_T)}


def _converted():
    """The JAX builder's output at the truth, carried into the port by
    ``convert.material_tree_from_params``."""
    mats = _jax_build({k: jnp.asarray(v) for k, v in _truth().items()})
    items = []
    for m in mats:
        d = {k: np.asarray(v) for k, v in m._asdict().items()
             if k not in ('is_svc', 'dev_only', 'sdim3')}
        items.append(dict(d, is_svc=m.is_svc, dev_only=m.dev_only,
                          sdim3=m.sdim3))
    return convert.material_tree_from_params(items, **CPU64)


@pytest.fixture(scope='module')
def jax_field():
    mj, _ = _meshes()
    th = {k: jnp.asarray(v) for k, v in _truth().items()}
    u, sig, epl, _ = jfemu.simulate(mj, _jax_build(th),
                                    tuple(jnp.asarray(c) for c in CVS), FRACS)
    return np.asarray(u), np.asarray(sig), np.asarray(epl)


def test_simulate_matches_jax(jax_field):
    """Two implicit load steps (the JAX defaults: 40 fixed trips, 14
    secant-Picard rounds) from the JAX builder's converted materials."""
    _, mt = _meshes()
    u, sig, epl, dus = tfemu.simulate(mt, _converted(), CVS, FRACS)
    for a, b in zip((u, sig, epl), jax_field):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-9 * np.abs(b).max())
    assert float(epl.abs().max()) > 1e-4       # the matrix yields
    assert torch.allclose(dus[0] + dus[1], u)


def _field(log_sy, **kw):
    """The displacement field of the single-material specimen of the JAX
    package's finite-difference test (Hill, hill[0] = 1.2, khard 300)
    under two half steps of uniaxial strain."""
    mt = tfek.rect_mesh(N, N, LX=1., LY=1., uniax='y', eps_tot=0.004,
                        **CPU64)
    m = convert.material_from_params(
        dict(hill=[1.2, 1., 1., 1., 1., 1.], sy=SY_T, khard=300.,
             drucker=0.), is_svc=False, **CPU64)
    sy = torch.exp(log_sy)
    m = dataclasses.replace(m, sy=sy, scale_seq=sy)
    u, _, _, _ = tfemu.simulate(mt, m, CVS[0], FRACS, **kw)
    return u.reshape(-1)


def test_forward_column_matches_central_differences():
    """d(u field)/d(log sy) from the implicit tangent solve: the Dual
    column and the ``forward_ad`` column through the autograd.Function
    agree, and match central differences of the port's own solve within
    1e-6."""
    kw = dict(maxiter=20)
    x0 = torch.tensor(np.log(SY_T), dtype=torch.float64)
    col = _field(dual.Dual(x0, torch.ones(1, dtype=torch.float64)),
                 **kw).t[0]
    eps = 1e-5
    fd = (_field(x0 + eps, **kw) - _field(x0 - eps, **kw)) / (2 * eps)
    scale = float(fd.abs().max())
    assert scale > 0.
    assert float((col - fd).abs().max()) < 1e-6 * scale
    from torch.autograd import forward_ad as fwAD
    with fwAD.dual_level():
        y = _field(fwAD.make_dual(x0, torch.ones_like(x0)), **kw)
        col_ad = fwAD.unpack_dual(y).tangent
    assert float((col_ad - col).abs().max()) < 1e-9 * scale


def test_fit_field_recovers_the_matrix():
    """Full-field model updating on the inclusion specimen: the matrix
    yield strength and Hill coefficient back from the displacement field
    alone."""
    _, mt = _meshes()
    # 10 fixed trips converge every lane of these increments (the return
    # map runs 4 substeps); 12 secant-Picard rounds leave the first yield
    # step short of convergence (a 1e-7 residual), so the implicit
    # Jacobian is not quite the iterate's and LM contracts linearly: five
    # steps from here reach a 1e-16 cost
    kw = dict(n_inner=12, maxiter=10)
    truth = {k: torch.tensor(v, dtype=torch.float64)
             for k, v in _truth().items()}
    build = _port_build(_converted())
    u_meas, _, _, _ = tfemu.simulate(mt, build(truth), CVS, FRACS, **kw)
    theta0 = {'log_sy': torch.tensor(np.log(135.), dtype=torch.float64),
              'log_h0': torch.tensor(np.log(1.1), dtype=torch.float64)}
    theta, info = tfemu.fit_field(mt, build, theta0, CVS, FRACS, u_meas,
                                  steps=5, **kw)
    assert info['loss'][-1] < 1e-14
    np.testing.assert_allclose(float(torch.exp(theta['log_sy'])), SY_T,
                               rtol=1e-6)
    np.testing.assert_allclose(float(torch.exp(theta['log_h0'])), H0_T,
                               rtol=1e-6)
