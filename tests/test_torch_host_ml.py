"""PyTorch port: the host profile's ML yield function
(``pylabfea_tpu_torch.materials.Material`` with an SVC) against the
unchanged JAX host profile, in float64 on the CPU.

The SVC is ``tests/test_ml.py``'s ``test_ml_shear`` one, trained by JAX
with scikit-learn and committed in ``pylabfea_tpu_torch/data/
bridge_ml_shear.npz`` (no scikit-learn training here).  The yield
function, its gradient and Hessian, the fixed-direction distance, the
return map, the flow rule and the tangent equal JAX's within 1e-12; the
6 x 3 shear solve reaches ``test_ml_shear``'s goldens at that test's
tolerances and JAX's host solve (``data/ref_host.npz``,
``tools/make_torch_ref_fixtures.py host``) within 1e-12; the UMAT export
round-trips as ``tests/test_ml.py:101-117``.  The card's trainer through
``train_SVC(backend='jax', device='cpu')`` against JAX's
``train_SVC(backend='jax')`` at ``tests/test_torch_ml_train.py``'s bounds
(both trainers in float64, 480 points), and ``compress_svc`` against
JAX's at ``tests/test_torch_svc_reduce.py``'s."""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pylabfea_tpu as JFE
import pylabfea_tpu_torch as TFE
from pylabfea_tpu import ml_train as jml
from pylabfea_tpu.ops import svc as jsvc
from pylabfea_tpu_torch import ml_train as tml
from pylabfea_tpu_torch.ops import svc as tsvc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'pylabfea_tpu_torch', 'data')


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _ml_material(FE, SVCParams, npz='bridge_ml_shear.npz'):
    """``test_ml_shear``'s trained material, its SVC set on it (the
    attributes ``train_SVC`` leaves; ``tools/make_torch_ref_fixtures.py``
    ``ml_shear_material``)."""
    z = np.load(os.path.join(DATA, npz))
    m = FE.Material(name='Hill-ML')
    m.elasticity(E=float(z['m0.E']), nu=float(z['m0.nu']))
    m.plasticity(sy=float(z['m0.sy']), sdim=6)
    m.ML_yf, m.Ndof, m.dev_only = True, 6, bool(z['m0.dev_only'])
    m.scale_seq = float(z['m0.scale_seq'])
    m.gam_yf = float(z['m0.gamma'])
    m._svc = SVCParams(z['m0.sv'], z['m0.dc'], float(z['m0.rho']),
                       float(z['m0.gamma']))
    return m


def _shear_model(FE, mat):
    fem = FE.Model(dim=2, planestress=True)
    fem.geom([2], LY=2.)
    fem.assign([mat])
    fem.bcbot(0., bctype='disp', bcdir='y')
    fem.bcbot(0., bctype='disp', bcdir='x')
    fem.bcleft(0., bctype='force')
    fem.bcright(0., bctype='force')
    fem.bctop(0.006 * fem.leny, bctype='disp', bcdir='x')
    fem.bctop(0., bctype='disp', bcdir='y')
    fem.mesh(NX=6, NY=3)
    return fem


@pytest.fixture(scope='module')
def mats():
    return (_ml_material(TFE, tsvc.SVCParams),
            _ml_material(JFE, jsvc.SVCParams))


def test_ml_methods_match_jax(mats):
    mt, mj = mats
    rng = np.random.default_rng(4)
    sig = rng.normal(0., 60., (48, 6))
    epl = rng.normal(0., 1e-3, (48, 6))
    deps = rng.normal(0., 1e-3, (48, 6))
    for name, args in (('calc_yf', (sig,)), ('calc_fgrad', (sig,)),
                       ('calc_hessian', (sig,)), ('calc_seq', (sig,)),
                       ('_yf_rows', (sig, epl)),
                       ('C_tan', (sig[0], mt.CV)),
                       ('epl_dot', (sig[0], epl[0], mt.CV, deps[0]))):
        a = getattr(mt, name)(*args)
        b = getattr(mj, name)(*args)
        assert _rel(a, b) <= 1e-12, name
    for ld in (None, np.eye(6)[5]):
        assert _rel(mt._ml_full_yf_rows(sig[:16], epl[:16], ld=ld),
                    mj._ml_full_yf_rows(sig[:16], epl[:16], ld=ld)) <= 1e-12
    assert abs(mt.ML_full_yf(sig[0]) - mj.ML_full_yf(sig[0])) \
        <= 1e-12 * abs(mj.ML_full_yf(sig[0]))
    out_t = mt.response_batch(sig[:16] * 3., epl[:16], deps[:16], mt.CV)
    out_j = mj.response_batch(sig[:16] * 3., epl[:16], deps[:16], mj.CV)
    for a, b in zip(out_t[:4], out_j[:4]):
        assert _rel(a, b) <= 1e-12
    fy, s, dp, g = mt.response(sig[0] * 3., epl[0], deps[0], mt.CV)
    fyj, sj, dpj, gj = mj.response(sig[0] * 3., epl[0], deps[0], mj.CV)
    assert _rel(s, sj) <= 1e-12 and _rel(g, gj) <= 1e-12


def test_ml_shear_goldens_and_jax_host_solve(mats):
    """``test_ml_shear``'s 6 x 3 solve (``tests/test_ml.py:51-53``) on the
    port's host profile, and JAX's host solve of the same SVC."""
    fem = _shear_model(TFE, mats[0])
    fem.solve()
    fem.calc_global()
    assert np.abs(fem.glob['sig'][5] - 77.53778881971623) < 6e-4
    assert np.abs(fem.element[3].epl[5] - 0.003942707316047761) < 1e-7
    assert np.abs(fem.element[3].sig[1] - 43.9060552472426) < 5e-3
    z = np.load(os.path.join(DATA, 'ref_host.npz'))
    for k in ('u', 'f', 'sgl', 'egl', 'epgl'):
        assert getattr(fem, k).shape == z[f'ml_shear.{k}'].shape
        assert _rel(getattr(fem, k), z[f'ml_shear.{k}']) <= 1e-12, k
    for k in ('sig', 'eps', 'epl'):
        assert _rel(fem.glob[k], z[f'ml_shear.glob.{k}']) <= 1e-12, k
        assert _rel([getattr(e, k) for e in fem.element],
                    z[f'ml_shear.el.{k}']) <= 1e-12, k


def test_export_import_round_trip(mats, tmp_path):
    """``tests/test_ml.py:101-117``: the UMAT CSV (8 values a line) read
    back gives the decision function exactly, and JAX reads the port's
    files to the same values."""
    mt, mj = mats
    mt.export_MLparam('test', file='roundtrip', path=str(tmp_path))
    txt = (tmp_path / 'roundtrip-svm.csv').read_text().strip().splitlines()
    assert all(len(line.split(',')) == 8 for line in txt)
    sig = TFE.load_cases(0, 40) * 95.
    for FE in (TFE, JFE):
        back = FE.Material('imported')
        back.from_MLparam('roundtrip', path=str(tmp_path))
        np.testing.assert_array_equal(back.calc_yf(sig), mt.calc_yf(sig))
    np.testing.assert_array_equal(mt.calc_yf(sig), mj.calc_yf(sig))


def _hill_ref(FE):
    mat_h = FE.Material(name='Hill-reference')
    mat_h.elasticity(E=200.e3, nu=0.3)
    mat_h.plasticity(sy=50., rv=[1.2, 1., 0.8, 1., 1., 1.], sdim=6)
    return mat_h


def test_train_svc_backend_jax_matches_jax(monkeypatch):
    """``train_SVC(backend='jax', device='cpu')`` (the card's dual trainer,
    here on the CPU) against JAX's ``train_SVC(backend='jax')`` on the
    same training data (480 points), both trainers in float64 (their
    default float32 sums in different orders): duals within 1e-10 C, the
    same support vectors, decision values within 1e-8 of their scale; the
    material installed as JAX installs it."""
    monkeypatch.setattr(jml, 'train_svc_jax', functools.partial(
        jml.train_svc_jax, dtype=jnp.float64))
    monkeypatch.setattr(tml, 'train_svc_jax', functools.partial(
        tml.train_svc_jax, dtype=torch.float64))
    out = []
    for FE, kw in ((TFE, dict(device='cpu')), (JFE, {})):
        m = FE.Material(name='Hill-ML')
        sc, _ = m.train_SVC(C=4, gamma=1.5, mat_ref=_hill_ref(FE), Nlc=40,
                            Nseq=6, Fe=0.3, Ce=0.95, backend='jax', **kw)
        out.append((m, sc))
    (mt, st), (mj, sj) = out
    pt, pj = mt._svc, mj._svc
    assert st == sj and mt.svm_yf is None and mt.ML_yf
    assert (mt.C_yf, mt.gam_yf, mt.scale_seq) == (mj.C_yf, mj.gam_yf,
                                                  mj.scale_seq)
    np.testing.assert_array_equal(pt.support_vectors, pj.support_vectors)
    np.testing.assert_allclose(pt.dual_coef, pj.dual_coef, rtol=0,
                               atol=1e-10 * 4.)
    sig = TFE.load_cases(0, 200) * np.linspace(30., 70., 200)[:, None]
    fj = mj.calc_yf(sig)
    np.testing.assert_allclose(mt.calc_yf(sig), fj, rtol=0,
                               atol=1e-8 * np.abs(fj).max())


def test_train_svc_needs_sklearn_or_the_named_backend(monkeypatch):
    """``backend='sklearn'`` (the default) raises scikit-learn's
    ImportError at fit time where it is not installed (no quiet switch to
    the card's trainer); an unknown backend raises."""
    import builtins
    real = builtins.__import__

    def blocked(name, *a, **kw):
        if name.split('.')[0] == 'sklearn':
            raise ImportError(f'No module named {name!r}')
        return real(name, *a, **kw)

    ref = _hill_ref(TFE)
    m = TFE.Material(name='Hill-ML')
    m.elasticity(CV=ref.CV)
    m.plasticity(sy=ref.sy, sdim=6)
    x, y = m.create_sig_data(N=8, mat_ref=ref, Nseq=2)
    monkeypatch.setattr(builtins, '__import__', blocked)
    with pytest.raises(ImportError, match='sklearn'):
        m.setup_yf_SVM_6D(x, y, C=4, gamma=1.5)
    with pytest.raises(ValueError, match="'sklearn' or 'jax'"):
        m._fit_svc_backend(x, y, 'torch')


def test_compress_svc_matches_jax():
    """``Material.compress_svc(nsv=32)`` of the REF_SOLVE SVC (135 SVs):
    the same center count and relative RKHS error (1e-6) as JAX's, the
    compressed decision values within 1e-6 of their scale of JAX's, the
    RKHS bound on the probes, the sklearn object dropped."""
    z = np.load(os.path.join(ROOT, 'REF_SOLVE_svc.npz'))
    out = []
    for FE, P, kw in ((TFE, tsvc.SVCParams, dict(device='cpu')),
                      (JFE, jsvc.SVCParams, {})):
        m = FE.Material()
        m.elasticity(E=200.e3, nu=0.3)
        m.plasticity(sy=float(z['sy']), sdim=6)
        m.ML_yf, m.Ndof, m.scale_seq = True, 6, float(z['scale_seq'])
        m._svc = P(z['support_vectors'], z['dual_coef'],
                   float(z['intercept']), float(z['gamma']))
        full = m._svc
        out.append((m, full, m.compress_svc(nsv=32, **kw)))
    (mt, full, relt), (mj, _, relj) = out
    assert mt._svc.support_vectors.shape == mj._svc.support_vectors.shape \
        == (32, 6)
    assert abs(relt - relj) <= 1e-6 * relj and mt.svm_yf is None
    rng = np.random.default_rng(0)
    u = rng.normal(size=(1024, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    P = u * rng.uniform(0.3, 1.5, (1024, 1))
    f0 = tsvc.decision_function_np(full, P)
    ft = tsvc.decision_function_np(mt._svc, P)
    fj = jsvc.decision_function(mj._svc, P)
    assert np.abs(ft - fj).max() <= 1e-6 * np.abs(f0).max()
    a, X = full.dual_coef, full.support_vectors
    K = np.exp(-full.gamma * np.maximum(
        np.sum(X * X, 1)[:, None] + np.sum(X * X, 1)[None] - 2. * X @ X.T,
        0.))
    assert np.abs(ft - f0).max() <= relt * np.sqrt(a @ K @ a) * (1. + 1e-9)
