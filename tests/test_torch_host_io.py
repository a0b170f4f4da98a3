"""PyTorch port: the host profile's numeric vocabulary and its edges
against the unchanged JAX host profile, on the CPU.

``core/tensors``, ``ops.rootfind.brent_vec``, the numpy SVC functions
(``decision_*_np``, ``SVCParams.from_sklearn``) and ``training`` equal
JAX's (``assert_array_equal``; the numpy copies keep the arithmetic and
its order).  ``dataio``: the helpers and both database schemas read into
the same ``mat_data``; ``create_test_sig`` and the CPFEM database skip as
``tests/test_data.py`` does.  ``gui.build_composite_model`` solves as
JAX's; ``utils/checkpoint``'s ``save_model`` / ``load_model`` read each
other's files bit for bit; ``utils/native`` (the C++ UMAT kernel, built
into the port's ignored ``build/``) agrees with the port's ``Material``
and JAX's binding under ``tests/test_native.py``'s conditions."""
import json
import os
import random

import numpy as np
import pytest
import torch

import pylabfea_tpu as JFE
import pylabfea_tpu_torch as TFE
from pylabfea_tpu import dataio as jdata
from pylabfea_tpu import gui as jgui
from pylabfea_tpu import training as jtrain
from pylabfea_tpu.core import tensors as jT
from pylabfea_tpu.ops import rootfind as jroot
from pylabfea_tpu.ops import svc as jsvc
from pylabfea_tpu.utils import checkpoint as jckpt
from pylabfea_tpu_torch import dataio as tdata
from pylabfea_tpu_torch import gui as tgui
from pylabfea_tpu_torch import training as ttrain
from pylabfea_tpu_torch.core import tensors as tT
from pylabfea_tpu_torch.ops import rootfind as troot
from pylabfea_tpu_torch.ops import svc as tsvc
from pylabfea_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'pylabfea_tpu_torch', 'data')
#: the reference's CPFEM dataset, where ``tests/test_data.py`` finds it
CPFEM = __import__('test_data').DATA


def _eq(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tensors_equal_jax():
    rng = np.random.default_rng(3)
    sv = rng.normal(0., 100., (40, 6))
    sp = rng.normal(0., 100., (40, 3))
    for name in ('sig_eq_j2', 'sig_princ', 'sig_dev', 'eps_eq',
                 'sig_polar_ang', 'sig_princ2cyl', 'voigt_to_tensor',
                 'seq_J2', 'sprinc', 'sdev', 'polar_ang', 's_cyl'):
        for x in (sv, sv[0], sp):
            if name in ('voigt_to_tensor', 'sig_princ', 'sprinc') \
                    and x.shape[-1] == 3:
                continue
            _eq(getattr(tT, name)(x), getattr(jT, name)(x))
    cyl = jT.sig_princ2cyl(sv)
    _eq(tT.sig_cyl2princ(cyl), jT.sig_cyl2princ(cyl))
    _eq(tT.tensor_to_voigt(jT.voigt_to_tensor(sv)), sv)
    _, evec = jT.sig_princ(sv[0])
    _eq(tT.sig_cyl2voigt(cyl[0], evec), jT.sig_cyl2voigt(cyl[0], evec))
    ang = rng.uniform(0., np.pi, (10, 5))
    _eq(tT.sig_spherical_to_cartesian(ang, seq=2.),
        jT.sig_spherical_to_cartesian(ang, seq=2.))
    st, sj = tT.Stress(sv[0]), jT.Stress(sv[0])
    for attr in ('v', 'p', 'tens', 'h'):
        _eq(getattr(st, attr), getattr(sj, attr))
    _eq((st.seq(), st.theta(), st.lode_ang(float(st.seq()))),
        (sj.seq(), sj.theta(), sj.lode_ang(float(sj.seq()))))
    et, ej = tT.Strain(sv[0] * 1e-4), jT.Strain(sv[0] * 1e-4)
    _eq((et.v, et.p, et.eeq()), (ej.v, ej.p, ej.eeq()))
    assert tT.yf_tolerance == jT.yf_tolerance
    _eq((tT.a_vec, tT.b_vec), (jT.a_vec, jT.b_vec))
    assert {'Material', 'Model', 'Data', 'load_cases', 'bridge',
            'sig_eq_j2', 'Stress', 'train_svc_jax'} <= set(dir(TFE))


def test_brent_vec_and_numpy_svc_equal_jax():
    rng = np.random.default_rng(5)
    kk = rng.uniform(0.5, 3., 64)
    sh = rng.uniform(-0.9, 0.9, 64)
    xa, xb = -np.ones(64) * 2., np.ones(64) * 3.

    def f(x):
        return np.tanh(kk * x) - sh

    _eq(troot.brent_vec(f, xa, xb, xtol=1e-5),
        jroot.brent_vec(f, xa, xb, xtol=1e-5))
    _eq(troot.brent_vec(lambda x: x * x + 1., np.zeros(1), np.ones(1)),
        jroot.brent_vec(lambda x: x * x + 1., np.zeros(1), np.ones(1)))
    z = np.load(os.path.join(ROOT, 'REF_SOLVE_svc.npz'))
    args = (z['support_vectors'], z['dual_coef'], float(z['intercept']),
            float(z['gamma']))
    pt, pj = tsvc.SVCParams(*args), jsvc.SVCParams(*args)
    x = rng.normal(0., 0.7, (50, 6))
    _eq(tsvc.decision_function_np(pt, x), jsvc.decision_function(pj, x))
    _eq(tsvc.decision_gradient_np(pt, x), jsvc.decision_gradient(pj, x))
    _eq(tsvc.decision_hessian_np(pt, x), jsvc.decision_hessian(pj, x))

    class Fitted:       # the attributes of a fitted sklearn SVC
        support_vectors_ = args[0]
        dual_coef_ = args[1][None]
        intercept_ = np.array([args[2]])
        _gamma = args[3]

    assert tsvc.SVCParams.from_sklearn(Fitted()) \
        .__dict__.keys() == jsvc.SVCParams.from_sklearn(Fitted()) \
        .__dict__.keys()
    for k, v in tsvc.SVCParams.from_sklearn(Fitted()).__dict__.items():
        _eq(v, jsvc.SVCParams.from_sklearn(Fitted()).__dict__[k])


def test_training_equals_jax():
    _eq(ttrain.load_cases(20, 30), jtrain.load_cases(20, 30))
    _eq(TFE.load_cases(0, 12), JFE.load_cases(0, 12))
    _eq(ttrain.uniform_hypersphere(6, 17), jtrain.uniform_hypersphere(6, 17))
    x = np.linspace(0., 3., 7)
    _eq(ttrain.int_sin_m(x, 5), jtrain.int_sin_m(x, 5))
    pt, pj = ttrain.primes(), jtrain.primes()
    assert [next(pt) for _ in range(12)] == [next(pj) for _ in range(12)]


# --- dataio -------------------------------------------------------------
def _curves(FE, direction, sy=100., E=200.e3, nu=0.3, n=60, emax=0.01,
            khard=1500.):
    """Synthetic bilinear stress / strain paths along a Voigt direction
    (``tests/test_dataio_formats.py``'s construction)."""
    mat = FE.Material()
    mat.elasticity(E=E, nu=nu)
    SV = np.linalg.inv(mat.CV)
    d = np.asarray(direction) / FE.sig_eq_j2(np.asarray(direction))
    sig, eps, epl = [], [], []
    for e in np.linspace(0., emax, n):
        seq = E * e if E * e <= sy else sy + (E * e - sy) * khard / (E + khard)
        pe = 0. if E * e <= sy else (E * e - seq) / E
        s, ep = d * seq, d * pe * 1.5
        sig.append(s)
        epl.append(ep)
        eps.append(SV @ s + ep)
    return np.array(sig), np.array(eps), np.array(epl)


def _database(path, legacy):
    rng = np.random.default_rng(3)
    ds = rng.normal(size=(6, 6))
    ds[:, 3:] *= 0.3
    db = {}
    comps = ['11', '22', '33', '23', '13', '12']
    for i, d in enumerate(ds):
        sig, eps, epl = _curves(TFE, d)
        if legacy:
            block = {'Results': {
                **{f'S{c}': sig[:, k].tolist() for k, c in enumerate(comps)},
                **{f'E{c}': eps[:, k].tolist() for k, c in enumerate(comps)},
                **{f'Ep{c}': epl[:, k].tolist()
                   for k, c in enumerate(comps)}}}
        else:
            block = {
                'stress': {f's{c}': sig[:, k].tolist()
                           for k, c in enumerate(comps)},
                'total_strain': {f'e{c}': eps[:, k].tolist()
                                 for k, c in enumerate(comps)},
                'plastic_strain': {f'ep{c}': epl[:, k].tolist()
                                   for k, c in enumerate(comps)},
                'units': {'Stress': 'MPa'}}
        db[f'Us_A1B2C3D4E5F6_{i:05d}_Tx_Rnd'] = block
    with open(path, 'w') as fh:
        json.dump(db, fh)


@pytest.mark.parametrize('legacy', [True, False], ids=['legacy', 'schema'])
def test_data_readers_equal_jax(tmp_path, legacy):
    path = str(tmp_path / 'db.json')
    _database(path, legacy)
    out = []
    for data in (tdata, jdata):
        random.seed(7)
        db = data.Data(path, epl_crit=2.e-3, epl_start=1.e-3, epl_max=0.008,
                       depl=1.e-3)
        out.append(db.mat_data)
    mt, mj = out
    assert mt.keys() == mj.keys()
    for k in mj:
        if isinstance(mj[k], (np.ndarray, float, int, list)) \
                and np.asarray(mj[k]).dtype.kind in 'fiu':
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-12, atol=0,
                                       err_msg=k)
        elif not isinstance(mj[k], dict):
            assert mt[k] == mj[k], k
    assert mt['Nlc'] == 6


def test_dataio_helpers_equal_jax():
    e = np.linspace(0., 0.01, 200)
    s = np.where(e < 0.005, 200e3 * e, 1000. + 20e3 * (e - 0.005))
    assert tdata.find_transition_index(s) == jdata.find_transition_index(s)
    assert 40 <= TFE.find_transition_index(s) <= 120
    rng = np.random.default_rng(11)
    C = np.diag([200., 210., 205., 95., 97., 96.]) * 1e3
    C[0, 1] = C[1, 0] = 105.e3
    eps = rng.normal(0., 1e-3, (20, 6))
    sig = eps @ C.T
    fits = []
    for data in (tdata, jdata):
        random.seed(5)
        fits.append(data.get_elastic_coefficients(list(eps), list(sig)))
    _eq(fits[0], fits[1])
    np.testing.assert_allclose(fits[0], C, atol=1e-6)
    for f in (tdata.ln_strain, tdata.eng_strain):
        _eq(f(e), getattr(jdata, f.__name__)(e))


@pytest.mark.skipif(not os.path.exists(CPFEM),
                    reason='reference CPFEM dataset not available')
def test_create_test_sig_equals_jax():
    _eq(ttrain.create_test_sig(CPFEM), jtrain.create_test_sig(CPFEM))


# --- gui, checkpoints, native --------------------------------------------
def test_gui_composite_model_equals_jax():
    ft = tgui.build_composite_model(NX=9, strain=0.02, sides='force')
    fj = jgui.build_composite_model(NX=9, strain=0.02, sides='force')
    ft.solve()
    fj.solve()
    for k in ('u', 'f', 'sgl'):
        np.testing.assert_allclose(getattr(ft, k), getattr(fj, k),
                                   rtol=1e-12, atol=1e-12 * np.abs(
                                       getattr(fj, k)).max())
    assert max(np.sqrt(2. / 3. * e.epl[:3] @ e.epl[:3])
               for e in ft.element) > 1e-3
    assert abs(ft.glob['sig'][0]) < 1e-6 * abs(ft.glob['sig'][1])
    with pytest.raises(ValueError):
        tgui.build_composite_model(NX=6, sides='frce')


def _small_model(FE):
    mat = FE.Material()
    mat.elasticity(E=200.e3, nu=0.3)
    mat.plasticity(sy=150., khard=500., sdim=6)
    fe = FE.Model(dim=2, planestress=False)
    fe.geom([2.], LY=2.)
    fe.assign([mat])
    fe.bcleft(0.)
    fe.bcbot(0.)
    fe.bcright(0., 'force')
    fe.bctop(0.002 * fe.leny, 'disp')
    fe.mesh(NX=2, NY=2)
    return fe


def test_model_checkpoints_cross_packages(tmp_path):
    """``save_model`` of either package loads in the other bit for bit,
    and a restored port ``Model`` resumes loading as an uninterrupted
    one."""
    src = {'port': _small_model(TFE), 'jax': _small_model(JFE)}
    for fe in src.values():
        fe.solve()
    tckpt.save_model(tmp_path / 'port.npz', src['port'], meta={'at': 1})
    jckpt.save_model(tmp_path / 'jax.npz', src['jax'], meta={'at': 2})
    for name, load, FE in (('jax', tckpt.load_model, TFE),
                           ('port', jckpt.load_model, JFE)):
        back = _small_model(FE)
        assert load(tmp_path / f'{name}.npz', back) \
            == {'at': 1 if name == 'port' else 2}
        for k in ('u', 'f', 'sgl', 'egl', 'epgl', 'bct_mem', 'bcr_mem'):
            _eq(getattr(back, k), getattr(src[name], k))
        for a, b in zip(back.element, src[name].element):
            for k in ('sig', 'eps', 'epl', 'elstiff'):
                _eq(getattr(a, k), getattr(b, k))
    ref = _small_model(TFE)
    ref.solve()
    ref.bctop(0.004 * ref.leny, 'disp')
    ref.solve()
    back = _small_model(TFE)
    tckpt.load_model(tmp_path / 'port.npz', back)
    back.bctop(0.004 * back.leny, 'disp')
    back.solve()
    np.testing.assert_allclose(back.u, ref.u, atol=1e-10)


def test_native_umat_matches_port_and_jax(tmp_path):
    """The C++ kernel through the port's binding (built into the port's
    ``build/``) on parameters exported by the port's ``Material`` (the
    shear fixture's SVC): the decision function and gradient against the
    port's host material (``tests/test_native.py``'s tolerances) and
    JAX's binding bit for bit."""
    from pylabfea_tpu.utils import native as jnative
    from pylabfea_tpu_torch.utils import native as tnative
    z = np.load(os.path.join(DATA, 'bridge_ml_shear.npz'))
    mat = TFE.Material(name='Hill-ML')
    mat.elasticity(E=float(z['m0.E']), nu=float(z['m0.nu']))
    mat.plasticity(sy=float(z['m0.sy']), sdim=6)
    mat.ML_yf, mat.Ndof, mat.dev_only = True, 6, False
    mat.scale_seq, mat.gam_yf = float(z['m0.scale_seq']), float(z['m0.gamma'])
    mat._svc = tsvc.SVCParams(z['m0.sv'], z['m0.dc'], float(z['m0.rho']),
                              float(z['m0.gamma']))
    mat.export_MLparam('test', file='native', path=str(tmp_path))
    csv = str(tmp_path / 'native-svm.csv')
    nt, nj = tnative.NativeMLMaterial(csv), jnative.NativeMLMaterial(csv)
    assert os.path.dirname(tnative._LIB) == os.path.join(
        ROOT, 'pylabfea_tpu_torch', 'build')
    rng = np.random.default_rng(2)
    sig = rng.normal(0., 60., (10, 6))
    g_py = mat.calc_fgrad(sig)
    for i in range(10):
        assert abs(nt.fsvc(sig[i]) - mat.calc_yf(sig[i])) < 1e-10
        np.testing.assert_allclose(nt.grad_fsvc(sig[i]), g_py[i], atol=1e-12)
        assert nt.fsvc(sig[i]) == nj.fsvc(sig[i])
    dstran = np.array([1e-4, -0.3e-4, -0.3e-4, 0., 0., 0.])
    _eq(nt.step(np.zeros(6), np.zeros(14), dstran),
        nj.step(np.zeros(6), np.zeros(14), dstran))
