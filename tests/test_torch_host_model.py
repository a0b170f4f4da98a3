"""PyTorch port: the host profile's ``Model`` and analytic ``Material``
(``pylabfea_tpu_torch.femodel`` / ``materials``) against the unchanged JAX
host profile, in float64 on the CPU.

The reference's golden values of ``tests/test_model.py`` at that file's
tolerances, and JAX's ``Model`` on the same scripts within 1e-12 relative
(u, f, glob, sgl / egl / epgl and the element states); the 1-D bar of
``tests/test_bridge.py:180-218`` through the port's ``Model`` and bridge;
``bridge.read_model`` of the port's ``Model`` against that of JAX's, array
for array, and the card's faithful adaptive solve (here its plain
versions) against the port's ``Model.solve()`` at ``tests/test_bridge.py``'s
bounds.  Every model here solves in seconds, so the JAX side runs live."""
import numpy as np
import pytest
import torch

import pylabfea_tpu as JFE
import pylabfea_tpu_torch as TFE
from pylabfea_tpu import bridge as jbridge
from pylabfea_tpu_torch import bridge as tbridge

torch.set_num_threads(1)

F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _same_model(mt, mj, tol=1e-12):
    """Port and JAX ``Model`` fields within ``tol`` relative."""
    for k in ('u', 'f', 'sgl', 'egl', 'epgl'):
        assert np.shape(getattr(mt, k)) == np.shape(getattr(mj, k)), k
        assert _rel(getattr(mt, k), getattr(mj, k)) <= tol, k
    for k in mj.glob:
        if mj.glob[k] is not None:
            assert _rel(mt.glob[k], mj.glob[k]) <= tol, k
    for k in ('sig', 'eps', 'epl'):
        assert _rel([getattr(e, k) for e in mt.element],
                    [getattr(e, k) for e in mj.element]) <= tol, k


# the scripts of tests/test_model.py, written once for either package
def laminate(FE):
    fem = FE.Model(dim=2, planestress=True)
    fem.geom([2, 1, 2, 1, 2], LY=4.)
    mat1 = FE.Material()
    mat1.elasticity(E=100.e3, nu=0.35)
    mat2 = FE.Material()
    mat2.elasticity(E=300.e3, nu=0.3)
    fem.assign([mat1, mat2, mat1, mat2, mat1])
    fem.bcleft(0.)
    fem.bcbot(0.)
    fem.bcright(0., 'force')
    fem.bctop(0.1 * fem.leny, 'disp')
    fem.mesh(NX=16, NY=4)
    fem.solve()
    fem.calc_global()
    return fem, mat1, mat2


def plastic(FE):
    _, mat1, mat2 = laminate(FE)
    fem = FE.Model(dim=2, planestress=False)
    fem.geom([2, 2], LY=4.)
    mat2.plasticity(sy=150., khard=500., sdim=3)
    fem.assign([mat1, mat2])
    fem.bcleft(0.)
    fem.bcbot(0.)
    fem.bcright(0., 'force')
    fem.bctop(0.1 * fem.leny, 'disp')
    fem.mesh(NX=4, NY=4)
    fem.solve()
    fem.calc_global()
    return fem, mat2


def bcnode(FE, N=18):
    el = np.ones((N, N))
    el[N // 3:2 * N // 3, N // 3:2 * N // 3] = 2
    mat1 = FE.Material(num=1)
    mat1.elasticity(E=100.e3, nu=0.27)
    mat2 = FE.Material(num=2)
    mat2.elasticity(E=3.e3, nu=0.3)
    fe = FE.Model(dim=2, planestress=False)
    fe.geom(sect=2, LX=4., LY=4.)
    fe.assign([mat1, mat2])
    fe.bcbot(0.)
    fe.bcright(0., 'force')
    fe.bcleft(0., 'force')
    fe.bctop(0.01 * fe.leny, 'disp')
    fe.mesh(elmts=el, NX=N, NY=N)
    hh = [no in fe.nobot for no in fe.noleft]
    noc = np.nonzero(hh)[0]
    fe.bcnode(noc, 0., 'disp', 'x')
    fe.solve()
    return fe, noc


def user_mesh(FE, elmts=None):
    mat1 = FE.Material(num=1)
    mat1.elasticity(E=300.e3, nu=0.3)
    mat2 = FE.Material(num=2)
    mat2.elasticity(E=100.e3, nu=0.3)
    fe = FE.Model(dim=2, planestress=True)
    fe.geom([2, 2], LY=2.)
    fe.assign([mat1, mat2])
    fe.bcbot(0.)
    fe.bcleft(0.)
    fe.bcright(0., 'force')
    fe.bctop(0.004 * fe.leny, 'disp')
    if elmts is None:
        fe.mesh(NX=4, NY=2)
    else:
        fe.mesh(elmts=elmts)
    fe.solve()
    return fe


def props(FE, kind):
    mat = FE.Material()
    if kind == 'hill3':
        # the plastic model's second material, as test_model.py reuses it
        mat.elasticity(E=300.e3, nu=0.3)
        mat.plasticity(sy=150., khard=500., sdim=3)
        mat.plasticity(sy=150., hill=[0.7, 1., 1.4], khard=100., sdim=3)
        mat.calc_properties(eps=0.05)
    elif kind == 'workhard':
        mat.elasticity(E=300.e3, nu=0.3)
        mat.plasticity(sy=150., khard=2000.)
        mat.calc_properties(eps=0.1, sigeps=True)
    else:
        mat.elasticity(E=200.e3, nu=0.3)
        mat.plasticity(sy=100., hill=[0.7, 1., 1.4, 1., 1.2, 0.8],
                       khard=100., sdim=6)
        mat.calc_properties(eps=0.05, sigeps=True)
    return mat


def test_laminate_and_plastic_goldens_and_jax():
    fem_v, mat1, _ = laminate(TFE)
    fem2, _ = plastic(TFE)
    assert np.abs(mat1.C11 - 160493.8271604938) < 1e-5
    assert np.abs(mat1.C12 - 86419.75308641973) < 1e-5
    assert np.abs(mat1.C44 - 37037.03703703704) < 1e-5
    mod_stiff = fem_v.glob['sig'][1] / fem_v.glob['eps'][1]
    assert np.abs(6. / 8. * mat1.E + 2. / 8. * 300.e3 - mod_stiff) < 1e-5
    assert np.abs(fem2.glob['sig'][1] - fem2.glob['sbc2']) < 1e-5
    assert np.abs(fem2.glob['eps'][1] - fem2.glob['ebc2']) < 1e-5
    assert np.abs(fem2.glob['epl'][1] - 0.04966042764325635) < 1e-5
    _same_model(fem_v, laminate(JFE)[0])
    _same_model(fem2, plastic(JFE)[0])


@pytest.mark.parametrize('kind', ['hill3', 'workhard', 'hill6'])
def test_calc_properties_goldens_and_jax(kind):
    m = props(TFE, kind)
    p, s = m.propJ2, m.sigeps
    if kind == 'hill3':
        assert np.abs(p['stx']['ys'] - 146.38501094227996) < 1e-5
        assert np.abs(p['sty']['seq'][-1] - 168.5141123395444) < 1e-5
        assert np.abs(p['sty']['peeq'][-1] - 0.04969421741530513) < 1e-5
        assert np.abs(p['et2']['ys'] - 136.93063937629154) < 1e-5
        assert np.abs(p['ect']['peeq'][-1] - 0.04570405456408677) < 1e-5
        assert np.abs(p['ect']['seq'][-1] - 168.3199594723871) < 1e-5
    elif kind == 'workhard':
        assert np.abs(p['stx']['seq'][-1] - 347.68211920529546) < 1e-5
        assert np.abs(p['sty']['peeq'][-1] - 0.09883666666666659) < 1e-5
        assert np.abs(s['et2']['sig'][-1][0] - 307.1334214002634) < 1e-5
        assert np.abs(s['ect']['sig'][-1][0] + 192.15895530336059) < 1e-5
    else:
        assert np.abs(p['stx']['peeq'][-1] - 0.05039661) < 1e-5
        assert np.abs(p['sty']['seq'][-1] - 114.28035811) < 1e-5
        assert np.abs(s['et2']['sig'][-1][1] - 102.534840) < 1e-5
        assert np.abs(s['ect']['sig'][-1][0] + 54.6031702) < 1e-5
    j = props(JFE, kind)
    for sel in ('stx', 'sty', 'et2', 'ect'):
        for key in ('prop', 'propJ2'):
            for f in ('ys', 'seq', 'eeq', 'peeq'):
                assert _rel(getattr(m, key)[sel][f],
                            getattr(j, key)[sel][f]) <= 1e-12, (key, f)
        if kind != 'hill3':
            for f in ('sig', 'eps', 'epl'):
                assert _rel(m.sigeps[sel][f], j.sigeps[sel][f]) <= 1e-12


def test_bcnode_goldens_and_jax():
    fe, noc = bcnode(TFE)
    NY = 18
    assert np.abs(fe.u[684] + 9.730777232237817e-3) < 1e-5
    assert np.abs(fe.element[0].sig[5] - 2.2990816342732256) < 1e-5
    assert np.abs(fe.element[5 * NY + 7].sig[0] - 45.68020736256676) < 1e-5
    assert np.abs(fe.element[6 * NY + 7].sig[1] - 69.16252458086865) < 1e-5
    assert noc == [0]
    fj, _ = bcnode(JFE)
    _same_model(fe, fj)


def test_user_mesh_and_scalar_response_match_jax():
    ref = user_mesh(TFE)
    usr = user_mesh(TFE, elmts=np.array([[1, 1], [1, 1], [2, 2], [2, 2]]))
    np.testing.assert_allclose(usr.u, ref.u, atol=1e-10)
    for ea, eb in zip(usr.element, ref.element):
        np.testing.assert_allclose(ea.sig, eb.sig, atol=1e-8)
    _same_model(usr, user_mesh(JFE, elmts=np.array([[1, 1], [1, 1], [2, 2],
                                                     [2, 2]])))
    fe_d = TFE.Model(dim=2, planestress=True)
    fe_d.geom([2, 2], LY=2.)
    fe_d.assign([TFE.Material(), TFE.Material()])
    with pytest.raises(ValueError):
        fe_d.mesh(elmts=np.array([1, 1, 2, 2]))
    # scalar Material.response against response_batch lanes, and JAX's
    mats = []
    for FE in (TFE, JFE):
        mat = FE.Material()
        mat.elasticity(E=200.e3, nu=0.3)
        mat.plasticity(sy=100., hill=[0.7, 1., 1.4, 1., 1.2, 0.8],
                       khard=100., sdim=6)
        mats.append(mat)
    rng = np.random.default_rng(7)
    sig = rng.normal(0., 50., (12, 6))
    epl = rng.normal(0., 1e-3, (12, 6))
    deps = rng.normal(0., 2e-3, (12, 6))
    out = [m.response_batch(sig, epl, deps, m.CV) for m in mats]
    for a, b in zip(out[0][:4], out[1][:4]):
        assert _rel(a, b) <= 1e-12
    for i in range(12):
        fy, s, dp, g = mats[0].response(sig[i], epl[i], deps[i], mats[0].CV)
        assert np.abs(fy - out[0][0][i]) < 1e-12
        np.testing.assert_allclose(s, out[0][1][i], atol=1e-10)
        np.testing.assert_allclose(dp, out[0][2][i], atol=1e-12)
        np.testing.assert_allclose(g, out[0][3][i], atol=1e-8)


def _bar(FE, SF, plastic=False):
    mat1 = FE.Material(num=1)
    mat1.elasticity(E=100.e3, nu=0.35)
    mat2 = FE.Material(num=2)
    mat2.elasticity(E=300.e3, nu=0.3)
    fe = FE.Model(dim=1)
    if plastic:
        mp = FE.Material(num=3)
        mp.elasticity(E=200.e3, nu=0.3)
        mp.plasticity(sy=150., khard=500., sdim=6)
        fe.geom([2., 2.])
        fe.assign([mat1, mp])
    else:
        fe.geom([2., 1., 2.])
        fe.assign([mat1, mat2, mat1])
    fe.bcleft(0.)
    fe.bcright(0.01 * fe.lenx, 'disp')
    fe.mesh(NX=8 if plastic else 10, SF=SF)
    return fe


@pytest.mark.parametrize('SF', [1, 2])
def test_1d_bar_port_model_and_bridge(SF):
    """``tests/test_bridge.py:180-218`` on the port's ``Model``: the bar's
    host solve equals JAX's, and the port's bridge on the CPU (flat
    layout, Jacobi-CG) meets the host solve at that test's bounds."""
    fe_h = _bar(TFE, SF)
    fe_h.solve()
    fe_h.calc_global()
    fj = _bar(JFE, SF)
    fj.solve()
    fj.calc_global()
    _same_model(fe_h, fj)
    fe_d = _bar(TFE, SF)
    tbridge.solve_on_device(fe_d, nsteps=1, n_inner=1, dtype=F64,
                            cg_tol=1e-13, device='cpu')
    np.testing.assert_allclose(fe_d.u, fe_h.u, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(fe_d.glob['sig'], fe_h.glob['sig'], rtol=1e-9,
                               atol=1e-8)
    np.testing.assert_allclose([e.sig[0] for e in fe_d.element],
                               [e.sig[0] for e in fe_h.element], rtol=1e-9)
    if SF == 1:
        fe_h = _bar(TFE, 1, plastic=True)
        fe_h.solve()
        fe_h.calc_global()
        fe_d = _bar(TFE, 1, plastic=True)
        tbridge.solve_on_device(fe_d, nsteps=20, n_inner=4, dtype=F64,
                                cg_tol=1e-13, device='cpu')
        assert fe_h.glob['epl'][0] > 1e-4
        assert abs(fe_d.glob['sig'][0] - fe_h.glob['sig'][0]) \
            < 5e-3 * abs(fe_h.glob['sig'][0])


def _j2_model(FE, N=8, top=0.002):
    mat = FE.Material()
    mat.elasticity(E=200.e3, nu=0.3)
    mat.plasticity(sy=150., khard=1000., sdim=6)
    mat_el = FE.Material()
    mat_el.elasticity(E=600.e3, nu=0.3)
    fe = FE.Model(dim=2)
    fe.geom([2., 2.], LY=4.)
    fe.assign([mat, mat_el])
    fe.bcleft(0.)
    fe.bcbot(0.)
    fe.bcright(0., 'force')
    fe.bctop(top * fe.leny, 'disp')
    fe.mesh(NX=N, NY=N)
    return fe


def _same_record(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == 'materials':
            assert len(a[k]) == len(b[k])
            for ma, mb in zip(a[k], b[k]):
                _same_record(ma, mb)
        elif k == 'CVs':
            for ca, cb in zip(a[k], b[k]):
                np.testing.assert_array_equal(ca, cb)
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


def test_bridge_reads_and_solves_the_port_model():
    """``read_model`` of the port's ``Model`` (meshed, then solved: with
    its resume state) equals that of JAX's ``Model``, array for array; the
    faithful adaptive solve (f64, the plain versions on the CPU) meets the
    port's ``Model.solve()`` at ``tests/test_bridge.py:283-288``'s bounds,
    with the host's increments."""
    ft, fj = _j2_model(TFE), _j2_model(JFE)
    _same_record(tbridge.read_model(ft, device='cpu'),
                 tbridge.read_model(fj, device='cpu'))
    ft.solve()
    fj.solve()
    _same_model(ft, fj)
    _same_record(tbridge.read_model(ft, device='cpu'),
                 tbridge.read_model(fj, device='cpu'))
    dev = _j2_model(TFE)
    tbridge.solve_on_device_adaptive(dev, dtype=F64, fast=False,
                                     device='cpu')
    assert len(dev.sgl) == len(ft.sgl)
    np.testing.assert_allclose(dev.u, ft.u, atol=1e-7)
    np.testing.assert_allclose(dev.glob['sig'], ft.glob['sig'], rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(dev.sgl, ft.sgl, rtol=1e-5, atol=1e-3)
    assert np.abs(np.array([e.epl for e in dev.element])
                  - np.array([e.epl for e in ft.element])).max() < 1e-7
    # the JAX bridge reads the port's Model as it reads its own
    md_t = jbridge.to_device(_j2_model(TFE))[0]
    md_j = jbridge.to_device(_j2_model(JFE))[0]
    for f in ('B', 'fixed', 'fixed_val', 'force'):
        np.testing.assert_array_equal(np.asarray(getattr(md_t, f)),
                                      np.asarray(getattr(md_j, f)))
