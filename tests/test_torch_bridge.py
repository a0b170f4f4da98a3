"""PyTorch port: the host-model bridge (``pylabfea_tpu_torch.bridge``)
against the JAX bridge and the host (numpy) solver, in float64 on the CPU.

The conversions (``to_device``, ``to_device_1d``, the BC planes, the
materials) must give the JAX arrays; the solvers the JAX solver's fields
within 1e-9 (equal increment and iteration counts for the adaptive
driver) and the host solver's within ``tests/test_bridge.py``'s own
tolerances; the committed fixtures (``tools/make_torch_bridge_fixtures.py``)
their reference golden values (``ACCURACY.md``) within 1e-6.  A record
built from arrays (``grid_record``) must equal the record read from a
host ``Model``.  Every JAX mesh is built fresh."""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pylabfea_tpu as FE
from pylabfea_tpu import bridge as jbridge
from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import svc as jsvc
from pylabfea_tpu_torch import bridge as tbridge
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import jtensors as jt
from pylabfea_tpu_torch.ops import svc_kernels as sk

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'pylabfea_tpu_torch', 'data')
F64 = torch.float64
CPU = dict(device='cpu')


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _j2(sy=150., khard=1000., sdim=6):
    mat = FE.Material()
    mat.elasticity(E=200.e3, nu=0.3)
    mat.plasticity(sy=sy, khard=khard, sdim=sdim)
    return mat


def _model(N=8, top=0.002, planestress=False, mats=None):
    """``tests/test_bridge.py``'s ``_model`` geometry at N x N: J2 sy 150,
    khard 1000 on a 4 x 4 square, top pulled by ``top`` * LY, right edge
    force-free."""
    fe = FE.Model(dim=2, planestress=planestress)
    fe.geom([4.] if mats is None else [4. / len(mats)] * len(mats), LY=4.)
    fe.assign([_j2()] if mats is None else mats)
    fe.bcleft(0.)
    fe.bcbot(0.)
    fe.bcright(0., 'force')
    fe.bctop(top * fe.leny, 'disp')
    fe.mesh(NX=N, NY=N)
    return fe


def _bcnode_model(planestress=False):
    """The bcnode inclusion of ``tools/gen_accuracy_ledger.py`` at 6 x 6:
    two elastic materials, force edges, the corner pinned in x."""
    el = np.ones((6, 6))
    el[2:4, 2:4] = 2
    m1 = FE.Material(num=1)
    m1.elasticity(E=100.e3, nu=0.27)
    m2 = FE.Material(num=2)
    m2.elasticity(E=3.e3, nu=0.3)
    fe = FE.Model(dim=2, planestress=planestress)
    fe.geom(sect=2, LX=4., LY=4.)
    fe.assign([m1, m2])
    fe.bcbot(0.)
    fe.bcright(0., 'force')
    fe.bcleft(0., 'force')
    fe.bctop(0.01 * fe.leny, 'disp')
    fe.mesh(elmts=el, NX=6, NY=6)
    noc = np.nonzero([no in fe.nobot for no in fe.noleft])[0]
    fe.bcnode(noc, 0., 'disp', 'x')
    return fe


def _bar(SF=1, plastic=False):
    """``tests/test_bridge.py``'s 1-D composite bars."""
    m1 = FE.Material(num=1)
    m1.elasticity(E=100.e3, nu=0.35)
    m2 = FE.Material(num=2)
    m2.elasticity(E=300.e3, nu=0.3)
    fe = FE.Model(dim=1)
    if plastic:
        mp = FE.Material(num=3)
        mp.elasticity(E=200.e3, nu=0.3)
        mp.plasticity(sy=150., khard=500., sdim=6)
        fe.geom([2., 2.])
        fe.assign([m1, mp])
    else:
        fe.geom([2., 1., 2.])
        fe.assign([m1, m2, m1])
    fe.bcleft(0.)
    fe.bcright(0.01 * fe.lenx, 'disp')
    fe.mesh(NX=8 if plastic else 10, SF=SF)
    return fe


def _mesh_arrays(md):
    out = {k: np.asarray(getattr(md, k)) for k in
           ('B', 'Bsum', 'jacw', 'vel', 'fixed', 'fixed_val', 'force')}
    for k in ('perm', 'inv_perm', 'ps_b2', 'dofs'):
        v = getattr(md, k)
        out[k] = np.zeros(0) if v is None else np.asarray(v)
    return out


def _material_leaves(dm):
    """A DeviceMaterial's leaves as numpy (JAX or port) with its flags."""
    keys = ('hill', 'sy', 'khard', 'drucker', 'sv', 'dc', 'rho', 'gamma',
            'scale_seq', 'scale_wh', 'feat_mean', 'feat_scale', 'tex',
            'voce_r', 'voce_b')
    out = {k: np.asarray(getattr(dm, k), float) for k in keys}
    out.update({k: bool(getattr(dm, k)) for k in ('is_svc', 'dev_only',
                                                  'sdim3')})
    return out


def _tuple(m):
    """Materials as a tuple (a JAX DeviceMaterial is a NamedTuple)."""
    return m if isinstance(m, tuple) and not hasattr(m, '_fields') else (m,)


def _same_materials(tm, jm):
    tm, jm = _tuple(tm), _tuple(jm)
    assert len(tm) == len(jm)
    for a, b in zip(tm, jm):
        la, lb = _material_leaves(a), _material_leaves(b)
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


CONVERSIONS = {
    'single': lambda: _model(4),
    'plane_stress': lambda: _model(4, planestress=True),
    'two_materials': lambda: _model(4, mats=[_j2(), _j2(200., 0.)]),
    'bcnode_ps_multi': lambda: _bcnode_model(planestress=True),
    'bcnode': lambda: _bcnode_model(),
    'bar_sf1': lambda: _bar(1),
    'bar_sf2': lambda: _bar(2),
}


@pytest.mark.parametrize('name', sorted(CONVERSIONS))
def test_to_device_matches_jax(name):
    """Mesh planes and BC planes, perm / groups / ps_b2, the per-element
    bar tables and the material leaves equal the JAX conversion's."""
    fe = CONVERSIONS[name]()
    conv_t = tbridge.to_device_1d if fe.dim == 1 else tbridge.to_device
    conv_j = jbridge.to_device_1d if fe.dim == 1 else jbridge.to_device
    md, dm, CV = conv_t(fe, dtype=F64, **CPU)
    mj, dj, CVj = conv_j(fe, dtype=jnp.float64)
    ta, ja = _mesh_arrays(md), _mesh_arrays(mj)
    if md.grid is not None:
        # the JAX grid keeps its flat dofs, the port derives them
        ta['dofs'] = tbridge.fek.grid_dofs(*md.grid[:2])
    for k in ta:
        if k in ('perm', 'inv_perm', 'ps_b2') and ja[k].size == 0:
            # JAX holds empty arrays where the port holds None
            assert ta[k].size == 0, k
            continue
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert md.groups == mj.groups and md.ndof == mj.ndof
    assert (md.grid is None) == (mj.grid is None)
    if md.grid is not None:
        assert tuple(md.grid) == tuple(mj.grid)
    _same_materials(dm, dj)
    for a, b in zip(_tuple(CV), _tuple(CVj)):
        np.testing.assert_array_equal(a, b)


def test_bc_planes_match_jax():
    """The per-increment BC planes of the adaptive driver (incremental
    right/top/node-set values, static left/bottom) equal JAX's."""
    fe = _bcnode_model()
    fe.bcright(0.3, 'force', 'y')
    rec = tbridge.read_model(fe)
    for dbcr, dbct, dbcn in (((0.1, -0.2), (0.02, 0.004), (0., 0.)),
                             ((0., 0.), (0., 0.), (0.5, -0.5))):
        fj, ff = jbridge._bc_planes(fe, np.array(dbcr), np.array(dbct),
                                    np.array(dbcn), jnp.float64)
        _, fv, force = tbridge.fek.make_edge_bcs(
            6, 6, **tbridge._bc_spec(rec, dbcr, dbct, dbcn))
        np.testing.assert_array_equal(fv, np.asarray(fj))
        np.testing.assert_array_equal(force, np.asarray(ff))


def test_solve_on_device_matches_jax_and_host():
    """``solve_on_device`` (f64, 10 steps, 4 inner rounds) on the 8 x 8
    J2 model: the JAX bridge's fields within 1e-9, the host solver's axial
    stress within ``tests/test_bridge.py``'s 5e-3."""
    dev = _model(8)
    tbridge.solve_on_device(dev, nsteps=10, n_inner=4, dtype=F64, **CPU)
    ref = _model(8)
    jbridge.solve_on_device(ref, nsteps=10, n_inner=4, dtype=jnp.float64)
    for k in ('u', 'f', 'sgl', 'egl', 'epgl'):
        assert _rel(getattr(dev, k), getattr(ref, k)) < 1e-9, k
    assert _rel([e.sig for e in dev.element],
                [e.sig for e in ref.element]) < 1e-9
    host = _model(8)
    host.solve(min_step=10)
    assert abs(dev.glob['sig'][1] - host.glob['sig'][1]) \
        < 5e-3 * abs(host.glob['sig'][1])
    assert dev.sgl.shape == (11, 6)


def test_adaptive_resume_matches_jax_and_host():
    """``solve_on_device_adaptive`` with a resume (``tests/test_bridge.py``'s
    continued loading at 8 x 8, faithful return map): the JAX driver's
    increment counts, ``niter`` and BC memory exactly, its fields within
    1e-9; the host solver within ``tests/test_bridge.py``'s tolerances."""
    def run(solve):
        fe = _model(8, top=0.0012)
        solve(fe)
        n1 = (fe.nsteps, list(fe.niter), len(fe.sgl))
        fe.bctop(0.002 * fe.leny, 'disp')
        solve(fe)
        return fe, n1

    dev, n1 = run(lambda fe: tbridge.solve_on_device_adaptive(
        fe, dtype=F64, fast=False, **CPU))
    ref, n1j = run(lambda fe: jbridge.solve_on_device_adaptive(
        fe, dtype=jnp.float64, fast=False))
    assert n1 == n1j
    assert dev.nsteps == ref.nsteps and list(dev.niter) == list(ref.niter)
    assert list(dev.co_nconv) == list(ref.co_nconv)
    np.testing.assert_array_equal(dev.bct_mem, ref.bct_mem)
    for k in ('u', 'f', 'sgl', 'egl', 'epgl'):
        assert _rel(getattr(dev, k), getattr(ref, k)) < 1e-9, k
    for k in ('sig', 'epl'):
        assert _rel([getattr(e, k) for e in dev.element],
                    [getattr(e, k) for e in ref.element]) < 1e-9, k
    host = _model(8, top=0.0012)
    host.solve()
    host.bctop(0.002 * host.leny, 'disp')
    host.solve()
    assert len(dev.sgl) == len(host.sgl)
    sig_d = np.array([e.sig for e in dev.element])
    sig_h = np.array([e.sig for e in host.element])
    assert np.abs(sig_d - sig_h).max() < 1e-3
    assert np.abs(np.array([e.epl for e in dev.element])
                  - np.array([e.epl for e in host.element])).max() < 1e-7
    np.testing.assert_allclose(dev.u, host.u, atol=1e-7)
    np.testing.assert_allclose(dev.sgl, host.sgl, rtol=1e-5, atol=1e-3)


def test_adaptive_fast_matches_jax():
    """The adaptive driver with the fast return map (the 1024^2 run of the
    card's phase 15c, here at 8 x 8): JAX's counts and fields."""
    dev = _model(8)
    tbridge.solve_on_device_adaptive(dev, dtype=F64, fast=True, **CPU)
    ref = _model(8)
    jbridge.solve_on_device_adaptive(ref, dtype=jnp.float64, fast=True)
    assert dev.nsteps == ref.nsteps and list(dev.niter) == list(ref.niter)
    for k in ('u', 'sgl'):
        assert _rel(getattr(dev, k), getattr(ref, k)) < 1e-9, k


def test_plastic_bar_matches_jax_and_host():
    """The elastic-plastic 1-D bar on the flat layout (20 steps, per-element
    B): JAX's fields within 1e-9, the host solver's axial stress within
    5e-3."""
    dev = _bar(plastic=True)
    tbridge.solve_on_device(dev, nsteps=20, n_inner=4, dtype=F64,
                            cg_tol=1e-13, **CPU)
    ref = _bar(plastic=True)
    jbridge.solve_on_device(ref, nsteps=20, n_inner=4, dtype=jnp.float64,
                            cg_tol=1e-13)
    for k in ('u', 'f', 'sgl'):
        assert _rel(getattr(dev, k), getattr(ref, k)) < 1e-9, k
    host = _bar(plastic=True)
    host.solve()
    host.calc_global()
    assert host.glob['epl'][0] > 1e-4
    assert abs(dev.glob['sig'][0] - host.glob['sig'][0]) \
        < 5e-3 * abs(host.glob['sig'][0])


def test_calc_properties_matches_jax_and_host():
    """``calc_properties_on_device`` at Nel=8 (f64, eps 0.01, 20 steps):
    the host ``Material.calc_properties`` yield strengths on all four load
    paths (``tests/test_bridge.py``'s tolerances), and the JAX version's
    histories within 1e-9 on the shear path."""
    mat = _j2()
    tbridge.calc_properties_on_device(mat, Nel=8, eps=0.01, nsteps=20,
                                      dtype=F64, **CPU)
    host = _j2()
    host.calc_properties(eps=0.01)
    for sel in ('stx', 'sty', 'et2', 'ect'):
        assert abs(mat.propJ2[sel]['ys'] - host.propJ2[sel]['ys']) \
            < 1e-6 * host.propJ2[sel]['ys']
        assert abs(mat.prop[sel]['ys'] - host.prop[sel]['ys']) \
            < 2e-2 * host.prop[sel]['ys']
    assert mat.prop_calculated
    ref = _j2()
    jbridge.calc_properties_on_device(ref, Nel=8, eps=0.01, nsteps=20,
                                      dtype=jnp.float64, load_cases=('ect',))
    for k in ('sig', 'eps', 'epl'):
        assert _rel(mat.sigeps['ect'][k], ref.sigeps['ect'][k]) < 1e-9, k
    assert abs(mat.prop['ect']['ys'] - ref.prop['ect']['ys']) \
        < 1e-9 * ref.prop['ect']['ys']


def _fixture(name):
    return tbridge.load_record(os.path.join(DATA, f'bridge_{name}.npz'))


def _at(res, field, index, comp):
    v = res[str(field)]
    v = v if index < 0 else v[index]
    return v if comp < 0 else v[comp]


@pytest.mark.parametrize('name', ['bcnode', 'bar_sf1', 'bar_sf2', 'resume'])
def test_fixture_records_meet_goldens(name):
    """The committed records solved on the CPU: the reference's golden
    values within 1e-6 where the fixture has them, the host solver within
    ``tests/test_bridge.py``'s tolerances and the JAX device solver within
    1e-9 (fields) otherwise."""
    rec = _fixture(name)
    res = tbridge.run_record(rec, dtype=F64, **CPU)
    if 'gold.ref' in rec:
        for f, i, c, ref in zip(rec['gold.field'], rec['gold.index'],
                                rec['gold.comp'], rec['gold.ref']):
            assert abs(_at(res, f, i, c) - ref) <= 1e-6 * abs(ref), f
    for k in ('u', 'sig', 'sgl'):
        assert _rel(res[k], rec[f'jax.{k}']) < 1e-9, k
    if 'host.u' in rec:
        tol = dict(u=1e-7, sig=1e-3) if name == 'resume' else {}
        for k in ('u', 'sig'):
            assert np.abs(res[k] - rec[f'host.{k}']).max() \
                <= tol.get(k, 1e-9 * np.abs(rec[f'host.{k}']).max()), k


def test_record_from_arrays_equals_host_record():
    """A record built from arrays (``grid_record``,
    ``convert.material_record_from``), as the card's phase 15 builds its
    full-width models, equals the record ``read_model`` reads from the
    host ``Model`` of the same settings (8 x 8), and survives ``.npz``."""
    fe = _model(8)
    host = tbridge.read_model(fe)
    mrec = convert.material_record_from(200.e3, 0.3, sy=150., khard=1000.)
    arr = tbridge.grid_record(8, 8, [mrec], [fe.element[0].CV], LX=4.,
                              LY=4., bct=(0., 0.008), ubctop=(False, True))
    assert set(arr) == set(host)
    for k, v in host.items():
        if k == 'materials':
            assert set(v[0]) == set(arr[k][0])
            for n in v[0]:
                np.testing.assert_array_equal(arr[k][0][n], v[0][n],
                                              err_msg=n)
        elif k == 'CVs':
            np.testing.assert_array_equal(arr[k][0], v[0])
        else:
            np.testing.assert_array_equal(arr[k], v, err_msg=k)


def test_record_npz_round_trip_and_missing_fields(tmp_path):
    rec = tbridge.read_model(_bcnode_model())
    path = tmp_path / 'rec.npz'
    tbridge.save_record(path, rec, note=np.str_('x'))
    back = tbridge.load_record(path)
    assert back['note'] == 'x'
    for k in ('ids', 'noset', 'bcn', 'ubcn', 'bct'):
        np.testing.assert_array_equal(back[k], rec[k])
    for a, b in zip(back['materials'], rec['materials']):
        for n in b:
            np.testing.assert_array_equal(a[n], b[n])
    flat = dict(np.load(path))
    del flat['m1.sy']
    np.savez(tmp_path / 'bad.npz', **flat)
    with pytest.raises(KeyError, match='sy'):
        tbridge.load_record(tmp_path / 'bad.npz')


def _ml_host_material(rec):
    """A host ML ``Material`` serving the fixture's trained SVC (no
    training: the SVC parameters are set on it)."""
    m = FE.Material(name='ML')
    m.elasticity(E=float(rec['E']), nu=float(rec['nu']))
    m.plasticity(sy=float(rec['sy']), sdim=6)
    m.ML_yf, m.Ndof, m.dev_only = True, 6, bool(rec['dev_only'])
    m.scale_seq = float(rec['scale_seq'])
    m._svc = jsvc.SVCParams(rec['sv'], rec['dc'], float(rec['rho']),
                            float(rec['gamma']))
    return m


def test_fixed_direction_root_find_matches_host():
    """``HostLaw.ml_full_yf`` (kernel G's plain version along the fixed
    load direction, 2000 marching steps) against the host
    ``Material._ml_full_yf_rows(ld=...)`` on the trained ML-Hill-6D SVC of
    the shear fixture: distances within 1e-4 MPa (Brent's xtol 1e-5 on
    the ray's scale), the host ``calc_seq`` / ``_yf_rows`` /
    ``_sflow_rows`` within 1e-12."""
    mrec = _fixture('ml_shear')['materials'][0]
    host = _ml_host_material(mrec)
    law = tbridge.HostLaw.of(mrec, convert.material_from_record(
        mrec, dtype=F64, **CPU))
    rng = np.random.default_rng(3)
    sig = rng.normal(0., 30., (40, 6))
    epl = rng.normal(0., 1e-3, (40, 6))
    t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    assert _rel(law.seq(t(sig)), host.calc_seq(sig)) < 1e-12
    assert _rel(law.yf(t(sig), t(epl)), host._yf_rows(sig, epl)) < 1e-12
    assert _rel(law.sflow(t(epl)), host._sflow_rows(epl)) < 1e-12
    for ld in (np.array([0., 0., 0., 0., 0., 1.]),
               np.array([1., 0., 0., 0., 0., 0.])):
        d = law.ml_full_yf(t(sig), t(epl), ld,
                           root=sk.svc_yf_root_plain).numpy()
        dh = host._ml_full_yf_rows(sig, epl, ld=ld)
        assert np.abs(d - dh).max() < 1e-4


def _analytic_host(kind):
    mat = FE.Material()
    mat.elasticity(E=200.e3, nu=0.3)
    if kind == 'voce':
        mat.plasticity(sy=150., khard=200., voce_r=80., voce_b=300., sdim=6)
    elif kind == 'hill3_drucker':
        mat.plasticity(sy=150., khard=500., hill=[0.7, 1., 1.4],
                       drucker=0.1, sdim=3)
    elif kind == 'hill6':
        mat.plasticity(sy=150., hill=[1.2, 1., 0.8, 1.1, 0.9, 1.3], sdim=6)
    return mat


@pytest.mark.parametrize('kind', ['voce', 'hill3_drucker', 'hill6',
                                  'elastic'])
def test_host_law_matches_host_methods(kind):
    """``HostLaw.seq`` / ``sflow`` / ``yf`` of analytic records (J2 +
    Voce, 3-parameter Hill on principal stresses with a Drucker term,
    6-parameter Hill, elastic) against the host ``calc_seq`` (Voigt and
    principal rows), ``_sflow_rows`` and ``_yf_rows`` within 1e-12.  An
    anisotropic 3-parameter Hill law assigns the principal stresses to
    the axes by the device convention (``jtensors.sig_princ_vals``, the
    JAX device path's), where the host ``sig_princ`` follows LAPACK's
    eigenvalue order: its Voigt rows are held against the host formula on
    the device's principal stresses."""
    host = _analytic_host(kind)
    mrec = convert.material_record(host)
    law = tbridge.HostLaw.of(mrec, convert.material_from_record(
        mrec, dtype=F64, **CPU))
    rng = np.random.default_rng(5)
    sig = rng.normal(0., 100., (40, 6))
    epl = rng.normal(0., 1e-3, (40, 6))
    t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    ref = jt.sig_princ_vals(t(sig)).numpy() if kind == 'hill3_drucker' \
        else sig
    assert _rel(law.seq(t(sig)), host.calc_seq(ref)) < 1e-12
    assert _rel(law.seq(t(sig[:, 0:3])), host.calc_seq(sig[:, 0:3])) < 1e-12
    assert law.plastic == (kind != 'elastic')
    if law.plastic:
        assert _rel(law.sflow(t(epl)), host._sflow_rows(epl)) < 1e-12
        assert _rel(law.yf(t(sig), t(epl)), host._yf_rows(ref, epl)) < 1e-12


def test_device_material_from_matches_jax_and_caches():
    """``convert.device_material_from`` of host materials (J2 + Voce,
    Hill sdim=3, elastic, an ML SVC with and without compression) gives
    the JAX leaves; Tresca raises; the compression is cached on the host
    material by spec and by the identity of its SVC."""
    voce = FE.Material()
    voce.elasticity(E=200.e3, nu=0.3)
    voce.plasticity(sy=150., khard=200., voce_r=80., voce_b=300., sdim=6)
    hill3 = FE.Material()
    hill3.elasticity(E=200.e3, nu=0.3)
    hill3.plasticity(sy=150., hill=[0.7, 1., 1.4], sdim=3)
    elastic = FE.Material()
    elastic.elasticity(E=3.e3, nu=0.3)
    ml = _ml_host_material(_fixture('ml_shear')['materials'][0])
    for m in (voce, hill3, elastic, ml):
        _same_materials(convert.device_material_from(m, dtype=F64, **CPU),
                        jcon.device_material_from(m, dtype=jnp.float64))
    tres = FE.Material()
    tres.elasticity(E=200.e3, nu=0.3)
    tres.plasticity(sy=150., tresca=True)
    with pytest.raises(NotImplementedError, match='Tresca'):
        convert.device_material_from(tres, **CPU)
    dm = convert.device_material_from(ml, dtype=F64, compress=16, **CPU)
    assert dm.sv.shape[0] == 16 and 0. < ml.svc_compress_rel < 1.
    cached = ml._svc_reduced
    assert cached[0] == '16' and cached[3] is ml._svc
    convert.device_material_from(ml, dtype=F64, compress=16, **CPU)
    assert ml._svc_reduced is cached
    ml._svc = copy.copy(ml._svc)
    convert.device_material_from(ml, dtype=F64, compress=16, **CPU)
    assert ml._svc_reduced is not cached and ml._svc_reduced[3] is ml._svc
