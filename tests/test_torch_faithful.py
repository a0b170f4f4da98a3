"""PyTorch port: the reference-faithful return map and the gated,
refined, faithful-commit load step against the JAX reference.

The yield-locus distance ``ml_yf_dist``, ``response`` and
``response_chunked`` are held against JAX in float64 on 32-64 states, for
the trained SVC of REF_SOLVE_svc.npz and for Hill with linear hardening,
with the tolerances of ``tests/test_device.py`` (atol 1e-8 on fy and sig,
1e-12 on the plastic strain); so are the states on which the faithful map
itself returns NaN.  The refinement residual, ``refine_du`` and the
float64 commit are held against JAX on the same inputs to 1e-12 / 1e-10.
The REF_SOLVE load steps run on 8 x 8 meshes, each JAX mesh built fresh
with ``rect_mesh``.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import fe_kernels as jfek
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import fe_kernels as tfek

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'REF_SOLVE_svc.npz')
F64 = jnp.float64
HILL = dict(hill=[0.7, 1., 1.4, 1., 1.2, 0.8], sy=100., khard=100.,
            drucker=0.)


def _jax_material(mat, dtype=F64):
    """The JAX DeviceMaterial of a port material (leaves in ``dtype``)."""
    def a(v):
        return jnp.asarray(np.asarray(v), dtype)
    return jcon.DeviceMaterial(
        hill=a(mat.hill.numpy()), sy=a(mat.sy), khard=a(mat.khard),
        drucker=a(mat.drucker), sv=a(mat.sv.numpy()), dc=a(mat.dc.numpy()),
        rho=a(mat.rho), gamma=a(mat.gamma), scale_seq=a(mat.scale_seq),
        scale_wh=a(1.), feat_mean=jnp.zeros(0, dtype),
        feat_scale=jnp.zeros(0, dtype), tex=jnp.zeros(0, dtype),
        is_svc=mat.is_svc, dev_only=mat.dev_only)


def _elastic_cv(E=200.e3, nu=0.3):
    hh = E / ((1. + nu) * (1. - 2. * nu))
    CV = np.zeros((6, 6))
    CV[:3, :3] = nu * hh
    np.fill_diagonal(CV[:3, :3], (1. - nu) * hh)
    CV[3, 3] = CV[4, 4] = CV[5, 5] = (0.5 - nu) * hh
    return CV


def _case(kind):
    """(port material, JAX material, CV, sig, epl, deps): the trained SVC
    or Hill + linear hardening on 64 states (the inputs of
    ``tests/test_device.py``; 64, the element count of an 8 x 8 mesh,
    shares JAX's compiled ``response`` with the float64 commit test)."""
    if kind == 'svc':
        mat, CV, _ = convert.material_from_npz(NPZ, dtype=torch.float64,
                                               device='cpu')
        rng = np.random.default_rng(3)
        sig = rng.normal(0., 40., (64, 6))
        epl = np.zeros((64, 6))
        deps = rng.normal(0., 1.5e-3, (64, 6))
    else:
        mat = convert.material_from_params(HILL, is_svc=False,
                                           dtype=torch.float64, device='cpu')
        CV = _elastic_cv()
        rng = np.random.default_rng(7)
        sig = rng.normal(0., 50., (64, 6))
        epl = rng.normal(0., 1e-3, (64, 6))
        deps = rng.normal(0., 2e-3, (64, 6))
    return mat, _jax_material(mat), CV, sig, epl, deps


@pytest.fixture(scope='module', params=['svc', 'hill'])
def faithful(request):
    """A case and the JAX ``response`` on it."""
    mat, dm, CV, sig, epl, deps = _case(request.param)
    # maxit given as JAX's respond_grouped gives it (one compiled program)
    ref = jcon.response(dm, (jnp.asarray(sig), jnp.asarray(epl)),
                        jnp.asarray(deps), jnp.asarray(CV), 50)
    args = (mat, (torch.tensor(sig), torch.tensor(epl)), torch.tensor(deps),
            torch.tensor(CV))
    return args, [np.asarray(r) for r in ref]


def _assert_response(out, ref):
    fy, sig, depl, grad = (o.numpy() for o in out)
    np.testing.assert_allclose(fy, ref[0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(sig, ref[1], rtol=0, atol=1e-8)
    np.testing.assert_allclose(depl, ref[2], rtol=0, atol=1e-12)
    np.testing.assert_allclose(grad, ref[3], rtol=0,
                               atol=1e-9 * np.abs(ref[3]).max())
    assert (np.abs(ref[2]).sum(-1) > 0).sum() >= 8      # plastic lanes


def test_ml_yf_dist_matches_jax_f64():
    """The distance to the SVC locus at the states, their elastic trials
    and zero stress (the fallback lanes), with a hardening slope."""
    mat, dm, CV, sig, epl, deps = _case('svc')
    trial = np.concatenate([sig, sig + deps @ CV.T, np.zeros((4, 6))])
    peeq = np.linspace(0., 0.01, len(trial))
    ref = jcon.ml_yf_dist(dm, jnp.asarray(trial), jnp.asarray(peeq),
                          khard=300.)
    out = tcon.ml_yf_dist(mat, torch.tensor(trial), torch.tensor(peeq),
                          khard=300.)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-8)


def test_response_matches_jax_f64(faithful):
    args, ref = faithful
    _assert_response(tcon.response(*args), ref)


def test_response_chunked_matches_jax_f64(faithful):
    """A chunk smaller than the batch and a ragged last one."""
    args, ref = faithful
    n = args[1][0].shape[0]
    _assert_response(tcon.response_chunked(*args, chunk=n - 5), ref)


def _svc_materials(dtype):
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=dtype, device='cpu')
    return mat, _jax_material(mat, jnp.float64 if dtype == torch.float64
                              else jnp.float32), CV, eps


def _record_cg(monkeypatch, module, hist):
    """Wrap ``module.load_step_split`` to record each step's CG
    iteration history."""
    inner = module.load_step_split

    def step(*a, **kw):
        new, diag = inner(*a, **kw)
        hist.append([int(i) for i in diag['cg_iters_hist']])
        return new, diag

    monkeypatch.setattr(module, 'load_step_split', step)


def test_faithful_solve_matches_jax_f64(monkeypatch):
    """``solve_uniaxial(gate, commit_faithful)`` (the REF_SOLVE protocol)
    at 8 x 8 in four steps of eps_tot 0.002: states and glob_sig to 1e-8
    relative, identical CG histories."""
    mat, dm, CV, eps = _svc_materials(torch.float64)
    md = jfek.rect_mesh(8, 8, LX=2., LY=2., eps_tot=eps, dtype=F64)
    mt = tfek.rect_mesh(8, 8, LX=2., LY=2., eps_tot=eps, dtype=torch.float64,
                        device='cpu')
    cg_j, cg_t = [], []
    _record_cg(monkeypatch, jfek, cg_j)
    _record_cg(monkeypatch, tfek, cg_t)
    kw = dict(nsteps=4, n_inner=2, gate=True, nsub=4, commit_faithful=True)
    sj, hj = jfek.solve_uniaxial(md, dm, CV, dtype=F64, **kw)
    st, ht = tfek.solve_uniaxial(mt, mat, CV, dtype=torch.float64, **kw)
    assert cg_t == cg_j and len(cg_t) == 4
    for f in ('u', 'sig', 'epl', 'eps', 'elstiff'):
        a, b = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max(), f
    for a, b in zip(ht, hj):
        for x, y in zip(a, b):
            y = np.asarray(y)
            assert np.abs(x.numpy() - y).max() <= 1e-8 * np.abs(y).max()
    assert np.asarray(sj.epl).any()


def _meshes(dtype, N=8):
    """The REF_SOLVE geometry on an N x N mesh: (JAX mesh, port mesh)."""
    _, _, eps = convert.material_from_npz(NPZ, dtype=torch.float64,
                                          device='cpu')
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (jfek.rect_mesh(N, N, LX=2., LY=2., eps_tot=eps, dtype=jdt),
            tfek.rect_mesh(N, N, LX=2., LY=2., eps_tot=eps, dtype=dtype,
                           device='cpu'))


def _tangent_planes(NX, NY, dtype, seed):
    """A heterogeneous symmetric positive-definite tangent field (36, NX,
    NY): the elastic stiffness scaled per element by 0.5-1.5."""
    fac = np.random.default_rng(seed).uniform(0.5, 1.5, (1, NX, NY))
    return (_elastic_cv().reshape(36, 1, 1) * fac).astype(dtype)


def test_residual_f64_grid_matches_jax():
    """The float64 refinement residual on a float32 mesh, against the
    operator of the unrounded geometry: the same tangent field, float64
    increment and float32 force, to 1e-12 of max|r|."""
    md, mt = _meshes(torch.float32)
    rng = np.random.default_rng(11)
    els = _tangent_planes(8, 8, np.float32, 12)
    du = rng.normal(0., 1e-3, (2, 9, 9))
    force = rng.normal(0., 10., (2, 9, 9)).astype(np.float32)
    M64 = jfek._m64_of(md)
    np.testing.assert_allclose(mt.M64.numpy(), M64, rtol=0,
                               atol=1e-15 * np.abs(M64).max())
    ref = np.asarray(jfek._residual_f64_grid(md, M64, jnp.asarray(els),
                                             jnp.asarray(du),
                                             jnp.asarray(force)))
    out = tfek._residual_f64_grid(mt, mt.M64, torch.tensor(els),
                                  torch.tensor(du), torch.tensor(force))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_refine_du_matches_jax_f64():
    """One refinement pass (float64 mesh, random force) from an increment
    that holds the prescribed values and is random on the free dofs: the
    refined increment to 1e-12 of max|du| of JAX's, and far from the
    entering one."""
    md, mt = _meshes(torch.float64)
    els = _tangent_planes(8, 8, np.float64, 13)
    rng = np.random.default_rng(14)
    fixed = np.asarray(md.fixed)
    force = np.where(fixed, 0., rng.normal(0., 50., (2, 9, 9)))
    bc = np.asarray(md.fixed_val)
    du0 = np.where(fixed, bc, rng.normal(0., 1e-3, (2, 9, 9)))
    kes = jfek._hier_kes_jit(md, jnp.asarray(els))
    ref = np.asarray(jfek.refine_du(md, kes, jnp.asarray(els),
                                    jnp.asarray(du0), jnp.asarray(bc),
                                    jnp.asarray(force), 1e-11, 100, n=1))
    out = tfek.refine_du(mt, tfek._hier_kes(mt, torch.tensor(els)),
                         torch.tensor(els), torch.tensor(du0),
                         torch.tensor(bc), torch.tensor(force), 1e-11, 100,
                         n=1)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12 * scale)
    assert np.abs(ref - du0).max() > 1e-2 * scale


@pytest.fixture(scope='module')
def f32_step():
    """One plastic float32 step (0.6 of the load) with one refinement pass
    per solve and the float64 commit, in JAX and in the port."""
    mat, dm, CV, _ = _svc_materials(torch.float32)
    md, mt = _meshes(torch.float32)
    kw = dict(n_inner=2, n_refine=1, commit_f64=True)
    sj, dj = jfek.load_step_split(md, jfek.init_state(md, CV), dm, CV, 0.6,
                                  **kw)
    st, dt = tfek.load_step_split(mt, tfek.init_state(mt, CV), mat, CV, 0.6,
                                  **kw)
    return md, mt, mat, CV, (sj, dj), (st, dt)


def _jax_commit(md, mat, CV, sig, epl, du, fast):
    """JAX's float64 commit (``load_step_split``'s ``commit_f64`` block)
    of the entering (sig, epl) and increment ``du`` (numpy)."""
    f64 = jnp.float64
    out = jfek.respond_grouped(
        md, _jax_material(mat, f64), CV, jnp.asarray(sig, f64),
        jnp.asarray(epl, f64), jfek.element_deps(md, jnp.asarray(du, f64)),
        fast=fast, maxiter=12, nsub=4)
    return [np.asarray(o) for o in out[:3]]


def test_refined_f64_commit_step_matches_jax_f32(f32_step):
    """The committed stress is JAX's float64 commit of the port's own
    increment from the virgin state, rounded to float32 (2 ulp).  As a
    smoke check of the whole step: two float32 runs differ in summation
    order, so the CG may stop an iteration apart at its 1e-6 residual and
    each return map may land elsewhere in the +-yf_tolerance band (5e-3
    of the flow stress): the element stresses within that band, the global
    averages within 1e-3."""
    md, mt, mat, CV, (sj, dj), (st, dt) = f32_step
    assert st.sig.dtype == torch.float32 and np.asarray(sj.epl).any()
    zero = np.zeros((mt.nel, 6))
    _, sig64, depl64 = _jax_commit(md, mat, CV, zero, zero,
                                   dt['du'].numpy(), True)
    ulp = 2. * np.finfo(np.float32).eps
    for a, b in ((st.sig, sig64), (st.epl, depl64)):
        np.testing.assert_allclose(a.numpy(), b.astype(np.float32), rtol=0,
                                   atol=ulp * np.abs(b).max())
    sig = np.asarray(sj.sig)
    assert np.abs(st.sig.numpy() - sig).max() <= 5e-3 * np.abs(sig).max()
    for k in ('glob_sig', 'glob_eps', 'glob_epl'):
        ref = np.asarray(dj[k])
        assert np.abs(dt[k].numpy() - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize('fast', [True, False], ids=['fast', 'faithful'])
def test_f64_commit_matches_jax(f32_step, fast):
    """``commit_f64_response`` (the float64 copy of the material from
    ``material_to``) from the plastic float32 state of the step, with its
    increment once more, against JAX's commit on the same inputs: fy, sig
    and depl to 1e-10 of their scale."""
    md, mt, mat, CV, _, (st, dt) = f32_step
    out = tfek.commit_f64_response(mt, st, mat, CV, dt['du'], fast=fast)
    ref = _jax_commit(md, mat, CV, st.sig.numpy(), st.epl.numpy(),
                      dt['du'].numpy(), fast)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float64
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-10 * np.abs(r).max())
    assert np.abs(ref[2]).sum(-1).astype(bool).sum() >= 8  # plastic lanes


#: lanes of chip_smoke's faithful return-map states (``return_map_states(
#: 2**18)``, the 512-SV synthetic SVC) on which the float64 faithful map
#: returns NaN (the step split leaves the SVC's band, its gradient
#: underflows and a.C.a = 0 divides the tangent), then a plastic and two
#: elastic lanes that do not subdivide
NAN_LANES = (9661, 18803, 47466, 51788, 72534, 171006, 174306, 182323,
             184361, 118, 1, 2)


def test_faithful_nan_lanes_match_jax_f64():
    """On the NaN-producing states the port returns NaN on exactly the
    lanes and outputs where JAX does, and JAX's values elsewhere (the
    ``test_device.py`` tolerances)."""
    sig, deps = (a[list(NAN_LANES)]
                 for a in chip_smoke.return_map_states(2 ** 18))
    mat = convert.material_from_params(chip_smoke.synthetic_svc(),
                                       is_svc=True, dtype=torch.float64,
                                       device='cpu')
    CV = _elastic_cv()
    ref = [np.asarray(r) for r in jcon.response(
        _jax_material(mat), (jnp.asarray(sig), jnp.zeros((len(sig), 6))),
        jnp.asarray(deps), jnp.asarray(CV))]
    out = [o.numpy() for o in tcon.response(
        mat, (torch.tensor(sig), torch.zeros(len(sig), 6, dtype=torch.float64)),
        torch.tensor(deps), torch.tensor(CV))]
    for o, r, atol in zip(out, ref, (1e-8, 1e-8, 1e-12, None)):
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(o), fin)
        atol = 1e-9 * np.abs(r[fin]).max() if atol is None else atol
        np.testing.assert_allclose(o[fin], r[fin], rtol=0, atol=atol)
    bad = ~np.isfinite(ref[1]).all(-1)
    assert bad.sum() == 9 and np.isfinite(ref[1][~bad]).all()


def test_fast_map_stalls_outside_svc_band_like_jax():
    """Stresses far outside the trained SVC's band (from an element of a
    2-D step that left it): the decision function is its intercept there
    and its gradient vanishes, so the fast map cannot return them and
    ends at fy = rho, as JAX's does; in-band lanes converge.  Float64,
    the ``test_device.py`` tolerances."""
    mat, dm, CV, _ = _svc_materials(torch.float64)
    sig = np.array([[-427.83, 567.22, 43.91, 15.21, 17.15, -3.4],
                    [-150.28, 771.45, 310.29, 23.41, 13.97, -13.07],
                    [-321.09, 610.11, 192.27, 20.45, 5.59, -12.12],
                    [0., 200., 0., 0., 0., 0.],
                    [-80., 190., 40., 5., 0., 0.]])
    deps = np.tile([-2e-4, 5e-4, 0., 0., 0., 0.], (5, 1)) \
        + np.random.default_rng(0).normal(0., 2e-5, (5, 6))
    zero = np.zeros_like(sig)
    ref = [np.asarray(r) for r in jcon.response_fast(
        dm, (jnp.asarray(sig), jnp.asarray(zero)), jnp.asarray(deps),
        jnp.asarray(CV), 12, 4)]
    out = tcon.response_fast(mat, (torch.tensor(sig), torch.tensor(zero)),
                             torch.tensor(deps), torch.tensor(CV), 12, 4)
    _assert_fast(out, ref)
    np.testing.assert_allclose(ref[0][:3], mat.rho, rtol=1e-9)
    assert np.abs(ref[0][3:]).max() <= 5e-3
    g = tcon.svc_gradient(mat, tcon._features(mat, torch.tensor(sig[:3])))
    assert float(g.abs().max()) < 1e-12


def _assert_fast(out, ref):
    fy, sig, depl, grad = (o.numpy() for o in out)
    np.testing.assert_allclose(fy, ref[0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(sig, ref[1], rtol=0, atol=1e-8)
    np.testing.assert_allclose(depl, ref[2], rtol=0, atol=1e-12)
    np.testing.assert_allclose(grad, ref[3], rtol=0,
                               atol=1e-9 * np.abs(ref[3]).max())


def accuracy_history(N, dtype=torch.float32):
    """The 2-D main path's four-step history on an N x N mesh (three
    plain 0.25 steps, then one with ``gate``, ``n_refine=1`` and
    ``commit_f64``) in JAX and in the port.  Returns per framework the
    last step's round count, its committed max yield function, the
    elements above yf_tolerance and whether it warned."""
    import warnings
    from pylabfea_tpu_torch.config import yf_tolerance
    mat, dm, CV, eps = _svc_materials(dtype)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    out = {}
    for name, fek, m, md in (
            ('jax', jfek, dm, jfek.rect_mesh(N, N, uniax='y', eps_tot=eps,
                                             dtype=jdt)),
            ('port', tfek, mat, tfek.rect_mesh(N, N, uniax='y', eps_tot=eps,
                                               dtype=dtype, device='cpu'))):
        st, d = fek.init_state(md, CV, dtype=jdt if name == 'jax'
                               else dtype), None
        for k in range(4):
            kw = {} if d is None else dict(du0=d['du'], kes0=d['kes'],
                                           dst0=d['dstiff'])
            if k == 3:
                kw.update(gate=True, n_refine=1, commit_f64=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                st, d = fek.load_step_split(md, st, m, CV, 0.25, n_inner=2,
                                            **kw)
        fy = tcon.yf(mat, torch.tensor(np.asarray(st.sig)), None)
        out[name] = dict(rounds=len(d['cg_iters_hist']),
                         max_yf=float(fy.max()),
                         above=int((fy > yf_tolerance).sum()),
                         warned=any('no convergence' in str(w.message)
                                    for w in caught))
    return out


if __name__ == '__main__':
    # PYTHONPATH=. python tests/test_torch_faithful.py 64 128: the four-step
    # history of the 2-D main path in JAX and in the port on the CPU, per
    # mesh size
    import sys
    import jax
    jax.config.update('jax_platforms', 'cpu')
    for n in sys.argv[1:]:
        print(n, accuracy_history(int(n)), flush=True)
