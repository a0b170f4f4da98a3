"""Write the JAX reference results that the port's CPU tests read instead
of running the JAX package again:

    JAX_PLATFORMS=cpu python tools/make_torch_ref_fixtures.py [group ...]

Each group runs the unchanged JAX package on the inputs of its test file
(float64 unless the test's case is float32) and writes
``pylabfea_tpu_torch/data/ref_<group>.npz`` (about a minute each, most of
it compiling).  The tests keep a live JAX comparison in every file; these
are the further, heavier ones.  Where a test draws its inputs from a
seed, the fixture keeps them and the test checks that its own are the
same.  Groups:

* ``fe3d``: ``tests/test_torch_fe3d.py``'s 16^3 hierarchy and elastic
  MG-CG solve, the 8^3 cold 0.4 and warm 0.3 load steps and the 2^3
  ``solve_uniaxial3`` history;
* ``multimat``: ``tests/test_torch_multimat.py``'s grouped return maps,
  inclusion steps and gated solve, the SVC + elastic groups, the 4^3 box
  inclusion and the 4^3 faithful 3-D route;
* ``layouts``: ``tests/test_torch_svc_layouts.py``'s return maps and
  uniaxial solves;
* ``calibrate``: ``tests/test_torch_calibrate.py``'s Jacobians and
  gradients of ``simulate_paths`` and its fits;
* ``jax_args``: ``tests/test_torch_jax_args.py``'s gated float32 steps
  and its solves under both multigrid smoothers;
* ``element``: ``tests/test_torch_element_sharded.py``'s single-device
  references: the flat 2-D SVC and inclusion steps, the 8^3 J2 step and
  the unsharded fit of 16 paths;
* ``host``: ``tests/test_torch_host_ml.py``'s host solve, the JAX host
  profile's ``Model.solve()`` of ``tests/test_ml.py``'s shear model (6 x
  3) with the scikit-learn SVC of ``data/bridge_ml_shear.npz`` (its
  fields, the element states and the global history).
"""
import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update('jax_enable_x64', True)

import pylabfea_tpu as FE  # noqa: E402
from pylabfea_tpu.ops import constitutive as jcon  # noqa: E402
from pylabfea_tpu.ops import fe3d as jfe3d  # noqa: E402

DATA = os.path.join(ROOT, 'pylabfea_tpu_torch', 'data')
F64 = jnp.float64
STATE = ('u', 'sig', 'epl', 'eps', 'elstiff')


def _save(name, out):
    path = os.path.join(DATA, f'ref_{name}.npz')
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in out.items()})
    print(f'{path}: {len(out)} arrays, {os.path.getsize(path)} bytes')


def _state(out, tag, st):
    for f in STATE:
        out[f'{tag}.{f}'] = np.asarray(getattr(st, f))


# -----------------------------------------------------------------
# fe3d
# -----------------------------------------------------------------
E, NU, SY, KH = 200.e3, 0.3, 150., 500.


def j2_3d():
    """J2 + linear hardening (the bench.py 3-D material)."""
    m = FE.Material()
    m.elasticity(E=E, nu=NU)
    m.plasticity(sy=SY, khard=KH, sdim=6)
    return jcon.device_material_from(m, dtype=F64), np.asarray(m.CV)


def tangents(CV, N, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(CV).reshape(36, 1, 1, 1) \
        * rng.uniform(0.5, 1.5, (1, N, N, N))


def box(N):
    return jfe3d.box_mesh(N, N, N, uniax='z', eps_tot=0.002, dtype=F64)


def fe3d():
    out = {}
    dm, CV = j2_3d()
    # the 16^3 hierarchy on random tangents
    els = tangents(CV, 16)
    out['hier.els'] = els
    lv = jfe3d.build_hierarchy3(box(16), jnp.asarray(els))
    out['hier.nlev'] = len(lv)
    for i, level in enumerate(lv):
        out[f'hier.{i}.diag'] = np.stack([np.asarray(d) for d in level.diag])
        out[f'hier.{i}.lmax'] = np.asarray(level.lmax)
    out['hier.kc_inv'] = np.asarray(lv[-1].kc_inv)
    # the elastic MG-CG solve at 16^3
    md = box(16)
    Cp = jnp.asarray(np.broadcast_to(np.asarray(CV).reshape(36, 1, 1, 1),
                                     (36, 16, 16, 16)))
    fixT, bcT = jfe3d._split3(md.fixed), jfe3d._split3(md.fixed_val)
    du_bc = tuple(jnp.where(f, b, 0.) for f, b in zip(fixT, bcT))
    neg = jfe3d._k_apply3_raw(md, Cp, du_bc)
    rhs = tuple(jnp.where(f, b, -q) for f, b, q in zip(fixT, bcT, neg))
    x, r, it = jfe3d.mg_cg_solve3(jfe3d.build_hierarchy3(md, Cp), rhs, du_bc,
                                  tol=1e-10)
    out['mgcg.x'] = np.stack([np.asarray(c) for c in x])
    out['mgcg.res'], out['mgcg.iters'] = float(r), int(it)
    # a cold 0.4 and a warm 0.3 load step at 8^3
    md = box(8)
    st = jfe3d.init_state3(md, CV, dtype=F64)
    d = None
    for k, frac in enumerate((0.4, 0.3)):
        st, d = jfe3d.load_step3(md, st, dm, CV, frac, n_inner=2,
                                 du0=None if d is None else d['du'])
        _state(out, f'step{k}', st)
        out[f'step{k}.du'] = np.asarray(d['du'])
        out[f'step{k}.glob_sig'] = np.asarray(d['glob_sig'])
        out[f'step{k}.hist'] = np.asarray(d['cg_iters_hist'], int)
    # solve_uniaxial3 on the 2^3 box, 8 steps
    st, hist = jfe3d.solve_uniaxial3(box(2), dm, CV, nsteps=8, n_inner=2)
    _state(out, 'uni', st)
    out['uni.glob_sig'] = np.stack([np.asarray(h[0]) for h in hist])
    out['uni.glob_eps'] = np.stack([np.asarray(h[1]) for h in hist])
    out['uni.iters'] = np.asarray([int(h[2]) for h in hist])
    _save('fe3d', out)


# -----------------------------------------------------------------
# multimat
# -----------------------------------------------------------------
#: the bench.py inclusion's BCs at LX = LY = 4 (tests/test_torch_multimat)
INCL_BC = {'bot': {1: ('disp', 0.)}, 'left': {}, 'right': {},
           'top': {1: ('disp', 0.002 * 4.)}, 'nodes': ((0, 0, 0, 'disp', 0.),)}


def inclusion_materials():
    """bench.py's three materials: Hill [0.7, 1, 1.4, 1, 1, 1] sdim=6, J2
    sdim=3, elastic E = 1e3: (JAX materials, CVs)."""
    mat_h = FE.Material(num=1)
    mat_h.elasticity(E=200.e3, nu=0.3)
    mat_h.plasticity(sy=150., hill=[0.7, 1., 1.4, 1., 1., 1.], sdim=6)
    mat_j = FE.Material(num=2)
    mat_j.elasticity(E=200.e3, nu=0.3)
    mat_j.plasticity(sy=150., sdim=3)
    mat_el = FE.Material(num=3)
    mat_el.elasticity(E=1.e3, nu=0.27)
    mats = (mat_h, mat_j, mat_el)
    return (tuple(jcon.device_material_from(m, dtype=F64) for m in mats),
            tuple(np.asarray(m.CV, float) for m in mats))


def inclusion_map(N):
    mat_map = np.zeros((N, N), dtype=int)
    mat_map[N // 2:, :] = 1
    mat_map[N // 3: 2 * N // 3, N // 3: 2 * N // 3] = 2
    return mat_map


def inclusion_mesh(N):
    from pylabfea_tpu.ops import fe_kernels as jfek
    return jfek.rect_mesh(N, N, LX=4., LY=4., bc=INCL_BC,
                          mat_map=inclusion_map(N), dtype=F64)


def svc_material():
    """The trained SVC of REF_SOLVE_svc.npz as a JAX DeviceMaterial, its
    CV and strain (the construction of tests/test_torch_multimat.py)."""
    import torch
    from pylabfea_tpu_torch import convert
    mat, CV, eps = convert.material_from_npz(
        os.path.join(ROOT, 'REF_SOLVE_svc.npz'), dtype=torch.float64,
        device='cpu')
    dm = jcon.DeviceMaterial(
        hill=jnp.ones(6, F64), sy=jnp.asarray(mat.sy, F64),
        khard=jnp.asarray(0., F64), drucker=jnp.asarray(0., F64),
        sv=jnp.asarray(mat.sv.numpy()), dc=jnp.asarray(mat.dc.numpy()),
        rho=jnp.asarray(mat.rho, F64), gamma=jnp.asarray(mat.gamma, F64),
        scale_seq=jnp.asarray(mat.scale_seq, F64),
        scale_wh=jnp.asarray(1., F64), feat_mean=jnp.zeros(0, F64),
        feat_scale=jnp.zeros(0, F64), tex=jnp.zeros(0, F64), is_svc=True,
        dev_only=mat.dev_only)
    return dm, CV, eps


def _steps2d(out, tag, md, dms, CVs, fracs, n_inner=2):
    """Warm-started ``load_step_split`` steps (du0/kes0/dst0): each
    state, glob_sig and CG history."""
    from pylabfea_tpu.ops import fe_kernels as jfek
    st = jfek.init_state(md, CVs, dtype=F64)
    d = None
    for k, frac in enumerate(fracs):
        warm = {} if d is None else dict(du0=d['du'], kes0=d['kes'],
                                         dst0=d['dstiff'])
        st, d = jfek.load_step_split(md, st, dms, CVs, frac,
                                     n_inner=n_inner, **warm)
        _state(out, f'{tag}{k}', st)
        out[f'{tag}{k}.glob_sig'] = np.asarray(d['glob_sig'])
        out[f'{tag}{k}.hist'] = np.asarray(d['cg_iters_hist'], int)


def multimat():
    from pylabfea_tpu.ops import fe_kernels as jfek
    out = {}
    dms, CVs = inclusion_materials()
    # the grouped return map on random plastic increments (16^2)
    N = 16
    rng = np.random.default_rng(4)
    u = rng.normal(size=(N * N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * 150. * rng.uniform(0.5, 0.95, (N * N, 1))
    deps = rng.normal(0., 3e-4, (N * N, 6))
    out['rg.sig'], out['rg.deps'] = sig, deps
    for fast in (True, False):
        res = jfek.respond_grouped(
            inclusion_mesh(N), dms, CVs, jnp.asarray(sig),
            jnp.asarray(np.zeros((N * N, 6))), jnp.asarray(deps), fast=fast,
            nsub=2)
        for i, r in enumerate(res):
            out[f'rg.{fast}.{i}'] = np.asarray(r)
    # the inclusion: four warm-started steps, and the gated solve
    _steps2d(out, 'incl', inclusion_mesh(16), dms, CVs, (0.25,) * 4)
    st, hist = jfek.solve_uniaxial(inclusion_mesh(16), dms, CVs, nsteps=4,
                                   n_inner=1, dtype=F64, gate=True)
    _state(out, 'gated', st)
    out['gated.hist'] = np.stack([np.stack([np.asarray(x) for x in h])
                                  for h in hist])
    # the SVC + elastic groups
    dm, CV, eps = svc_material()
    m_el = FE.Material(num=2)
    m_el.elasticity(E=1.e3, nu=0.27)
    mat_map = np.zeros((N, N), dtype=int)
    mat_map[N // 2 + 1:N - 2, 3:N - 4] = 1
    md = jfek.rect_mesh(N, N, LX=1., LY=1., uniax='y', eps_tot=eps,
                        mat_map=mat_map, dtype=F64)
    _steps2d(out, 'svcel', md, (dm, jcon.device_material_from(
        m_el, dtype=F64)), (CV, np.asarray(m_el.CV, float)), (1. / 3.,) * 3)
    # the 3-D box inclusion, 4^3, four steps of solve_uniaxial3
    mat = FE.Material()
    mat.elasticity(E=200.e3, nu=0.3)
    mat.plasticity(sy=150., khard=500., sdim=6)
    incl = FE.Material(num=2)
    incl.elasticity(E=600.e3, nu=0.3)
    mm = np.zeros((4, 4, 4), np.int32)
    mm[1:2, 1:2, 1:2] = 1
    md3 = jfe3d.box_mesh(4, 4, 4, uniax='z', eps_tot=0.002, mat_map=mm,
                         dtype=F64)
    st, hist = jfe3d.solve_uniaxial3(
        md3, tuple(jcon.device_material_from(m, dtype=F64)
                   for m in (mat, incl)),
        (np.asarray(mat.CV), np.asarray(incl.CV)), nsteps=4, n_inner=2)
    _state(out, 'box', st)
    out['box.glob_sig'] = np.stack([np.asarray(h[0]) for h in hist])
    out['box.iters'] = np.asarray([int(h[2]) for h in hist])
    # the faithful 3-D route with the SVC at 4^3: three steps
    md3 = jfe3d.box_mesh(4, 4, 4, uniax='z', eps_tot=eps, dtype=F64)
    st = jfe3d.init_state3(md3, CV, dtype=F64)
    d = None
    for k, frac in enumerate((0.5, 0.25, 0.25)):
        st, d = jfe3d.load_step3(md3, st, dm, CV, frac, n_inner=2,
                                 fast=False,
                                 du0=None if d is None else d['du'])
        _state(out, f'faith{k}', st)
        out[f'faith{k}.hist'] = np.asarray(d['cg_iters_hist'], int)
    _save('multimat', out)


# -----------------------------------------------------------------
# layouts (tests/test_torch_svc_layouts.py)
# -----------------------------------------------------------------
FLAGS = ('is_svc', 'dev_only', 'sdim3')
#: its uniaxial solves: (fixture, N, solve_uniaxial keywords)
LAYOUT_SOLVES = {
    'wh-steps': ('svc_wh', 16, dict(nsteps=3, n_inner=2)),
    'cyl-steps': ('svc_cyl', 16, dict(nsteps=3, n_inner=2)),
    'cyl-faithful': ('svc_cyl', 8, dict(nsteps=2, n_inner=2, gate=True,
                                        nsub=4, commit_faithful=True))}


def layout_material(name):
    """(JAX DeviceMaterial, CV, eps, sy) of a trained fixture."""
    import torch
    from pylabfea_tpu_torch import convert
    path = os.path.join(DATA, name + '.npz')
    mat, CV, eps = convert.material_from_npz(path, dtype=torch.float64,
                                             device='cpu')
    with np.load(path) as z:
        dm = jcon.DeviceMaterial(
            **{k: jnp.asarray(z[k], F64) for k in jcon.DeviceMaterial._fields
               if k not in FLAGS},
            **{k: bool(z[k]) for k in FLAGS})
    return dm, CV, eps, float(mat.sy)


def return_map_inputs(sy, n=40, seed=5):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * sy * rng.uniform(0.5, 0.95, (n, 1))
    return sig, rng.normal(0., 1e-3, (n, 6)), rng.normal(0., 1.5e-4, (n, 6))


def layouts():
    import warnings
    from pylabfea_tpu.ops import fe_kernels as jfek
    out = {}
    for name in ('svc_cyl', 'svc_wh', 'svc_tex_gsh3', 'svc_tex_adv'):
        dm, CV, _, sy = layout_material(name)
        sig, epl, deps = return_map_inputs(sy)
        out[f'rm.{name}.inputs'] = np.stack([sig, epl, deps])
        for fn in ('response_fast', 'response'):
            extra = (12, 1) if fn == 'response_fast' else ()
            res = getattr(jcon, fn)(dm, (jnp.asarray(sig), jnp.asarray(epl)),
                                    jnp.asarray(deps), jnp.asarray(CV),
                                    *extra)
            for i, r in enumerate(res):
                out[f'rm.{name}.{fn}.{i}'] = np.asarray(r)
    inner = jfek.load_step_split
    for tag, (name, N, kw) in LAYOUT_SOLVES.items():
        dm, CV, eps, _ = layout_material(name)
        md = jfek.rect_mesh(N, N, LX=2., LY=2., uniax='y', eps_tot=eps,
                            dtype=F64)
        hists = []

        def step(*a, **k):
            new, diag = inner(*a, **k)
            hists.append([int(i) for i in diag['cg_iters_hist']])
            return new, diag

        jfek.load_step_split = step
        try:
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                st, hist = jfek.solve_uniaxial(md, dm, CV, dtype=F64, **kw)
        finally:
            jfek.load_step_split = inner
        for k, h in enumerate(hists):
            out[f'uni.{tag}.cg{k}'] = np.asarray(h, int)
        out[f'uni.{tag}.glob_sig'] = np.stack([np.asarray(h[0])
                                               for h in hist])
        for f in ('u', 'sig', 'epl'):
            out[f'uni.{tag}.{f}'] = np.asarray(getattr(st, f))
    _save('layouts', out)


# -----------------------------------------------------------------
# calibrate (tests/test_torch_calibrate.py)
# -----------------------------------------------------------------
CAL_HILL = np.array([1.2, 0.9, 1.05, 1.0, 1.0, 1.0])
CAL_SY, CAL_KHARD = 150., 500.
#: theta of the derivative checks (with the Cholesky coefficients of CV)
CAL_THETA = {'log_sy': np.log(CAL_SY), 'log_hill': np.log(CAL_HILL),
             'raw_dsy': 2.0, 'raw_vr': 3.0, 'log_vb_peeq': 1.0}


def cal_cv(E=200000., nu=0.3):
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    CV = np.zeros((6, 6))
    CV[:3, :3] = lam
    CV[np.arange(3), np.arange(3)] += 2 * mu
    CV[np.arange(3, 6), np.arange(3, 6)] = mu
    return CV


def cal_paths(npaths, nsteps, seed=0, step=1.6e-3, first=2.5e-4):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(npaths, 6))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    steps = np.full(nsteps, step)
    steps[:3] = first
    return dirs[:, None, :] * steps[None, :, None]


def cal_simulate(deps, maxiter=40):
    from pylabfea_tpu.ops import calibrate as jcal
    th = {'log_sy': jnp.log(CAL_SY), 'log_hill': jnp.log(
        jnp.asarray(CAL_HILL)), 'raw_dsy': jnp.asarray(
            float(np.log(np.expm1(CAL_KHARD))))}
    return np.asarray(jcal.simulate_paths(th, jnp.asarray(cal_cv()),
                                          jnp.asarray(deps), maxiter))


def calibrate():
    from jax.flatten_util import ravel_pytree
    from pylabfea_tpu.ops import calibrate as jcal
    from pylabfea_tpu_torch.ops import calibrate as tcal
    out = {}
    # values, jacfwd and (unrolled) grad of simulate_paths
    deps = cal_paths(4, 8, seed=1)
    th = dict(CAL_THETA, cv_raw=tcal._cv_raw_of(cal_cv()))
    out['jac.deps'] = deps
    for k, v in th.items():
        out[f'jac.theta.{k}'] = np.asarray(v)
    x0, unravel = ravel_pytree({k: jnp.asarray(v) for k, v in th.items()})
    for integ in ('unrolled', 'implicit'):
        def f(x):
            y = jcal.simulate_paths(unravel(x), jnp.asarray(cal_cv()),
                                    jnp.asarray(deps), 40, 1, 0.01,
                                    integ).ravel()
            return y, y
        J, y = jax.jacfwd(f, has_aux=True)(x0)
        out[f'jac.{integ}.y'], out[f'jac.{integ}.J'] = y, J
        if integ == 'unrolled':
            out[f'jac.{integ}.g'] = jax.grad(
                lambda x: jnp.mean(f(x)[0] ** 2))(x0)
    # three LM steps from the slope seed
    deps = cal_paths(6, 12, seed=3)
    sig = cal_simulate(deps)
    out['fit.deps'], out['fit.sig'] = deps, sig
    p, info = jcal.fit_plasticity(jnp.asarray(deps), jnp.asarray(sig),
                                  jnp.asarray(cal_cv()), steps=3, maxiter=40)
    for k in ('sy', 'khard', 'hill'):
        out[f'fit.{k}'] = np.asarray(p[k])
        out[f'fit.std.{k}'] = np.asarray(info['param_std'][k])
    out['fit.loss'], out['fit.sim'] = np.asarray(info['loss']), info['sim']
    # a records dict in the tensor shear convention
    deps = cal_paths(6, 16, seed=5, step=1.2e-3, first=2e-4)
    sig = cal_simulate(deps)
    eps = np.cumsum(deps, axis=1)
    eps[..., 3:] *= 0.5
    out['data.sig'], out['data.eps'] = sig, eps
    records = {f'case{k}': {'Stress': sig[k], 'Strain_Total': eps[k]}
               for k in range(len(deps))}
    p, info = jcal.fit_from_data(records, nsteps=12,
                                 shear_convention='tensor', steps=2)
    for k in ('sy', 'khard', 'hill'):
        out[f'data.{k}'] = np.asarray(p[k])
    out['data.CV'], out['data.loss'] = info['CV'], np.asarray(info['loss'])
    _save('calibrate', out)


# -----------------------------------------------------------------
# jax_args (tests/test_torch_jax_args.py)
# -----------------------------------------------------------------
def jax_args():
    import warnings
    from pylabfea_tpu.ops import fe_kernels as jfek
    from pylabfea_tpu.ops import multigrid as jmg
    from pylabfea_tpu_torch import convert
    out = {}
    # the gated float32 step under both tangent tests
    m = FE.Material()
    m.elasticity(E=200.e3, nu=0.3)
    m.plasticity(sy=150., khard=5000., sdim=6)
    dm = jcon.device_material_from(m, dtype=jnp.float32)
    CV = np.asarray(m.CV, float)
    for rtol in (1e-4, 0.):
        md = jfek.rect_mesh(16, 16, eps_tot=0.002, dtype=jnp.float32)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            _, d = jfek.load_step_split(
                md, jfek.init_state(md, CV, dtype=jnp.float32), dm, CV, 0.5,
                n_inner=1, gate=True, max_inner=8, gate_dst_rtol=rtol)
        out[f'gate.{rtol}.hist'] = np.asarray(d['cg_iters_hist'], int)
        out[f'gate.{rtol}.glob_sig'] = np.asarray(d['glob_sig'])
    # the elastic 32^2 solve under both smoothers, the Chebyshev lmax
    CV = convert.elastic_cv(200.e3, 0.3)
    el = np.broadcast_to(CV.reshape(36, 1, 1), (36, 32, 32)).copy()
    try:
        for sm in ('jacobi', 'chebyshev'):
            jmg.SMOOTHER = sm
            jax.clear_caches()      # the switch is read at trace time
            md = jfek.rect_mesh(32, 32, uniax='y', eps_tot=0.001, dtype=F64)
            _, r, it = jfek.solve_linear(md, jnp.asarray(el), md.fixed_val,
                                         cg_tol=1e-10, cg_maxiter=100)
            out[f'smoother.{sm}.res'] = float(r)
            out[f'smoother.{sm}.iters'] = int(it)
            if sm == 'chebyshev':
                out['smoother.lmax'] = np.asarray(
                    [float(lv.lmax) for lv in jmg.build_hierarchy(
                        md, jnp.asarray(el))])
    finally:
        jmg.SMOOTHER = 'jacobi'
        jax.clear_caches()
    _save('jax_args', out)


# -----------------------------------------------------------------
# element (tests/test_torch_element_sharded.py)
# -----------------------------------------------------------------
#: the inclusion of the 2-material 16 x 8 case: Hill matrix, soft elastic
#: inclusion at x-columns 2-5 (in the first half of the elements)
ELEM_INCL_MAP = np.zeros((16, 8), int)
ELEM_INCL_MAP[2:6, 2:6] = 1


def elem_inclusion():
    mh = FE.Material(num=1)
    mh.elasticity(E=200.e3, nu=0.3)
    mh.plasticity(sy=150., hill=[0.7, 1., 1.4, 1., 1., 1.], sdim=6)
    me = FE.Material(num=2)
    me.elasticity(E=1.e3, nu=0.27)
    return (tuple(jcon.device_material_from(m, dtype=F64) for m in (mh, me)),
            tuple(np.asarray(m.CV, float) for m in (mh, me)))


def elem_fit_paths():
    """tests/test_calibrate.py's sharded-fit paths: 16 unit directions, 25
    steps (five of 2.5e-4, then 1.6e-3)."""
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(16, 6))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    steps = np.full(25, 1.6e-3)
    steps[:5] = 2.5e-4
    return dirs[:, None, :] * steps[None, :, None]


def _flat_steps(out, tag, N, L, eps, dms, CVs, fracs, **kw):
    """JAX ``load_step_split`` on the flat single-device mesh
    (``shard_mesh_data(md, make_mesh(1))``), CG to 1e-10, 500 iterations,
    each later step warm-started from the last increment."""
    from pylabfea_tpu.ops import fe_kernels as jfek
    from pylabfea_tpu.parallel import mesh as jmesh
    md = jmesh.shard_mesh_data(
        jfek.rect_mesh(*N, LX=L[0], LY=L[1], uniax='y', eps_tot=eps,
                       dtype=F64, **kw), jmesh.make_mesh(1))
    st = jfek.init_state(md, CVs, dtype=F64)
    gs, du = [], None
    for k, frac in enumerate(fracs):
        st, d = jfek.load_step_split(md, st, dms, CVs, frac, n_inner=2,
                                     cg_tol=1e-10, cg_maxiter=500, du0=du)
        du = d['du']
        gs.append(np.asarray(d['glob_sig']))
        out[f'{tag}.hist{k}'] = np.asarray(d['cg_iters_hist'], int)
    out[f'{tag}.glob_sig'], out[f'{tag}.du'] = np.stack(gs), np.asarray(du)


def element():
    from pylabfea_tpu.ops import calibrate as jcal
    out = {}
    dm, CV, _ = svc_material()
    _flat_steps(out, 'svc', (16, 4), (4., 1.), 0.002, dm, CV, (0.5, 0.25))
    dms, CVs = elem_inclusion()
    _flat_steps(out, 'incl', (16, 8), (2., 1.), 0.004, dms, CVs,
                (0.25, 0.25), mat_map=ELEM_INCL_MAP)
    dm3, CV3 = j2_3d()
    md = box(8)
    st = jfe3d.init_state3(md, CV3, dtype=F64)
    st, d = jfe3d.load_step3(md, st, dm3, CV3, 0.7, n_inner=2,
                             du0=jnp.zeros_like(st.u))
    out['j3.glob_sig'], out['j3.u'] = d['glob_sig'], st.u
    out['j3.hist'] = np.asarray(d['cg_iters_hist'], int)
    deps = elem_fit_paths()
    CVf = cal_cv()
    th = {'log_sy': jnp.log(150.),
          'log_hill': jnp.log(jnp.asarray([1.2, 0.9, 1.05, 1., 1., 1.])),
          'raw_dsy': jnp.asarray(float(np.log(np.expm1(500.))))}
    sig = jcal.simulate_paths(th, jnp.asarray(CVf), jnp.asarray(deps), 40)
    out['fit.deps'], out['fit.sig'], out['fit.CV'] = deps, sig, CVf
    p, _ = jcal.fit_plasticity(jnp.asarray(deps), sig, jnp.asarray(CVf),
                               steps=40)
    for k in ('sy', 'khard', 'hill'):
        out[f'fit.{k}'] = np.asarray(p[k])
    _save('element', out)


# -----------------------------------------------------------------
# host
# -----------------------------------------------------------------
def ml_shear_material(FE, SVCParams):
    """``tests/test_ml.py``'s trained ML-Hill-6D material, its SVC read
    from ``data/bridge_ml_shear.npz`` (no training)."""
    z = np.load(os.path.join(DATA, 'bridge_ml_shear.npz'))
    m = FE.Material(name='Hill-ML')
    m.elasticity(E=float(z['m0.E']), nu=float(z['m0.nu']))
    m.plasticity(sy=float(z['m0.sy']), sdim=6)
    m.ML_yf, m.Ndof, m.dev_only = True, 6, bool(z['m0.dev_only'])
    m.scale_seq = float(z['m0.scale_seq'])
    m.gam_yf = float(z['m0.gamma'])
    m._svc = SVCParams(z['m0.sv'], z['m0.dc'], float(z['m0.rho']),
                       float(z['m0.gamma']))
    return m


def ml_shear_model(FE, mat):
    """``tests/test_ml.py``'s ``test_ml_shear`` model: 6 x 3 plane stress,
    the top sheared by 0.006 LY, the bottom fixed."""
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


def host_fields(fem):
    """The fields of a solved host ``Model``: u, f, the global history and
    values, the element states."""
    out = {k: np.asarray(getattr(fem, k), float)
           for k in ('u', 'f', 'sgl', 'egl', 'epgl')}
    out.update({f'glob.{k}': np.asarray(fem.glob[k], float)
                for k in ('sig', 'eps', 'epl')})
    out.update({f'el.{k}': np.array([getattr(e, k) for e in fem.element])
                for k in ('sig', 'eps', 'epl')})
    return out


def host():
    from pylabfea_tpu.ops.svc import SVCParams
    fem = ml_shear_model(FE, ml_shear_material(FE, SVCParams))
    fem.solve()
    fem.calc_global()
    _save('host', {f'ml_shear.{k}': v for k, v in host_fields(fem).items()})


GROUPS = dict(fe3d=fe3d, multimat=multimat, layouts=layouts,
              calibrate=calibrate, jax_args=jax_args, element=element,
              host=host)

if __name__ == '__main__':
    for name in sys.argv[1:] or list(GROUPS):
        GROUPS[name]()
