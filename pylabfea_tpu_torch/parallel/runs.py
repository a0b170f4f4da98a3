"""Runs of the domain decomposition on every rank: the targets that
``launch.spawn`` hands to its ranks (``suite(mesh, device, cases)``), and
that a single process calls with the one-rank mesh.  The CPU tests and
``chip_smoke.py`` phases 17 and 18 run them.

A case is a dict of plain values (it crosses into spawned processes):

* ``kind``: 'strip_elastic' (the elastic halo K-apply and CG of the JAX
  package's multi-process test), 'strip_step' (``strip_load_step``),
  'slab' (``solve_uniaxial3_slab``), 'elem2d' / 'elem3d' (load steps on
  the element-sharded meshes of ``parallel.mesh`` / ``mesh3d``) or 'fit'
  (``calibrate.fit_plasticity`` over the rank's share of the paths);
* the mesh: ``NX``, ``NY`` (``NZ``), ``LX``, ``LY``, ``eps``, ``dtype``
  ('float32' | 'float64'), optional ``bc`` and ``mat_map``;
* the materials ``mats``: 'svc' (the trained SVC of
  ``REF_SOLVE_svc.npz``), 'j2' (J2 with linear hardening, khard 500),
  'inclusion' (``workloads.inclusion_materials`` with their map and BCs)
  or a list of ``convert.materials_from_params`` dicts with ``CVs``;
* the step's options (``load_frac``, ``n_inner``, ``cg_tol``,
  ``schwarz``, ``grouped``; ``nsteps``, ``two_level`` for slabs;
  ``fracs``, ``cg_maxiter`` for the element-sharded steps, each step after
  the first warm-started from the last increment);
* for 'fit': ``deps``, ``sig`` (every path, numpy; the rank fits its
  contiguous share), ``CV``, ``steps`` and ``dtype``.

Each result is a dict of numpy arrays and numbers of this rank's block,
with the seconds of the solver call and the kernel launches it made.
"""
import time

import numpy as np
import torch

from pylabfea_tpu_torch import convert, workloads
from pylabfea_tpu_torch.ops import calibrate, fe3d, stencil, svc_kernels, \
    volume
from pylabfea_tpu_torch.ops import fe_kernels as fek
from pylabfea_tpu_torch.ops.femu import flatten_mesh
from pylabfea_tpu_torch.parallel import mesh as em
from pylabfea_tpu_torch.parallel import mesh3d as em3
from pylabfea_tpu_torch.parallel import sharded as sh
from pylabfea_tpu_torch.parallel import sharded3 as sh3

#: the kernel wrappers whose launches a run reports
COUNTERS = (stencil.k_apply, volume.k_apply3, svc_kernels.svc_f_grad,
            svc_kernels.svc_decision)


def _np(t):
    if isinstance(t, (tuple, list)):
        return np.stack([_np(x) for x in t])
    return t.detach().cpu().numpy()


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _launches(before=None):
    now = {c.__name__: c.launches for c in COUNTERS}
    return now if before is None else {k: now[k] - before[k] for k in now}


def _materials(case, dtype, device):
    """(material or tuple, CV or tuple, mesh keywords) of a case."""
    mats = case['mats']
    if mats == 'svc':
        mat, CV, _ = convert.material_from_npz(workloads.NPZ, dtype=dtype,
                                               device=device)
        return mat, CV, {}
    if mats == 'j2':
        return (convert.material_from_params(
            dict(hill=np.ones(6), sy=workloads.SY, khard=500., drucker=0.),
            is_svc=False, dtype=dtype, device=device),
            convert.elastic_cv(200.e3, 0.3), {})
    if mats == 'inclusion':
        m, CVs = workloads.inclusion_materials(dtype, device)
        return m, CVs, dict(bc=workloads.INCL_BC,
                            mat_map=workloads.inclusion_map(case['NX']))
    m = convert.materials_from_params(mats, dtype=dtype, device=device)
    CVs = tuple(np.asarray(c, float) for c in case['CVs'])
    kw = {k: case[k] for k in ('bc', 'mat_map') if case.get(k) is not None}
    if len(m) == 1 and 'mat_map' not in kw:
        return m[0], CVs[0], kw
    return m, CVs, kw


def strip_elastic(mesh, device, case):
    """The elastic strip problem of the JAX package's multi-process test
    (LX = 4, LY = 1, uniaxial y at ``eps``): the halo K-apply of the BC
    lift and the Jacobi-CG solve to ``cg_tol``."""
    dt = getattr(torch, case['dtype'])
    NX, NY = case['NX'], case['NY']
    sm = sh.StripMesh(NX, NY, LX=4., LY=1., uniax='y', eps_tot=case['eps'],
                      mesh=mesh, dtype=dt, device=device)
    CV = convert.elastic_cv(200.e3, 0.3)
    el = sm.shard_elements(np.broadcast_to(CV, (NX * NY, 6, 6)).copy())
    du_bc = tuple(torch.where(f, b, 0.) for f, b in zip(sm.fixed,
                                                         sm.fixed_val))
    neg = sh.make_k_apply(sm)(el, du_bc, tuple(torch.zeros_like(f)
                                               for f in sm.fixed))
    rhs = tuple(torch.where(f, b, -q)
                for f, b, q in zip(sm.fixed, sm.fixed_val, neg))
    t0, n0 = time.perf_counter(), _launches()
    du, res, it = sh.cg_solve_strip(
        sm, el, rhs, du_bc, sh.k_diag_planes(sm, sh.element_Ke_planes(sm,
                                                                       el)),
        tol=case.get('cg_tol', 1e-12), maxiter=5000)
    _sync(device)
    return dict(neg=_np(neg), du=_np(du), res=res, it=it,
                checksum=float(sh.make_dot(sm)(du, du, sm.own)),
                order=mesh.order, pos=mesh.pos,
                seconds=time.perf_counter() - t0, launches=_launches(n0))


def strip_step(mesh, device, case):
    """One ``strip_load_step`` from the virgin state."""
    dt = getattr(torch, case['dtype'])
    mat, CV, kw = _materials(case, dt, device)
    NX, NY = case['NX'], case['NY']
    sm = sh.StripMesh(NX, NY, LX=case.get('LX', 1.), LY=case.get('LY', 1.),
                      uniax='y', eps_tot=case.get('eps', 0.), mesh=mesh,
                      dtype=dt, device=device, **kw)
    if isinstance(CV, tuple):
        ids = np.asarray(kw['mat_map']).reshape(-1)
        rows = np.stack(CV)[ids]
    else:
        rows = np.broadcast_to(CV, (NX * NY, 6, 6)).copy()
    el = sm.shard_elements(rows)
    z = torch.zeros((sm.nel_loc, 6), dtype=dt, device=sm.device)
    _sync(device)
    t0, n0 = time.perf_counter(), _launches()
    sig, epl, du, d = sh.strip_load_step(
        sm, el, z, z, mat, case.get('load_frac', 1.),
        n_inner=case.get('n_inner', 2), cg_tol=case.get('cg_tol', 1e-8),
        schwarz=case.get('schwarz', 2),
        CVs=CV if isinstance(CV, tuple) else None,
        grouped=case.get('grouped', True))
    _sync(device)
    return dict(sig=_np(sig), epl=_np(epl), du=_np(du),
                glob_sig=_np(d['glob_sig']), glob_epl=_np(d['glob_epl']),
                cg_iters=d['cg_iters'], cg_iters_hist=d['cg_iters_hist'],
                cg_res=d['cg_res'],
                seconds=time.perf_counter() - t0, launches=_launches(n0))


def slab(mesh, device, case):
    """``solve_uniaxial3_slab`` from the virgin state (uniaxial z to
    ``eps``)."""
    dt = getattr(torch, case['dtype'])
    mat, CV, kw = _materials(case, dt, device)
    sm = sh3.SlabMesh3(case['NX'], case['NY'], case['NZ'], uniax='z',
                       eps_tot=case['eps'], mesh=mesh, dtype=dt,
                       device=device, **kw)
    _sync(device)
    t0, n0 = time.perf_counter(), _launches()
    sig, epl, u, hist = sh3.solve_uniaxial3_slab(
        sm, mat, CV, nsteps=case.get('nsteps', 1),
        n_inner=case.get('n_inner', 2), two_level=case.get('two_level',
                                                           True))
    _sync(device)
    return dict(sig=_np(sig), epl=_np(epl), u=_np(u),
                glob_sig=np.stack([_np(h[0]) for h in hist]),
                cg_iters=[h[2] for h in hist],
                seconds=time.perf_counter() - t0, launches=_launches(n0))


def _steps(step, state, fracs, device):
    """``step(state, frac, du0)`` for each load fraction, each after the
    first warm-started from the last increment: (state, the diags,
    seconds, kernel launches)."""
    diags, du0 = [], None
    _sync(device)
    t0, n0 = time.perf_counter(), _launches()
    for frac in fracs:
        state, d = step(state, frac, du0)
        du0 = d['du']
        diags.append(d)
    _sync(device)
    return state, diags, time.perf_counter() - t0, _launches(n0)


def elem2d(mesh, device, case):
    """``load_step_split`` on this rank's share of the elements of the
    flat NX x NY mesh (``parallel.mesh``), from the virgin state, at the
    load fractions ``fracs``."""
    dt = getattr(torch, case['dtype'])
    mat, CV, kw = _materials(case, dt, device)
    md = fek.rect_mesh(case['NX'], case['NY'], LX=case.get('LX', 1.),
                       LY=case.get('LY', 1.), uniax='y',
                       eps_tot=case.get('eps', 0.), dtype=dt, device=device,
                       **kw)
    md_s = em.shard_mesh_data(md, mesh, device)
    state = em.shard_state(fek.init_state(flatten_mesh(md), CV, dtype=dt),
                           mesh)

    def step(st, frac, du0):
        return fek.load_step_split(
            md_s, st, mat, CV, frac, n_inner=case.get('n_inner', 2),
            cg_tol=case.get('cg_tol'), cg_maxiter=case.get('cg_maxiter',
                                                           500), du0=du0)

    state, diags, secs, launches = _steps(step, state, case['fracs'], device)
    return dict(sig=_np(state.sig), u=_np(state.u), du=_np(diags[-1]['du']),
                glob_sig=np.stack([_np(d['glob_sig']) for d in diags]),
                cg_iters_hist=[d['cg_iters_hist'] for d in diags],
                seconds=secs, launches=launches)


def elem3d(mesh, device, case):
    """``load_step3`` on this rank's element x-planes of the NX x NY x
    NZ box (``parallel.mesh3d``, uniaxial z to ``eps``), from the virgin
    state, at the load fractions ``fracs``."""
    dt = getattr(torch, case['dtype'])
    mat, CV, kw = _materials(case, dt, device)
    md = fe3d.box_mesh(case['NX'], case['NY'], case['NZ'], uniax='z',
                       eps_tot=case['eps'], dtype=dt, device=device, **kw)
    md_s = em3.shard_mesh_data3(md, mesh, device)
    state = em3.shard_state3(fe3d.init_state3(md, CV, dtype=dt), mesh)

    def step(st, frac, du0):
        return fe3d.load_step3(md_s, st, mat, CV, frac,
                               n_inner=case.get('n_inner', 2), du0=du0)

    state, diags, secs, launches = _steps(step, state, case['fracs'], device)
    return dict(sig=_np(state.sig), u=_np(state.u),
                glob_sig=np.stack([_np(d['glob_sig']) for d in diags]),
                cg_iters_hist=[d['cg_iters_hist'] for d in diags],
                seconds=secs, launches=launches)


def fit(mesh, device, case):
    """``calibrate.fit_plasticity`` on this rank's contiguous share of
    the paths (``np.array_split`` in position order), sharded over the
    ranks."""
    dt = getattr(torch, case['dtype'])
    part = np.array_split(np.arange(len(case['deps'])), mesh.size)[mesh.pos]

    def ten(a):
        return torch.as_tensor(np.asarray(a)[part], dtype=dt, device=device)

    _sync(device)
    t0 = time.perf_counter()
    params, info = calibrate.fit_plasticity(
        ten(case['deps']), ten(case['sig']), np.asarray(case['CV']),
        steps=case['steps'], ranks=mesh)
    _sync(device)
    return dict(params, loss=np.asarray(info['loss']), sim=info['sim'],
                seconds=time.perf_counter() - t0)


KINDS = dict(strip_elastic=strip_elastic, strip_step=strip_step, slab=slab,
             elem2d=elem2d, elem3d=elem3d, fit=fit)


def suite(mesh, device, cases):
    """Every case in turn on this rank: the list of results."""
    return [KINDS[c['kind']](mesh, device, c) for c in cases]
