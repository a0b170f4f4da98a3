"""PyTorch port: element-axis sharding (``parallel.mesh``, ``mesh3d``) and
the path-sharded ``calibrate.fit_plasticity`` on 2 and 4 Gloo ranks on the
CPU, against the JAX package's single-device functions in float64:

* 2-D: ``load_step_split`` (a cold 0.5 step and a warm 0.25 step) on
  ``tests/test_device.py``'s 16 x 4 mesh with the trained SVC of
  ``REF_SOLVE_svc.npz``, against JAX's on ``shard_mesh_data(md,
  make_mesh(1))`` (its flat mesh): glob_sig and du within 1e-10 of their
  scale, the same CG histories; and at W = 2 a 2-material 16 x 8
  inclusion that lies in rank 0's share only, so that rank 1's block of
  it is empty;
* 3-D: ``tests/test_fe3d.py``'s 8^3 J2 step (0.7 of the load) against
  JAX's ``load_step3``: glob_sig within 1e-10, u within 1e-12;
* the fit: ``tests/test_calibrate.py``'s 16 paths x 25 steps, 40 LM
  steps, against JAX's unsharded fit: sy and hill within 1e-10, khard
  within 1e-8 (relative), every rank with the same parameters.

One spawn a world size runs every case (``runs.suite``); the
single-device references are JAX's results committed in
``pylabfea_tpu_torch/data/ref_element.npz``
(``tools/make_torch_ref_fixtures.py element``), and the flat 2-D step runs
live in JAX at world size 1."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pylabfea_tpu as FE
from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import fe_kernels as jfek
from pylabfea_tpu.parallel import mesh as jmesh
from pylabfea_tpu_torch import convert, workloads
from pylabfea_tpu_torch.ops import fe3d
from pylabfea_tpu_torch.ops import fe_kernels as tfek
from pylabfea_tpu_torch.ops.femu import flatten_mesh
from pylabfea_tpu_torch.parallel import launch, runs
from pylabfea_tpu_torch.parallel import mesh as tmesh
from pylabfea_tpu_torch.parallel import mesh3d as tmesh3
from pylabfea_tpu_torch.parallel.distributed import RankMesh

# One torch thread: the suite runs several test processes at once (the
# spawned ranks take one each too).
torch.set_num_threads(1)

F64 = jnp.float64
T64 = dict(dtype=torch.float64, device='cpu')
REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pylabfea_tpu_torch', 'data', 'ref_element.npz')
#: CG tolerance of the 2-D steps: above the f64 rounding floor of
#: Jacobi-CG on these systems, where two summation orders could end a
#: solve one iteration apart
CG_TOL = 1e-10
SVC = dict(kind='elem2d', NX=16, NY=4, LX=4., LY=1., eps=0.002, mats='svc',
           dtype='float64', fracs=[0.5, 0.25], n_inner=2, cg_tol=CG_TOL)
#: the inclusion: Hill matrix, soft elastic inclusion at x-columns 2-5
INCL_MAP = np.zeros((16, 8), int)
INCL_MAP[2:6, 2:6] = 1
J3 = dict(kind='elem3d', NX=8, NY=8, NZ=8, eps=0.002, mats='j2',
          dtype='float64', fracs=[0.7], n_inner=2)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope='module')
def ref():
    """JAX's results of ``tools/make_torch_ref_fixtures.py element``."""
    with np.load(REF) as z:
        return {k: z[k] for k in z.files}


def _incl_case():
    mh = FE.Material(num=1)
    mh.elasticity(E=200.e3, nu=0.3)
    mh.plasticity(sy=150., hill=[0.7, 1., 1.4, 1., 1., 1.], sdim=6)
    me = FE.Material(num=2)
    me.elasticity(E=1.e3, nu=0.27)
    mats = [{k: v if isinstance(v, bool) else np.asarray(v)
             for k, v in jcon.device_material_from(m, dtype=F64)
             ._asdict().items()} for m in (mh, me)]
    return dict(kind='elem2d', NX=16, NY=8, LX=2., LY=1., eps=0.004,
                mats=mats, CVs=[np.asarray(m.CV, float) for m in (mh, me)],
                mat_map=INCL_MAP, dtype='float64', fracs=[0.25, 0.25],
                n_inner=2, cg_tol=CG_TOL)


def _fit_case(ref):
    """tests/test_calibrate.py's sharded-fit paths (their JAX-simulated
    stresses from the fixture)."""
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(16, 6))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    steps = np.full(25, 1.6e-3)
    steps[:5] = 2.5e-4
    np.testing.assert_array_equal(dirs[:, None, :] * steps[None, :, None],
                                  ref['fit.deps'])
    return dict(kind='fit', deps=ref['fit.deps'], sig=ref['fit.sig'],
                CV=ref['fit.CV'], steps=40, dtype='float64')


def _check_2d(res, ref, tag):
    for r in res:
        assert _rel(r['glob_sig'], ref[f'{tag}.glob_sig']) <= 1e-10, tag
        assert _rel(r['du'], ref[f'{tag}.du']) <= 1e-10, tag
        assert r['cg_iters_hist'] == [list(ref[f'{tag}.hist{k}'])
                                      for k in range(len(r['glob_sig']))]
        np.testing.assert_array_equal(r['glob_sig'], res[0]['glob_sig'])


@pytest.mark.parametrize('W', [2, 4])
def test_sharded_steps_and_fit_match_jax(ref, W):
    """On W Gloo ranks: the 2-D SVC steps (and at W = 2 the inclusion
    with an empty block) within 1e-10 of JAX's flat single-device steps
    with the same CG histories; the 3-D step within 1e-10 on glob_sig and
    1e-12 on u (JAX's 8-device test's bounds) with the same histories;
    the fit with the same parameters on every rank, within 1e-10 (sy,
    hill) and 1e-8 (khard) of JAX's unsharded fit."""
    cases = dict(svc=SVC, j3=J3, fit=_fit_case(ref))
    if W == 2:
        cases['incl'] = _incl_case()
    out = launch.spawn(runs.suite, W, 'gloo', ['cpu'] * W,
                       (list(cases.values()),))
    res = {k: [r[i] for r in out] for i, k in enumerate(cases)}
    _check_2d(res['svc'], ref, 'svc')
    if W == 2:
        _check_2d(res['incl'], ref, 'incl')
        assert np.abs(ref['incl.glob_sig']).max() > 0
    for r in res['j3']:
        np.testing.assert_allclose(r['glob_sig'][-1], ref['j3.glob_sig'],
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(r['u'], ref['j3.u'], rtol=0, atol=1e-12)
        assert r['cg_iters_hist'][-1] == list(ref['j3.hist'])
    fits = res['fit']
    for r in fits:
        for k in ('sy', 'khard', 'hill'):
            np.testing.assert_array_equal(r[k], fits[0][k])
        np.testing.assert_allclose(r['sy'], ref['fit.sy'], rtol=1e-10)
        np.testing.assert_allclose(r['hill'], ref['fit.hill'], rtol=1e-10)
        np.testing.assert_allclose(r['khard'], ref['fit.khard'], rtol=1e-8)
    assert sum(len(r['sim']) for r in fits) == 16


def test_world_size_one_is_the_unsharded_step_and_jax():
    """At world size 1 the sharded steps are the unsharded flat 2-D step
    and ``load_step3`` bit for bit; the sharded 2-D cold step matches JAX's
    flat single-device step (live) within 1e-10."""
    mat, CV, _ = convert.material_from_npz(workloads.NPZ, **T64)
    one = runs.suite(RankMesh(), 'cpu', [dict(SVC, fracs=[0.5]),
                                         dict(J3, NX=4, NY=4, NZ=4)])
    fm = flatten_mesh(tfek.rect_mesh(16, 4, LX=4., LY=1., eps_tot=0.002,
                                     **T64))
    _, d = tfek.load_step_split(fm, tfek.init_state(fm, CV, torch.float64),
                                mat, CV, 0.5, n_inner=2, cg_tol=CG_TOL,
                                cg_maxiter=500)
    np.testing.assert_array_equal(one[0]['glob_sig'][0], d['glob_sig'])
    np.testing.assert_array_equal(one[0]['du'], d['du'])
    dm = jcon.DeviceMaterial(
        hill=jnp.ones(6, F64), sy=jnp.asarray(mat.sy, F64),
        khard=jnp.asarray(0., F64), drucker=jnp.asarray(0., F64),
        sv=jnp.asarray(mat.sv.numpy()), dc=jnp.asarray(mat.dc.numpy()),
        rho=jnp.asarray(mat.rho, F64), gamma=jnp.asarray(mat.gamma, F64),
        scale_seq=jnp.asarray(mat.scale_seq, F64),
        scale_wh=jnp.asarray(1., F64), feat_mean=jnp.zeros(0, F64),
        feat_scale=jnp.zeros(0, F64), tex=jnp.zeros(0, F64), is_svc=True,
        dev_only=mat.dev_only)
    mj = jmesh.shard_mesh_data(jfek.rect_mesh(
        16, 4, LX=4., LY=1., uniax='y', eps_tot=0.002, dtype=F64),
        jmesh.make_mesh(1))
    _, dj = jfek.load_step_split(mj, jfek.init_state(mj, CV, dtype=F64), dm,
                                 CV, 0.5, n_inner=2, cg_tol=CG_TOL,
                                 cg_maxiter=500)
    assert _rel(one[0]['glob_sig'][0], dj['glob_sig']) <= 1e-10
    assert _rel(one[0]['du'], dj['du']) <= 1e-10
    assert one[0]['cg_iters_hist'][0] == [int(x)
                                          for x in dj['cg_iters_hist']]
    m3 = fe3d.box_mesh(4, 4, 4, uniax='z', eps_tot=0.002, **T64)
    j2, CV3, _ = runs._materials(J3, torch.float64, 'cpu')
    st = fe3d.init_state3(m3, CV3, dtype=torch.float64)
    s3, _ = fe3d.load_step3(m3, st, j2, CV3, 0.7, n_inner=2,
                            du0=torch.zeros_like(st.u))
    np.testing.assert_array_equal(one[1]['u'], s3.u.numpy())


def test_shards_cut_the_mesh_and_state():
    """At world size 2 (position 1, no process group): the flat mesh of the
    rank's half (dofs, material blocks with an empty one), whole nodal
    vectors; the 3-D block of x-planes; a non-dividing count raises."""
    two = RankMesh((0, 1), 1)
    md = tfek.rect_mesh(16, 8, mat_map=INCL_MAP, **T64)
    ms = tmesh.shard_mesh_data(md, two, 'cpu')
    flat = flatten_mesh(md)
    assert ms.grid is None and ms.nel == 64 and ms.ranks is two
    np.testing.assert_array_equal(ms.dofs.numpy(), flat.dofs[64:].numpy())
    assert ms.groups == ((0, 64), (64, 0))
    assert ms.fixed.shape == flat.fixed.shape
    st = tmesh.shard_state(tfek.init_state(md, (np.eye(6), 2 * np.eye(6)),
                                           dtype=torch.float64), two)
    assert st.u.shape == (md.ndof,) and st.elstiff.shape == (64, 6, 6)
    with pytest.raises(ValueError):
        tmesh.shard_mesh_data(tfek.rect_mesh(5, 3, **T64), two, 'cpu')
    m3 = fe3d.box_mesh(4, 2, 2, **T64)
    m3s = tmesh3.shard_mesh_data3(m3, two, 'cpu')
    assert m3s.xr == (2, 4) and m3s.nel == 8
    s3 = tmesh3.shard_state3(fe3d.init_state3(m3, np.eye(6),
                                              dtype=torch.float64), two)
    assert s3.elstiff.shape == (36, 2, 2, 2) and s3.elstiff.is_contiguous()
    assert s3.sig.shape == (8, 6) and s3.u.shape == m3.fixed.shape
    with pytest.raises(ValueError):
        tmesh3.shard_mesh_data3(fe3d.box_mesh(3, 2, 2, **T64), two, 'cpu')
    assert tmesh.make_mesh(1, device='cpu') == RankMesh()
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, device='cpu')
