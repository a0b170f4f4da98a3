"""PyTorch port: multi-material meshes (``mat_map``) against the JAX
reference in float64: the 2-D 3-material inclusion of ``bench.py``
(Hill sdim=6, J2 sdim=3, soft elastic; general BCs with a corner pin), a
two-group SVC + elastic mesh, the convergence gate, the 3-D stiff
inclusion, and the 3-D reference-faithful route (``fast=False``).  Every
JAX mesh is built fresh (its coarse-mesh chain cache would serve a stale
mesh for ``_replace`` copies).

The meshes, their material blocks and stiffnesses are held against JAX's
live; the grouped return map, the load steps and solves against JAX's
results committed in ``pylabfea_tpu_torch/data/ref_multimat.npz``
(``tools/make_torch_ref_fixtures.py multimat``)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pylabfea_tpu as FE
from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import fe3d as jfe3d
from pylabfea_tpu.ops import fe_kernels as jfek
from pylabfea_tpu_torch import convert, workloads
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import fe3d as tfe3d
from pylabfea_tpu_torch.ops import fe_kernels as tfek

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, 'REF_SOLVE_svc.npz')
REF = os.path.join(ROOT, 'pylabfea_tpu_torch', 'data', 'ref_multimat.npz')
F64 = jnp.float64
T64 = dict(dtype=torch.float64, device='cpu')
#: the bench.py inclusion's BCs at LX = LY = 4: bottom and top displaced,
#: lateral edges free, the corner node pinned in x
BC = {'bot': {1: ('disp', 0.)}, 'left': {}, 'right': {},
      'top': {1: ('disp', 0.002 * 4.)}, 'nodes': ((0, 0, 0, 'disp', 0.),)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _torch_materials(dms):
    """The JAX DeviceMaterials carried across as numpy leaves."""
    return convert.materials_from_params(
        [{k: v if isinstance(v, bool) else np.asarray(v)
          for k, v in dm._asdict().items()} for dm in dms], **T64)


def _inclusion_materials():
    """bench.py's three materials: Hill [0.7, 1, 1.4, 1, 1, 1] sdim=6, J2
    sdim=3, elastic E = 1e3.  Returns (JAX mats, torch mats, CVs)."""
    mat_h = FE.Material(num=1)
    mat_h.elasticity(E=200.e3, nu=0.3)
    mat_h.plasticity(sy=150., hill=[0.7, 1., 1.4, 1., 1., 1.], sdim=6)
    mat_j = FE.Material(num=2)
    mat_j.elasticity(E=200.e3, nu=0.3)
    mat_j.plasticity(sy=150., sdim=3)
    mat_el = FE.Material(num=3)
    mat_el.elasticity(E=1.e3, nu=0.27)
    mats = (mat_h, mat_j, mat_el)
    dms = tuple(jcon.device_material_from(m, dtype=F64) for m in mats)
    return dms, _torch_materials(dms), tuple(np.asarray(m.CV, float)
                                             for m in mats)


def _inclusion_map(N):
    mat_map = np.zeros((N, N), dtype=int)
    mat_map[N // 2:, :] = 1
    mat_map[N // 3: 2 * N // 3, N // 3: 2 * N // 3] = 2
    return mat_map


def _inclusion_meshes(N):
    kw = dict(LX=4., LY=4., bc=BC, mat_map=_inclusion_map(N))
    return (jfek.rect_mesh(N, N, dtype=F64, **kw),
            tfek.rect_mesh(N, N, **T64, **kw))


def _assert_state(st, sj, rtol, fields=('u', 'sig', 'epl', 'eps',
                                         'elstiff')):
    for f in fields:
        assert _rel(getattr(st, f).numpy(), getattr(sj, f)) <= rtol, f


@pytest.fixture(scope='module')
def ref():
    """JAX's results of ``tools/make_torch_ref_fixtures.py multimat``."""
    with np.load(REF) as z:
        return {k: z[k] for k in z.files}


class _State:
    """A committed JAX state (``tag.u``, ``tag.sig``, ...)."""

    def __init__(self, ref, tag):
        for f in ('u', 'sig', 'epl', 'eps', 'elstiff'):
            setattr(self, f, ref[f'{tag}.{f}'])


def _steps_match(ref, tag, mt, tms, CVs, fracs):
    """Warm-started port steps against the committed JAX steps ``tag{k}``:
    1e-9 on the fields and glob_sig, equal CG histories.  Returns the
    last state."""
    st = tfek.init_state(mt, CVs, dtype=torch.float64)
    dt = None
    for k, frac in enumerate(fracs):
        warm = {} if dt is None else dict(
            du0=dt['du'], kes0=dt['kes'], dst0=dt['dstiff'])
        st, dt = tfek.load_step_split(mt, st, tms, CVs, frac, n_inner=2,
                                      **warm)
        assert dt['cg_iters_hist'] == list(ref[f'{tag}{k}.hist'])
        _assert_state(st, _State(ref, f'{tag}{k}'), 1e-9)
        assert _rel(dt['glob_sig'].numpy(), ref[f'{tag}{k}.glob_sig']) \
            <= 1e-9
    return st


def test_rect_mesh_mat_map_fields_bitwise():
    """The inclusion mesh, its materials and stiffnesses as the port's
    ``workloads.inclusion_case`` builds them, against JAX's from the host
    materials: bitwise."""
    md, _ = _inclusion_meshes(24)
    mt, tms, CVt = workloads.inclusion_case(24, torch.float64, 'cpu')
    for f in ('B', 'Bsum', 'jacw', 'vel', 'fixed', 'fixed_val', 'force',
              'perm', 'inv_perm'):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(md, f)), err_msg=f)
    assert mt.groups == md.groups and mt.ps_b2 is None
    assert torch.equal(mt.perm[mt.inv_perm], torch.arange(mt.nel))
    _, tmj, CVs = _inclusion_materials()
    for a, b in zip(CVs, CVt):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tms, tmj):
        for k, v in a.__dict__.items():
            w = getattr(b, k)
            assert torch.equal(v, w) if torch.is_tensor(v) else v == w, k
    np.testing.assert_array_equal(
        tfek.init_state(mt, CVs, dtype=torch.float64).elstiff.numpy(),
        np.asarray(jfek.init_state(md, CVs, dtype=F64).elstiff))


def test_box_mesh_mat_map_fields_bitwise():
    mm = np.random.default_rng(0).integers(0, 3, (4, 3, 5))
    mm[0, 0, 0] = 2
    md = jfe3d.box_mesh(4, 3, 5, mat_map=mm, dtype=F64)
    mt = tfe3d.box_mesh(4, 3, 5, mat_map=mm, **T64)
    for f in ('perm', 'inv_perm', 'fixed', 'fixed_val'):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(md, f)), err_msg=f)
    assert mt.groups == md.groups
    CVs = tuple(np.diag(np.arange(1., 7.)) * (k + 1) for k in range(3))
    np.testing.assert_array_equal(
        tfe3d.init_state3(mt, CVs, dtype=torch.float64).elstiff.numpy(),
        np.asarray(jfe3d.init_state3(md, CVs, dtype=F64).elstiff))


@pytest.mark.parametrize('fast', [True, False])
def test_respond_grouped_matches_jax(ref, fast):
    """The grouped return map on random plastic increments: three
    materials (one of them the elastic sentinel) over the inclusion's
    groups, 1e-12 of each output's scale (JAX's from the committed
    fixture)."""
    N = 16
    _, mt = _inclusion_meshes(N)
    _, tms, CVs = _inclusion_materials()
    rng = np.random.default_rng(4)
    u = rng.normal(size=(N * N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * 150. * rng.uniform(0.5, 0.95, (N * N, 1))
    deps = rng.normal(0., 3e-4, (N * N, 6))
    np.testing.assert_array_equal(sig, ref['rg.sig'])
    np.testing.assert_array_equal(deps, ref['rg.deps'])
    epl = np.zeros((N * N, 6))
    out_t = tfek.respond_grouped(mt, tms, CVs, torch.tensor(sig),
                                 torch.tensor(epl), torch.tensor(deps),
                                 fast=fast, nsub=2)
    out_j = [ref[f'rg.{fast}.{i}'] for i in range(4)]
    assert (np.abs(out_j[2]).sum(-1) > 0).sum() > 20
    for a, b in zip(out_t, out_j):
        assert _rel(a.numpy(), b) <= 1e-12


@pytest.mark.parametrize('fast', [True, False])
def test_elastic_sentinel_stays_finite_in_float32(fast):
    """The elastic material's sentinel yield strength (1e15) keeps every
    lane elastic and finite in float32 through both return maps' masked
    plastic branches (their intermediates scale like its square), zero
    increments included: the elastic predictor, no plastic strain, CV as
    the tangent."""
    mat = convert.elastic_material(torch.float32, 'cpu')
    CV = torch.tensor(convert.elastic_cv(1.e3, 0.27), dtype=torch.float32)
    rng = np.random.default_rng(5)
    sig = torch.tensor(rng.normal(size=(512, 6)) * 1e3, dtype=torch.float32)
    deps = torch.tensor(rng.normal(size=(512, 6)) * 1e-2,
                        dtype=torch.float32)
    deps[:16] = 0.
    state = (sig, torch.zeros_like(sig))
    out = tcon.response_fast(mat, state, deps, CV, 12, 4) if fast \
        else tcon.response(mat, state, deps, CV)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    pred = sig + deps @ CV.T
    assert float((out[1] - pred).abs().max()) <= 1e-6 * float(
        pred.abs().max())
    assert not out[2].any()
    assert torch.equal(out[3], CV.expand(512, 6, 6))


def test_inclusion_load_steps_match_jax(ref):
    """bench.py's 3-material inclusion at 16^2: a cold step and three
    warm-started ones (du0/kes0/dst0), 1e-9 on the fields and glob_sig,
    equal CG histories (JAX's from the committed fixture)."""
    _, mt = _inclusion_meshes(16)
    _, tms, CVs = _inclusion_materials()
    st = _steps_match(ref, 'incl', mt, tms, CVs, (0.25,) * 4)
    # both plastic groups yielded
    epl = np.abs(st.epl.numpy()).sum(-1)
    ids = _inclusion_map(16).reshape(-1)
    assert (epl[ids == 0] > 0).any() and (epl[ids == 1] > 0).any()
    assert not epl[ids == 2].any()


def _svc_material():
    mat, CV, eps = convert.material_from_npz(NPZ, **T64)
    dm = jcon.DeviceMaterial(
        hill=jnp.ones(6, F64), sy=jnp.asarray(mat.sy, F64),
        khard=jnp.asarray(0., F64), drucker=jnp.asarray(0., F64),
        sv=jnp.asarray(mat.sv.numpy()), dc=jnp.asarray(mat.dc.numpy()),
        rho=jnp.asarray(mat.rho, F64), gamma=jnp.asarray(mat.gamma, F64),
        scale_seq=jnp.asarray(mat.scale_seq, F64),
        scale_wh=jnp.asarray(1., F64), feat_mean=jnp.zeros(0, F64),
        feat_scale=jnp.zeros(0, F64), tex=jnp.zeros(0, F64), is_svc=True,
        dev_only=mat.dev_only)
    return dm, mat, CV, eps


def test_inclusion_gated_solve_matches_jax(ref):
    """``solve_uniaxial`` with tuples and the convergence gate on the
    3-material inclusion (the yield excess normalized per element: sy on
    the plastic groups, the sentinel on the elastic one): fields and the
    history to 1e-9 (JAX's from the committed fixture)."""
    _, mt = _inclusion_meshes(16)
    _, tms, CVs = _inclusion_materials()
    st, ht = tfek.solve_uniaxial(mt, tms, CVs, nsteps=4, n_inner=1,
                                 dtype=torch.float64, gate=True)
    _assert_state(st, _State(ref, 'gated'), 1e-9)
    assert len(ht) == len(ref['gated.hist'])
    for a, b in zip(ht, ref['gated.hist']):
        for x, y in zip(a, b):
            assert _rel(x.numpy(), y) <= 1e-9


def test_svc_elastic_groups_match_jax(ref):
    """A two-group mesh, the trained SVC in one half and an elastic
    inclusion in the other (an SVC block of odd size): three load steps
    with their warm starts, 1e-9 and equal CG histories (JAX's from the
    committed fixture)."""
    N = 16
    _, mat, CV, eps = _svc_material()
    m_el = FE.Material(num=2)
    m_el.elasticity(E=1.e3, nu=0.27)
    dm_el = jcon.device_material_from(m_el, dtype=F64)
    tms = (mat,) + _torch_materials((dm_el,))
    CVs = (CV, np.asarray(m_el.CV, float))
    mat_map = np.zeros((N, N), dtype=int)
    mat_map[N // 2 + 1:N - 2, 3:N - 4] = 1
    mt = tfek.rect_mesh(N, N, LX=1., LY=1., uniax='y', eps_tot=eps,
                        mat_map=mat_map, **T64)
    assert mt.groups[0][1] % 2 == 1
    st = _steps_match(ref, 'svcel', mt, tms, CVs, (1. / 3.,) * 3)
    assert st.epl.abs().max() > 0


def _box_inclusion(N):
    """bench.py's 3-D inclusion: a stiff elastic cube (E = 600e3) at
    [3N/8, 5N/8)^3 in the J2 + khard 500 matrix."""
    mat = FE.Material()
    mat.elasticity(E=200.e3, nu=0.3)
    mat.plasticity(sy=150., khard=500., sdim=6)
    incl = FE.Material(num=2)
    incl.elasticity(E=600.e3, nu=0.3)
    mm = np.zeros((N, N, N), np.int32)
    lo, hi = 3 * N // 8, 5 * N // 8
    mm[lo:hi, lo:hi, lo:hi] = 1
    kw = dict(uniax='z', eps_tot=0.002, mat_map=mm)
    dms = tuple(jcon.device_material_from(m, dtype=F64) for m in (mat, incl))
    return (jfe3d.box_mesh(N, N, N, dtype=F64, **kw),
            tfe3d.box_mesh(N, N, N, **T64, **kw), dms,
            _torch_materials(dms), (np.asarray(mat.CV), np.asarray(incl.CV)))


def test_box_inclusion_solve_matches_jax(ref):
    """The 3-D inclusion at 4^3 (the port's side from
    ``workloads.box_inclusion_case``), four steps of ``solve_uniaxial3``:
    fields and the glob_sig history to 1e-9, equal CG iteration counts
    (JAX's from the committed fixture; its mesh and stiffnesses live)."""
    md, _, _, _, CVs = _box_inclusion(4)
    mt, tms, CVt = workloads.box_inclusion_case(4, torch.float64, 'cpu')
    for a, b in zip(CVs, CVt):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mt.perm.numpy(), np.asarray(md.perm))
    st, ht = tfe3d.solve_uniaxial3(mt, tms, CVs, nsteps=4, n_inner=2)
    _assert_state(st, _State(ref, 'box'), 1e-9)
    assert len(ht) == len(ref['box.iters'])
    for a, g, n in zip(ht, ref['box.glob_sig'], ref['box.iters']):
        assert _rel(a[0].numpy(), g) <= 1e-9
        assert a[2] == int(n)
    assert np.abs(ref['box.epl']).max() > 0


def test_faithful_3d_route_matches_jax(ref):
    """``load_step3(fast=False)`` with the trained SVC at 4^3: three steps
    through the yield onset, fields to 1e-9, equal CG histories (JAX's
    from the committed fixture)."""
    _, mat, CV, eps = _svc_material()
    mt = tfe3d.box_mesh(4, 4, 4, uniax='z', eps_tot=eps, **T64)
    st = tfe3d.init_state3(mt, CV, dtype=torch.float64)
    dt = None
    for k, frac in enumerate((0.5, 0.25, 0.25)):
        st, dt = tfe3d.load_step3(mt, st, mat, CV, frac, n_inner=2,
                                  fast=False,
                                  du0=None if dt is None else dt['du'])
        assert dt['cg_iters_hist'] == list(ref[f'faith{k}.hist'])
        _assert_state(st, _State(ref, f'faith{k}'), 1e-9,
                      ('u', 'sig', 'epl', 'eps'))
    assert np.abs(ref['faith2.epl']).max() > 0
