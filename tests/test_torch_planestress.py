"""PyTorch port: plane-stress meshes against the JAX reference in float64:
one material (the eps_33 condensation folded into B) and the reference's
5-section laminate (per-element condensation rows ``ps_b2``), including
the laminate carried across from a host model's JAX mesh.  Every JAX mesh
is built fresh (its coarse-mesh chain cache would serve a stale mesh for
``_replace`` copies)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pylabfea_tpu as FE
from pylabfea_tpu import bridge
from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import fe_kernels as jfek
from pylabfea_tpu_torch import convert, workloads
from pylabfea_tpu_torch.ops import fe_kernels as tfek

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

F64 = jnp.float64
T64 = dict(dtype=torch.float64, device='cpu')
#: the laminate (reference tests/test_basic.py:84-103): sections of widths
#: 2, 1, 2, 1, 2 alternating E = 100e3 / 300e3, nu = 0.35 / 0.3
WIDTHS = (2., 1., 2., 1., 2.)
LAM = ((100.e3, 0.35), (300.e3, 0.3))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _laminate_map(NX, NY):
    """Material id (0, 1, 0, 1, 0) of each element's section."""
    xc = (np.arange(NX) + 0.5) * sum(WIDTHS) / NX
    sec = np.searchsorted(np.cumsum(WIDTHS), xc)
    return np.repeat((sec % 2)[:, None], NY, axis=1)


def _laminate_kw(NX, NY):
    """rect_mesh arguments of the laminate: left and bottom fixed, right
    face force-free, top displaced 0.1 LY."""
    return dict(LX=sum(WIDTHS), LY=4., mat_map=_laminate_map(NX, NY),
                planestress=True,
                ps_CV=tuple(convert.elastic_cv(E, nu, True) for E, nu in LAM),
                ps_E=tuple(E for E, _ in LAM), ps_nu=tuple(n for _, n in LAM),
                bc=dict(left={0: ('disp', 0.)}, bot={1: ('disp', 0.)},
                        right={0: ('force', 0.)}, top={1: ('disp', 0.4)}))


def _j2_planestress():
    """J2 + hardening in plane stress: the host material, its JAX and
    torch DeviceMaterials and the reduced CV."""
    m = FE.Material()
    m.elasticity(E=200.e3, nu=0.3)
    m.plasticity(sy=150., khard=2000., sdim=6)
    dm = jcon.device_material_from(m, dtype=F64)
    tm = convert.material_from_params(
        {k: np.asarray(v) for k, v in dm._asdict().items()
         if k not in ('is_svc', 'dev_only', 'sdim3')}, is_svc=False, **T64)
    return dm, tm, convert.elastic_cv(200.e3, 0.3, True)


def _j2_kw(CV):
    """Plane stress, bottom and left rollers, the top pulled to 0.4 %
    strain and one interior node pinned in x, so the field is not
    homogeneous."""
    return dict(LX=1., LY=1.5, planestress=True, ps_CV=CV, ps_E=200.e3,
                ps_nu=0.3, bc=dict(left={0: ('disp', 0.)},
                                   bot={1: ('disp', 0.)},
                                   top={1: ('disp', 0.006)},
                                   nodes=[(5, 7, 0, 'disp', 0.)]))


@pytest.mark.parametrize('case', ['single', 'laminate'])
def test_planestress_mesh_fields_bitwise(case):
    if case == 'single':
        kw = _j2_kw(_j2_planestress()[2])
        NX, NY = 12, 9
    else:
        NX, NY = 24, 8
        kw = _laminate_kw(NX, NY)
    md = jfek.rect_mesh(NX, NY, dtype=F64, **kw)
    mt = tfek.rect_mesh(NX, NY, **T64, **kw)
    fields = ['B', 'Bsum', 'jacw', 'vel', 'fixed', 'fixed_val', 'force']
    if case == 'laminate':
        fields += ['ps_b2', 'perm', 'inv_perm']
        assert mt.groups == md.groups
        assert not mt.B[:, 2].any()
    else:
        assert mt.ps_b2 is None and mt.groups is None and mt.B[:, 2].any()
    for f in fields:
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(md, f)), err_msg=f)
    # the refinement's float64 operator comes from the B the mesh uses
    np.testing.assert_array_equal(mt.M64.numpy(), jfek._m64_of(md))


def test_planestress_j2_steps_match_jax():
    """One-material plane-stress J2 at 16 x 16: a cold step and two
    warm-started plastic ones, then ``solve_uniaxial``; 1e-9 on the
    fields and glob_sig, equal CG histories."""
    dm, tm, CV = _j2_planestress()
    md = jfek.rect_mesh(16, 16, dtype=F64, **_j2_kw(CV))
    mt = tfek.rect_mesh(16, 16, **T64, **_j2_kw(CV))
    sj = jfek.init_state(md, CV, dtype=F64)
    st = tfek.init_state(mt, CV, dtype=torch.float64)
    dj = dt = None
    for _ in range(3):
        warm_j = {} if dj is None else dict(
            du0=dj['du'], kes0=dj['kes'], dst0=dj['dstiff'])
        warm_t = {} if dt is None else dict(
            du0=dt['du'], kes0=dt['kes'], dst0=dt['dstiff'])
        sj, dj = jfek.load_step_split(md, sj, dm, CV, 0.35, n_inner=2,
                                      **warm_j)
        st, dt = tfek.load_step_split(mt, st, tm, CV, 0.35, n_inner=2,
                                      **warm_t)
        assert dt['cg_iters_hist'] == [int(x) for x in dj['cg_iters_hist']]
        for f in ('u', 'sig', 'epl', 'eps'):
            assert _rel(getattr(st, f).numpy(), getattr(sj, f)) <= 1e-9, f
        assert _rel(dt['glob_sig'].numpy(), dj['glob_sig']) <= 1e-9
    # plane stress: no thickness stress, a thickness strain, plastic flow
    assert np.abs(np.asarray(sj.sig)[:, 2]).max() == 0.
    assert np.abs(np.asarray(sj.eps)[:, 2]).max() > 1e-4
    assert np.abs(np.asarray(sj.epl)).max() > 0.
    md = jfek.rect_mesh(16, 16, dtype=F64, **_j2_kw(CV))
    sj, hj = jfek.solve_uniaxial(md, dm, CV, nsteps=2, n_inner=1,
                                 dtype=F64)
    st, ht = tfek.solve_uniaxial(mt, tm, CV, nsteps=2, n_inner=1,
                                 dtype=torch.float64)
    for f in ('u', 'sig', 'epl'):
        assert _rel(getattr(st, f).numpy(), getattr(sj, f)) <= 1e-9, f
    for a, b in zip(ht, hj):
        for x, y in zip(a, b):
            assert _rel(x.numpy(), y) <= 1e-9


def _host_laminate(NX, NY):
    """The laminate as a meshed host Model (plane stress, 5 sections)."""
    fe = FE.Model(dim=2, planestress=True)
    fe.geom(list(WIDTHS), LY=4.)
    m1, m2 = FE.Material(), FE.Material()
    m1.elasticity(E=LAM[0][0], nu=LAM[0][1])
    m2.elasticity(E=LAM[1][0], nu=LAM[1][1])
    fe.assign([m1, m2, m1, m2, m1])
    fe.bcleft(0.)
    fe.bcbot(0.)
    fe.bcright(0., 'force')
    fe.bctop(0.1 * fe.leny, 'disp')
    fe.mesh(NX=NX, NY=NY)
    return fe


def test_laminate_matches_jax_and_voigt():
    """The laminate at 32 x 16 from the port's own constructors
    (``workloads.laminate_case``: mesh, ``elastic_material``,
    ``elastic_cv``) against the JAX mesh that the bridge builds from the
    host model: the same mesh fields and stiffnesses, glob_sig and the
    thickness strains to 1e-9, E_yy at the Voigt average."""
    NX, NY = 32, 16
    md, dms, CVs = bridge.to_device(_host_laminate(NX, NY), dtype=F64)
    mt, tms, CVt = workloads.laminate_case(NX, NY, torch.float64, 'cpu')
    for f in ('B', 'fixed', 'fixed_val', 'force', 'ps_b2', 'perm'):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(md, f)), err_msg=f)
    for a, b in zip(CVs, CVt):
        np.testing.assert_array_equal(a, b)
    sj, hj = jfek.solve_uniaxial(md, dms, CVs, nsteps=1, n_inner=1,
                                 dtype=F64, cg_tol=1e-13)
    st, ht = tfek.solve_uniaxial(mt, tms, CVs, nsteps=1, n_inner=1,
                                 dtype=torch.float64, cg_tol=1e-13)
    for f in ('u', 'sig', 'eps'):
        assert _rel(getattr(st, f).numpy(), getattr(sj, f)) <= 1e-9, f
    gs, ge = ht[-1][0].numpy(), ht[-1][1].numpy()
    assert _rel(gs, hj[-1][0]) <= 1e-9
    assert abs(gs[1] / ge[1] - workloads.LAM_VOIGT) / workloads.LAM_VOIGT \
        < 1e-3
    assert np.abs(st.eps[:, 2].numpy()).max() > 1e-3
    assert not st.epl.any()


def test_converted_laminate_steps_like_the_port_constructors():
    """A JAX multi-material plane-stress mesh and its tuple of materials,
    passed across as numpy arrays (``mesh_from_arrays``,
    ``materials_from_params``), give the step of the port's own
    constructors bit for bit, and the JAX step to 1e-9."""
    NX, NY = 24, 8
    kw = _laminate_kw(NX, NY)
    md = jfek.rect_mesh(NX, NY, dtype=F64, **kw)
    dms = tuple(jcon.device_material_from(_elastic_host(E, nu), dtype=F64)
                for E, nu in LAM)
    mc = convert.mesh_from_arrays(
        {f: np.asarray(getattr(md, f)) for f in md._fields[:-4]}, md.grid,
        md.ndof, md.nel, md.groups, **T64)
    tmc = convert.materials_from_params(
        [{k: v if isinstance(v, bool) else np.asarray(v)
          for k, v in dm._asdict().items()} for dm in dms], **T64)
    mt = tfek.rect_mesh(NX, NY, **T64, **kw)
    tmt = (convert.elastic_material(**T64),) * 2
    for a, b in zip(tmc, tmt):
        for k, v in a.__dict__.items():
            w = getattr(b, k)
            assert torch.equal(v, w) if torch.is_tensor(v) else v == w, k
    CVs = kw['ps_CV']
    sj, dj = jfek.load_step_split(md, jfek.init_state(md, CVs, dtype=F64),
                                  dms, CVs, 0.5, n_inner=1)
    outs = []
    for mesh, mats in ((mc, tmc), (mt, tmt)):
        st, dt = tfek.load_step_split(
            mesh, tfek.init_state(mesh, CVs, dtype=torch.float64), mats,
            CVs, 0.5, n_inner=1)
        assert dt['cg_iters_hist'] == [int(x) for x in dj['cg_iters_hist']]
        for f in ('u', 'sig', 'eps'):
            assert _rel(getattr(st, f).numpy(), getattr(sj, f)) <= 1e-9, f
        outs.append(st)
    for f in ('u', 'sig', 'eps', 'elstiff'):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f


def _elastic_host(E, nu):
    m = FE.Material()
    m.elasticity(E=E, nu=nu)
    return m
