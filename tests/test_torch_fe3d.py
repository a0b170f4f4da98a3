"""PyTorch port: the 3-D hex8 solver (mesh, operators, multigrid, load
step) and the analytic return map against the JAX reference in float64.
Every JAX mesh is built fresh with ``box_mesh`` (its coarse-mesh chain cache
would serve a stale mesh for ``_replace`` copies).

The meshes, operators, transfers and the return map run live in JAX; the
16^3 hierarchy and MG-CG solve, the 8^3 load steps and the 2^3 uniaxial
history are held against JAX's results committed in
``pylabfea_tpu_torch/data/ref_fe3d.npz``
(``tools/make_torch_ref_fixtures.py fe3d``)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pylabfea_tpu as FE
from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import fe3d as jfe3d
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import fe3d as tfe3d

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

F64 = jnp.float64
T64 = dict(dtype=torch.float64, device='cpu')
REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pylabfea_tpu_torch', 'data', 'ref_fe3d.npz')
E, NU, SY, KH = 200.e3, 0.3, 150., 500.
BC = dict(xlo={0: ('disp', 0.)}, ylo={1: ('disp', 0.)},
          zlo={2: ('disp', 0.)}, zhi={2: ('force', 120.)},
          nodes=[(1, 2, 0, 0, 'disp', 0.), (2, 1, 3, 1, 'force', 5.)])


def _j2():
    """J2 + linear hardening (the bench.py 3-D material) as JAX and torch
    DeviceMaterials, and its elastic stiffness."""
    m = FE.Material()
    m.elasticity(E=E, nu=NU)
    m.plasticity(sy=SY, khard=KH, sdim=6)
    dm = jcon.device_material_from(m, dtype=F64)
    return dm, _torch_material(dm), np.asarray(m.CV)


def _torch_material(dm):
    params = {k: np.asarray(v) for k, v in dm._asdict().items()
              if k not in ('is_svc', 'dev_only', 'sdim3')}
    return convert.material_from_params(params, is_svc=dm.is_svc,
                                        dev_only=dm.dev_only, **T64)


def _meshes(N=8, **kw):
    kw = dict(uniax='z', eps_tot=0.002, **kw)
    return (jfe3d.box_mesh(N, N, N, dtype=F64, **kw),
            tfe3d.box_mesh(N, N, N, **T64, **kw))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _tangents(CV, N, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(CV).reshape(36, 1, 1, 1) \
        * rng.uniform(0.5, 1.5, (1, N, N, N))


def _vols(md, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=np.shape(md.fixed))


def _assert_state(st, sj, rtol):
    for f in ('u', 'sig', 'epl', 'eps', 'elstiff'):
        assert _rel(getattr(st, f).numpy(), getattr(sj, f)) <= rtol, f


@pytest.fixture(scope='module')
def ref():
    """JAX's results of ``tools/make_torch_ref_fixtures.py fe3d``."""
    with np.load(REF) as z:
        return {k: z[k] for k in z.files}


def _ref_state(ref, tag):
    return tfe3d.SolverState3(**{f: ref[f'{tag}.{f}'] for f in
                                 ('u', 'sig', 'epl', 'eps', 'elstiff')})


@pytest.mark.parametrize('kw', [dict(), dict(LX=2., LY=1.5, bc=BC)])
def test_box_mesh_fields_bitwise(kw):
    md, mt = _meshes(3, **kw)
    for f in ('B', 'Bsum', 'jacw', 'vel', 'fixed', 'fixed_val', 'force'):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(md, f)), err_msg=f)
    assert (mt.ndof, mt.nel, mt.grid) == (md.ndof, md.nel, md.grid)
    ma = convert.mesh3_from_arrays(
        {f: np.asarray(getattr(md, f)) for f in md._fields[:-4]}, md.grid,
        md.ndof, md.nel, md.groups, **T64)
    for f in ('B', 'fixed', 'fixed_val', 'force'):
        assert torch.equal(getattr(ma, f), getattr(mt, f))


def test_operators_and_transfers_match_jax():
    """k_diag3_t, element_deps3, the coarse masks, coarsen_C and the
    transfers, f64 1e-12."""
    _, _, CV = _j2()
    md, mt = _meshes(8)
    els = _tangents(CV, 8)
    fj, ft = jfe3d._split3(md.fixed), tfe3d._split3(mt.fixed)
    for a, b in zip(tfe3d.k_diag3_t(mt, torch.tensor(els), ft),
                    jfe3d.k_diag3_t(md, jnp.asarray(els), fj)):
        assert _rel(a.numpy(), b) <= 1e-12
    du = _vols(md)
    assert _rel(tfe3d.element_deps3(mt, torch.tensor(du)).numpy(),
                jfe3d.element_deps3(md, jnp.asarray(du))) <= 1e-12
    for a, b in zip(tfe3d.mesh_chain3(mt), jfe3d._mesh_chain3(md, 4)):
        np.testing.assert_array_equal(a.fixed.numpy(), np.asarray(b.fixed))
        assert a.grid == b.grid
    assert _rel(tfe3d.coarsen_C(torch.tensor(els)).numpy(),
                jfe3d.coarsen_C(jnp.asarray(els))) <= 1e-12
    W = tfe3d._transfer_mats3(mt)
    v = tuple(torch.tensor(x) for x in du)
    rt, rj = tfe3d.restrict3(v, W), jfe3d.restrict3(tuple(map(jnp.asarray,
                                                              du)))
    for a, b in zip(rt, rj):
        assert _rel(a.numpy(), b) <= 1e-12
    for a, b in zip(tfe3d.prolong3(rt, W), jfe3d.prolong3(rj, 9, 9, 9)):
        assert _rel(a.numpy(), b) <= 1e-12


def test_hierarchy_matches_jax(ref):
    """Levels 16, 8, 4 with a dense bottom: diagonals, lambda_max and the
    bottom inverse, 1e-10 (JAX's from the committed fixture)."""
    _, _, CV = _j2()
    _, mt = _meshes(16)
    els = _tangents(CV, 16)
    np.testing.assert_array_equal(els, ref['hier.els'])
    lt = tfe3d.build_hierarchy3(mt, torch.tensor(els))
    assert [lv.md.grid[0] for lv in lt] == [16, 8, 4]
    assert len(lt) == int(ref['hier.nlev'])
    for i, a in enumerate(lt):
        assert _rel(torch.stack(a.diag).numpy(), ref[f'hier.{i}.diag']) \
            <= 1e-10
        assert _rel(a.lmax.numpy(), ref[f'hier.{i}.lmax']) <= 1e-10
    assert lt[-1].kc_inv is not None
    assert _rel(lt[-1].kc_inv.numpy(), ref['hier.kc_inv']) <= 1e-10


def test_mg_cg_solve_matches_jax(ref):
    """Elastic MG-CG solve at 16^3: solution 1e-10, same iteration count
    (JAX's from the committed fixture)."""
    _, _, CV = _j2()
    _, mt = _meshes(16)
    Cp = torch.tensor(np.broadcast_to(np.asarray(CV).reshape(36, 1, 1, 1),
                                      (36, 16, 16, 16)).copy())
    fixT, bcT = tfe3d._split3(mt.fixed), tfe3d._split3(mt.fixed_val)
    du_bc = tuple(torch.where(f, b, 0.) for f, b in zip(fixT, bcT))
    neg = tfe3d._k_apply3_raw(mt, Cp, du_bc)
    rhs = tuple(torch.where(f, b, -q) for f, b, q in zip(fixT, bcT, neg))
    x, r, it = tfe3d.mg_cg_solve3(tfe3d.build_hierarchy3(mt, Cp), rhs, du_bc,
                                  tol=1e-10)
    assert it == int(ref['mgcg.iters']) and r <= 1e-10
    assert _rel(torch.stack(x).numpy(), ref['mgcg.x']) <= 1e-10


def test_load_steps_match_jax(ref):
    """A cold 0.4 step and a warm 0.3 step (du0) at 8^3, J2 + hardening:
    state to 1e-9 and identical CG iteration histories (JAX's from the
    committed fixture)."""
    _, mat, CV = _j2()
    _, mt = _meshes(8)
    st = tfe3d.init_state3(mt, CV, dtype=torch.float64)
    dt = None
    for k, frac in enumerate((0.4, 0.3)):
        st, dt = tfe3d.load_step3(mt, st, mat, CV, frac, n_inner=2,
                                  du0=None if dt is None else dt['du'])
        assert dt['cg_iters_hist'] == list(ref[f'step{k}.hist'])
        _assert_state(st, _ref_state(ref, f'step{k}'), 1e-9)
        assert _rel(dt['glob_sig'].numpy(), ref[f'step{k}.glob_sig']) <= 1e-9
    assert ref['step1.epl'].any()


def test_step_from_converted_state_matches_jax(ref):
    """A JAX state carried over with convert.state3_from_arrays continues
    like the JAX step."""
    _, mat, CV = _j2()
    _, mt = _meshes(8)
    st = convert.state3_from_arrays(
        {f: ref[f'step0.{f}'] for f in ('u', 'sig', 'epl', 'eps',
                                          'elstiff')}, **T64)
    du0 = torch.tensor(ref['step0.du'])
    st, dt = tfe3d.load_step3(mt, st, mat, CV, 0.3, n_inner=2, du0=du0)
    assert dt['cg_iters_hist'] == list(ref['step1.hist'])
    _assert_state(st, _ref_state(ref, 'step1'), 1e-9)


def test_solve_uniaxial_closed_form_and_jax(ref):
    """2^3 box, 8 steps: the J2 + linear hardening uniaxial closed form
    sig = (sy + khard eps) E / (E + khard), a homogeneous field, and the
    JAX history (from the committed fixture)."""
    _, mat, CV = _j2()
    _, mt = _meshes(2)
    st, ht = tfe3d.solve_uniaxial3(mt, mat, CV, nsteps=8, n_inner=2)
    gs = ht[-1][0].numpy()
    np.testing.assert_allclose(gs[2], (SY + KH * 0.002) * E / (E + KH),
                               rtol=1e-6)
    sig = st.sig.numpy()
    assert np.abs(sig - sig.mean(0)).max() < 1e-8
    _assert_state(st, _ref_state(ref, 'uni'), 1e-9)
    assert len(ht) == len(ref['uni.iters'])
    for (gt, et, it), gj, ej, ij in zip(ht, ref['uni.glob_sig'],
                                        ref['uni.glob_eps'],
                                        ref['uni.iters']):
        assert _rel(gt.numpy(), gj) <= 1e-9 and _rel(et.numpy(), ej) <= 1e-9
        assert it == int(ij)


@pytest.mark.parametrize('kind', ['j2_hardening', 'hill_drucker', 'voce'])
def test_analytic_response_fast_matches_jax(kind):
    """The analytic return map on random states near and beyond the yield
    locus, with prior plastic strain, nsub=4: f, sig, depl, tangent 1e-10,
    the same plastic lanes; yf/fgrad alongside."""
    dm, _, CV = _j2()
    if kind == 'hill_drucker':
        dm = dm._replace(hill=jnp.asarray([1.1, 0.9, 1., 1.2, 0.8, 1.05]),
                         drucker=jnp.asarray(0.2, F64))
    elif kind == 'voce':
        dm = dm._replace(voce_r=jnp.asarray(40., F64),
                         voce_b=jnp.asarray(80., F64))
    mat = _torch_material(dm)
    rng = np.random.default_rng(11)
    N = 400
    d = rng.normal(size=(N, 6))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sig = d * SY * rng.uniform(0.4, 1.0, (N, 1))
    epl = rng.normal(0., 2e-3, (N, 6))
    epl[:, 2] = -epl[:, 0] - epl[:, 1]
    deps = rng.normal(0., 4e-4, (N, 6))
    peeq = np.asarray(jcon.jt.eps_eq(jnp.asarray(epl)))
    targs = (mat, torch.tensor(sig), torch.tensor(peeq))
    jargs = (dm, jnp.asarray(sig), jnp.asarray(peeq))
    assert _rel(tcon.yf(*targs).numpy(), jcon.yf(*jargs)) <= 1e-12
    for a, b in zip(tcon.yf_and_fgrad(*targs), jcon.yf_and_fgrad(*jargs)):
        assert _rel(np.asarray(a), b) <= 1e-12
    assert _rel(tcon.fgrad(*targs[:2]).numpy(),
                jcon.fgrad(*jargs[:2])) <= 1e-12
    out_j = jcon.response_fast(dm, (jnp.asarray(sig), jnp.asarray(epl)),
                               jnp.asarray(deps), jnp.asarray(CV), 12, 4)
    out_t = tcon.response_fast(mat, (torch.tensor(sig), torch.tensor(epl)),
                               torch.tensor(deps), torch.tensor(CV), 12, 4)
    plastic_j = np.abs(np.asarray(out_j[2])).sum(-1) > 0
    assert 50 < plastic_j.sum() < N
    np.testing.assert_array_equal(out_t[2].abs().sum(-1).numpy() > 0,
                                  plastic_j)
    for a, b in zip(out_t, out_j):
        assert _rel(a.numpy(), b) <= 1e-10


def test_analytic_material_from_its_own_leaves():
    """hill, sy, khard and drucker alone give the material that the JAX
    ``device_material_from`` leaves (with their dummy SVC leaves) give."""
    _, mat, _ = _j2()
    mini = convert.material_from_params(
        dict(hill=np.ones(6), sy=SY, khard=KH, drucker=0.), is_svc=False,
        **T64)
    for k, v in mat.__dict__.items():
        w = getattr(mini, k)
        assert torch.equal(v, w) if torch.is_tensor(v) else v == w, k


def test_unported_options_raise():
    """What stays unported of the 3-D path raises: Tresca (no analytic
    flow gradient) and SVC feature widths that the JAX device path does
    not serve (its 2, 6, 15, 6 + tdim and 15 + tdim are ported)."""
    dm, mat, CV = _j2()
    params = {k: np.asarray(v) for k, v in dm._asdict().items()
              if k not in ('is_svc', 'dev_only', 'sdim3')}
    with pytest.raises(NotImplementedError):
        convert.material_from_params(dict(params, tresca=True),
                                     is_svc=False, **T64)
    with pytest.raises(NotImplementedError, match='got Ndof=7'):
        convert.material_from_params(dict(params, sv=np.zeros((3, 7)),
                                          dc=np.zeros(3)), is_svc=True,
                                     **T64)
