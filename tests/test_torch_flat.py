"""PyTorch port: the flat (grid=None) FE layout against the JAX reference in
float64 on a flattened 6 x 6 mesh: the element operators, Jacobi-CG with
its iteration count, the flat ``solve_linear`` and ``refine_du_flat``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import fe_kernels as jfek
from pylabfea_tpu.ops import femu as jfemu
from pylabfea_tpu_torch.ops import fe_kernels as tfek
from pylabfea_tpu_torch.ops import femu as tfemu

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

N = 6
#: CG tolerance: above the f64 rounding floor of Jacobi-CG on this system
#: (about 1e-11 relative), where the residual histories of the two
#: packages part by rounding and an exit can fall one iteration apart
TOL = 1e-10
BC = dict(left={0: ('disp', 0.)}, bot={1: ('disp', 0.)},
          right={0: ('force', 40.)}, top={1: ('disp', 0.003)})


def _cv(E=200.e3, nu=0.3):
    hh = E / ((1 + nu) * (1 - 2 * nu))
    CV = np.zeros((6, 6))
    CV[:3, :3] = nu * hh
    np.fill_diagonal(CV[:3, :3], (1 - nu) * hh)
    CV[3, 3] = CV[4, 4] = CV[5, 5] = (0.5 - nu) * hh
    return CV


def _elstiff(seed=0):
    """A non-uniform SPD tangent field (Nel, 6, 6): the elastic CV scaled
    per element, minus a rank-one secant downdate."""
    rng = np.random.default_rng(seed)
    CV = _cv()
    w = rng.normal(size=(N * N, 6)) * 3e4
    s = rng.uniform(0.5, 1.5, (N * N, 1, 1))
    return s * CV[None] - 0.3 * w[:, :, None] * w[:, None, :] / np.einsum(
        'ei,ij,ej->e', w, np.linalg.inv(CV), w)[:, None, None]


def _meshes():
    kw = dict(LX=1., LY=1.5, bc=BC)
    mj = jfemu.flatten_mesh(jfek.rect_mesh(N, N, dtype=jnp.float64, **kw))
    mt = tfemu.flatten_mesh(tfek.rect_mesh(N, N, dtype=torch.float64,
                                           device='cpu', **kw))
    return mj, mt


@pytest.fixture(scope='module')
def ref():
    """The JAX reference on the flattened mesh (its meshes built fresh)."""
    mj, _ = _meshes()
    els = jnp.asarray(_elstiff())
    Ke = jfek.element_stiffness(mj, els)
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.normal(size=mj.ndof))
    out = dict(Ke=Ke, v=v, kv=jfek.k_apply(mj, Ke, v), kd=jfek.k_diag(mj, Ke),
               deps=jfek.element_deps(mj, v),
               sc=jfek.scatter_element(mj, jfek.gather_element(mj, v)))
    start = jnp.where(mj.fixed, mj.fixed_val, 0.)
    rhs = jnp.where(mj.fixed, mj.fixed_val, mj.force - jfek.scatter_element(
        mj, jnp.einsum('eij,ej->ei', Ke, jfek.gather_element(mj, start))))
    out['rhs'], out['start'] = rhs, start
    out['cg'] = jfek.cg_solve(lambda x: jfek.k_apply(mj, Ke, x), rhs, start,
                              jfek.k_diag(mj, Ke), tol=TOL, maxiter=600)
    out['solve'] = jfek.solve_linear(mj, els, mj.fixed_val, mj.force,
                                     cg_tol=TOL, cg_maxiter=600)
    # a warm start as a load step's next round sees one: a nearby increment
    x0 = 0.9 * out['solve'][0]
    out['solve_x0'] = jfek.solve_linear(mj, els, mj.fixed_val, mj.force,
                                        cg_tol=TOL, cg_maxiter=600, x0=x0)
    out['x0'] = x0
    du = out['solve'][0] * (1. + 1e-4 * jnp.asarray(rng.normal(
        size=mj.ndof)))
    out['du'] = du
    out['refined'] = jfek.refine_du_flat(mj, els, du, mj.fixed_val, mj.force,
                                         TOL, 600, n=2)
    return {k: (tuple(np.array(a) for a in v) if isinstance(v, tuple)
                else np.array(v)) for k, v in out.items()}


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def test_flat_mesh_is_the_raveled_grid():
    mj, mt = _meshes()
    assert mt.grid is None and mt.fixed.shape == (mt.ndof,)
    np.testing.assert_array_equal(mt.dofs.numpy(), np.asarray(mj.dofs))
    for k in ('fixed', 'fixed_val', 'force'):
        np.testing.assert_array_equal(getattr(mt, k).numpy(),
                                      np.asarray(getattr(mj, k)))


def test_flat_operators_match_jax(ref):
    _, mt = _meshes()
    els = torch.as_tensor(_elstiff())
    Ke = tfek.element_stiffness(mt, els)
    v = torch.as_tensor(ref['v'])
    _close(Ke, ref['Ke'], 1e-13)
    _close(tfek.k_apply(mt, Ke, v), ref['kv'], 1e-13)
    _close(tfek.k_diag(mt, Ke), ref['kd'], 1e-13)
    _close(tfek.element_deps(mt, v), ref['deps'], 1e-13)
    _close(tfek.scatter_element(mt, tfek.gather_element(mt, v)), ref['sc'],
           1e-13)


def test_per_element_B_matches_the_shared_one():
    """The bar path's per-element (Nel, ngp, 6, n) B with (Nel,) jacw gives
    the shared-B element stiffness when every element carries the same
    tables."""
    _, mt = _meshes()
    els = torch.as_tensor(_elstiff(1))
    Ke = tfek.element_stiffness(mt, els)
    per = dataclasses.replace(
        mt, B=mt.B.expand(mt.nel, *mt.B.shape).contiguous(),
        jacw=mt.jacw.expand(mt.nel).contiguous())
    _close(tfek.element_stiffness(per, els), Ke, 1e-14)


def test_cg_solve_matches_jax_with_equal_iterations(ref):
    _, mt = _meshes()
    Ke = tfek.element_stiffness(mt, torch.as_tensor(_elstiff()))
    x, res, it = tfek.cg_solve(lambda q: tfek.k_apply(mt, Ke, q),
                               torch.as_tensor(ref['rhs']),
                               torch.as_tensor(ref['start']),
                               tfek.k_diag(mt, Ke), tol=TOL, maxiter=600)
    xj, resj, itj = ref['cg']
    assert it == int(itj) and it > 10
    _close(x, xj, 1e-10)
    assert res <= TOL


@pytest.mark.parametrize('warm', [False, True])
def test_solve_linear_flat_matches_jax(ref, warm):
    _, mt = _meshes()
    els = torch.as_tensor(_elstiff())
    x0 = torch.as_tensor(ref['x0']) if warm else None
    du, res, it = tfek.solve_linear(mt, els, mt.fixed_val, mt.force,
                                    cg_tol=TOL, cg_maxiter=600, x0=x0)
    duj, resj, itj = ref['solve_x0' if warm else 'solve']
    assert it == int(itj)
    _close(du, duj, 1e-10)
    assert float(res) <= TOL


def test_refine_du_flat_matches_jax(ref):
    _, mt = _meshes()
    els = torch.as_tensor(_elstiff())
    out = tfek.refine_du_flat(mt, els, torch.as_tensor(ref['du']),
                              mt.fixed_val, mt.force, TOL, 600, n=2)
    _close(out, ref['refined'], 1e-10)
    # the refined increment solves the system far better than its input
    r0 = tfek._residual_f64_flat(mt, els, torch.as_tensor(ref['du']),
                                 mt.force).abs().max()
    r2 = tfek._residual_f64_flat(mt, els, out, mt.force).abs().max()
    assert float(r2) < 1e-6 * float(r0)
