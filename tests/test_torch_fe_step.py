"""PyTorch port: mesh, multigrid hierarchy and the split load step against
the JAX reference at 32 x 32 in float64 with the trained SVC of
REF_SOLVE_svc.npz.  Every JAX mesh is built fresh with ``rect_mesh`` (its
coarse-mesh chain cache would serve a stale mesh for ``_replace`` copies).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import fe_kernels as jfek
from pylabfea_tpu.ops import multigrid as jmg
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import fe_kernels as tfek
from pylabfea_tpu_torch.ops import multigrid as tmg

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'REF_SOLVE_svc.npz')
N = 32
F64 = jnp.float64


def _materials():
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=torch.float64,
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
    return dm, mat, CV, eps


def _meshes(eps, **kw):
    return (jfek.rect_mesh(N, N, LX=1., LY=1., eps_tot=eps, dtype=F64, **kw),
            tfek.rect_mesh(N, N, LX=1., LY=1., eps_tot=eps,
                           dtype=torch.float64, device='cpu', **kw))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _assert_state(st, sj, rtol):
    for f in ('u', 'sig', 'epl', 'eps', 'elstiff'):
        assert _rel(getattr(st, f).numpy(), getattr(sj, f)) <= rtol, f


@pytest.mark.parametrize('kw', [dict(uniax='y'), dict(uniax='xy', eps_x=-1e-3,
                                                        eps_y=2e-3),
                                dict(bc={'left': {0: ('disp', 0.)},
                                         'bot': {1: ('disp', 0.)},
                                         'top': {1: ('force', 40.)},
                                         'nodes': [(2, 3, 0, 'disp', 0.)]})])
def test_rect_mesh_fields_match_jax(kw):
    md, mt = _meshes(0.002, **kw)
    for f in ('B', 'Bsum', 'jacw', 'vel', 'fixed', 'fixed_val', 'force'):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(md, f)), err_msg=f)
    assert (mt.ndof, mt.nel, mt.grid) == (md.ndof, md.nel, md.grid)
    ma = convert.mesh_from_arrays(
        {f: np.asarray(getattr(md, f)) for f in md._fields[:-4]}, md.grid,
        md.ndof, md.nel, md.groups, dtype=torch.float64, device='cpu')
    for f in ('B', 'fixed', 'fixed_val', 'force'):
        assert torch.equal(getattr(ma, f), getattr(mt, f))


def test_hierarchy_matches_jax():
    """Galerkin hierarchy planes and the dense bottom inverse, 1e-10."""
    _, _, CV, eps = _materials()
    md, mt = _meshes(eps)
    rng = np.random.default_rng(0)
    els = CV.reshape(36, 1, 1) * rng.uniform(0.5, 1.5, (1, N, N))
    kj = jmg.hierarchy_kes(jmg.build_hierarchy(md, jnp.asarray(els)))
    kt = tmg.hierarchy_kes(tmg.build_hierarchy(mt, torch.tensor(els)))
    assert len(kt) == len(kj) == 4      # 32, 16, 8 + bottom inverse
    for a, b in zip(kt, kj):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) <= 1e-10
    chain = tmg.mesh_chain(mt)
    jchain = jmg._mesh_chain(md)
    for a, b in zip(chain, jchain):
        np.testing.assert_array_equal(a.fixed.numpy(), np.asarray(b.fixed))


def test_odd_coarsest_level_matches_jax():
    """An 18 x 18 grid coarsens once, to 9 x 9, whose odd element count
    ends the chain: the hierarchy and an MG-CG solve match JAX's (the
    port built a restriction pair for that level too, which needs even
    counts, and raised)."""
    _, _, CV, _ = _materials()
    kw = dict(LX=1., LY=1., eps_tot=0.002)
    md = jfek.rect_mesh(18, 18, dtype=F64, **kw)
    mt = tfek.rect_mesh(18, 18, dtype=torch.float64, device='cpu', **kw)
    els = CV.reshape(36, 1, 1) * np.random.default_rng(1).uniform(
        0.5, 1.5, (1, 18, 18))
    kt = tfek._hier_kes(mt, torch.tensor(els))
    kj = jfek._hier_kes_jit(md, jnp.asarray(els))
    # 18^2 and 9^2 planes, then the dense inverse of the 9^2 level
    assert [tuple(k.shape) for k in kt] == [tuple(k.shape) for k in kj] \
        == [(8, 8, 18, 18), (8, 8, 9, 9), (200, 200)]
    for a, b in zip(kt, kj):
        assert _rel(a.numpy(), b) <= 1e-10
    du, _, _ = tfek._mg_solve(mt, kt, mt.fixed_val, torch.zeros_like(
        mt.fixed_val), 1e-11, 100, torch.zeros_like(mt.fixed_val))
    duj, _, _ = jfek.solve_linear(md, jnp.asarray(els), md.fixed_val)
    assert _rel(du.numpy(), duj) <= 1e-9


def test_load_steps_match_jax():
    """A cold step and two warm-started steps (du0/kes0/dst0): u, sig, epl,
    elstiff to 1e-9 relative and identical CG iteration histories."""
    dm, mat, CV, eps = _materials()
    md, mt = _meshes(eps)
    sj = jfek.init_state(md, CV, dtype=F64)
    st = tfek.init_state(mt, CV, dtype=torch.float64)
    dj = dt = None
    plastic = False
    for _ in range(3):
        warm_j = {} if dj is None else dict(
            du0=dj['du'], kes0=dj['kes'], dst0=dj['dstiff'])
        warm_t = {} if dt is None else dict(
            du0=dt['du'], kes0=dt['kes'], dst0=dt['dstiff'])
        sj, dj = jfek.load_step_split(md, sj, dm, CV, 0.25, n_inner=2,
                                      **warm_j)
        st, dt = tfek.load_step_split(mt, st, mat, CV, 0.25, n_inner=2,
                                      **warm_t)
        assert dt['cg_iters_hist'] == [int(x) for x in dj['cg_iters_hist']]
        _assert_state(st, sj, 1e-9)
        assert _rel(dt['glob_sig'].numpy(), dj['glob_sig']) <= 1e-9
        assert dt['cg_res'] <= 1e-11
        plastic = plastic or bool(np.asarray(sj.epl).any())
    assert plastic


def test_step_from_converted_state_matches_jax():
    """A JAX state carried over with convert.state_from_arrays continues
    like the JAX step (cold start, two elastic-to-plastic steps)."""
    dm, mat, CV, eps = _materials()
    md, mt = _meshes(eps)
    sj = jfek.init_state(md, CV, dtype=F64)
    sj, _ = jfek.load_step_split(md, sj, dm, CV, 0.5, n_inner=2)
    st = convert.state_from_arrays(
        {f: np.asarray(getattr(sj, f)) for f in sj._fields},
        dtype=torch.float64, device='cpu')
    sj, dj = jfek.load_step_split(md, sj, dm, CV, 0.5, n_inner=2)
    st, dt = tfek.load_step_split(mt, st, mat, CV, 0.5, n_inner=2)
    assert dt['cg_iters_hist'] == [int(x) for x in dj['cg_iters_hist']]
    _assert_state(st, sj, 1e-9)


def test_solve_uniaxial_matches_jax():
    dm, mat, CV, eps = _materials()
    md, mt = _meshes(eps)
    sj, hj = jfek.solve_uniaxial(md, dm, CV, nsteps=4, n_inner=2,
                                 dtype=F64)
    st, ht = tfek.solve_uniaxial(mt, mat, CV, nsteps=4, n_inner=2,
                                 dtype=torch.float64)
    _assert_state(st, sj, 1e-9)
    for a, b in zip(ht, hj):
        for x, y in zip(a, b):
            assert _rel(x.numpy(), y) <= 1e-9


def test_unported_options_raise():
    """What stays unported of the 2-D step raises: SVC feature widths
    that the JAX device path does not serve (its cylindrical, stress,
    work-hardening and texture layouts are ported); plane stress without
    its reduced stiffness is refused as in the JAX package."""
    with np.load(NPZ) as z:
        params = dict(hill=np.ones(6), sy=float(z['sy']), khard=0.,
                      drucker=0., sv=np.zeros((3, 7)), dc=np.zeros(3),
                      rho=0., gamma=1., scale_seq=float(z['scale_seq']))
    for nf in (1, 7, 14):
        with pytest.raises(NotImplementedError, match=f'got Ndof={nf}'):
            convert.material_from_params(dict(params, sv=np.zeros((3, nf))),
                                         is_svc=True, device='cpu')
    with pytest.raises(ValueError):
        tfek.rect_mesh(4, 4, planestress=True, device='cpu')
