"""PyTorch port, kernel B: the structured-grid stiffness apply.

The port's plain version (what the kernel wrapper runs on CPU tensors) is
held against the TPU kernel ``k_apply_stencil`` in interpret mode and the
JAX plane formulation (f32, the tolerance of ``tests/test_stencil.py``),
and the BC-masked operator and diagonal against JAX in f64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import fe_kernels as jfek
from pylabfea_tpu.ops.stencil_pallas import k_apply_stencil
from pylabfea_tpu_torch.ops import fe_kernels as tfek
from pylabfea_tpu_torch.ops import stencil

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rtol * np.abs(b).max())


@pytest.mark.parametrize('NX,NY,TX', [(16, 16, 8), (32, 16, 16),
                                      (16, 32, 8)])
def test_plain_k_apply_matches_pallas_and_planes_f32(NX, NY, TX):
    rng = np.random.default_rng(0)
    md = jfek.rect_mesh(NX, NY, LX=1., LY=1.5, uniax='y', eps_tot=0.002,
                        dtype=jnp.float32)
    els = jnp.asarray(rng.uniform(0.5, 2.0, (36, NX, NY)) * 1e5,
                      jnp.float32)
    Kp = jfek.element_stiffness_planes(md, els)
    u = [rng.normal(size=(NX + 1, NY + 1)).astype(np.float32)
         for _ in range(2)]
    pallas = k_apply_stencil(Kp, jnp.asarray(u[0]), jnp.asarray(u[1]),
                             TX=TX, interpret=True)
    planes = jfek._scatter_planes(md, jfek._contract_planes(
        Kp, jfek._gather_planes(md, (jnp.asarray(u[0]),
                                     jnp.asarray(u[1])))))
    out = stencil.k_apply(torch.tensor(np.asarray(Kp)),
                          torch.tensor(u[0]), torch.tensor(u[1]))
    for o, p, q in zip(out, pallas, planes):
        _close(o.numpy(), p, 2e-6)
        _close(o.numpy(), q, 2e-6)


def _meshes(NX, NY):
    bc = {'left': {0: ('disp', 0.)}, 'bot': {1: ('disp', 0.)},
          'right': {0: ('disp', 0.003)}, 'top': {1: ('force', 25.)},
          'nodes': [(3, 2, 1, 'disp', -0.001), (5, 5, 0, 'force', 4.)]}
    md = jfek.rect_mesh(NX, NY, LX=1., LY=0.8, bc=bc, dtype=jnp.float64)
    mt = tfek.rect_mesh(NX, NY, LX=1., LY=0.8, bc=bc, dtype=torch.float64,
                        device='cpu')
    return md, mt


def test_element_stiffness_planes_match_jax_f64():
    NX, NY = 12, 10
    md, mt = _meshes(NX, NY)
    els = np.random.default_rng(1).uniform(0.5, 2.0, (36, NX, NY)) * 1e5
    _close(tfek.element_stiffness_planes(mt, torch.tensor(els)),
           jfek.element_stiffness_planes(md, jnp.asarray(els)), 1e-13)
    rows = els.reshape(36, -1).T.reshape(-1, 6, 6)
    _close(tfek.elstiff_planes(mt, torch.tensor(rows)), els, 0.)


def test_masked_apply_and_diagonal_match_jax_f64():
    """k_apply_t / k_diag_t with displacement and force BCs, 1e-12."""
    NX, NY = 12, 10
    md, mt = _meshes(NX, NY)
    rng = np.random.default_rng(2)
    els = rng.uniform(0.5, 2.0, (36, NX, NY)) * 1e5
    Kj = jfek.element_stiffness_planes(md, jnp.asarray(els))
    Kt = torch.tensor(np.asarray(Kj))
    v = rng.normal(size=(2, NX + 1, NY + 1))
    fixed = np.asarray(md.fixed)
    assert fixed.sum() > 0
    oj = jfek.k_apply_t(md, Kj, jfek._split(jnp.asarray(v)),
                        jfek._split(md.fixed))
    ot = tfek.k_apply_t(mt, Kt, tfek._split(torch.tensor(v)),
                        tfek._split(mt.fixed))
    dj = jfek.k_diag_t(md, Kj, jfek._split(md.fixed))
    dt = tfek.k_diag_t(mt, Kt, tfek._split(mt.fixed))
    for a, b in zip(ot + dt, oj + dj):
        _close(a.numpy(), b, 1e-12)


def test_element_strain_increments_match_jax_f64():
    NX, NY = 12, 10
    md, mt = _meshes(NX, NY)
    du = np.random.default_rng(3).normal(size=(2, NX + 1, NY + 1)) * 1e-3
    _close(tfek.element_deps(mt, torch.tensor(du)),
           jfek.element_deps(md, jnp.asarray(du)), 1e-13)
