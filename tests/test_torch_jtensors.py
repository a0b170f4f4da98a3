"""PyTorch port: the closed-form principal-stress helpers of ``jtensors``
and the sdim=3 (principal-space) analytic criterion against the JAX
reference in float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pylabfea_tpu as FE
from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import jtensors as jjt
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import jtensors as tjt

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

RTOL = 1e-10
F64 = jnp.float64


def _voigt(S):
    """(N, 3, 3) symmetric tensors -> (N, 6) Voigt rows."""
    return np.stack([S[:, 0, 0], S[:, 1, 1], S[:, 2, 2], S[:, 1, 2],
                     S[:, 0, 2], S[:, 0, 1]], axis=-1)


def _states(kind, n=200, seed=0):
    """Stress rows (n, 6) of one kind, scale ~100 MPa, from a seed."""
    rng = np.random.default_rng(seed)
    if kind == 'random':
        return rng.normal(size=(n, 6)) * 100.
    out = np.zeros((n, 6))
    if kind == 'spherical':
        out[:, 0:3] = rng.normal(size=(n, 1)) * 100.
    elif kind == 'uniaxial':
        out[np.arange(n), rng.integers(0, 3, n)] = rng.normal(size=n) * 100.
    elif kind == 'coaxial':
        out[:, 0:3] = rng.normal(size=(n, 3)) * 100.
    elif kind in ('rotated', 'rotated_degenerate'):
        Q = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
        w = rng.normal(size=(n, 3)) * 100.
        if kind == 'rotated':
            # keep the eigenvalues apart: the eigenvectors are then
            # well defined and the axis assignment is decided by them
            w = np.sort(w, axis=1) + np.array([-40., 0., 40.])
        else:
            w[:, 1] = w[:, 0]
        out = _voigt(np.einsum('nij,nj,nkj->nik', Q, w, Q))
    return out


def _close(a, b, rtol=RTOL):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0.,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize('kind', ['random', 'spherical', 'uniaxial',
                                  'coaxial', 'rotated'])
def test_principal_stresses_match_jax(kind):
    sig = _states(kind)
    sj, st = jnp.asarray(sig), torch.tensor(sig)
    _close(tjt.voigt_to_tensor(st).numpy(), jjt.voigt_to_tensor(sj), 0.)
    wj, vj = jjt._eigh_sym3_closed(jjt.voigt_to_tensor(sj))
    wt, vt = tjt._eigh_sym3_closed(tjt.voigt_to_tensor(st))
    _close(wt.numpy(), wj)
    _close(vt.numpy(), vj)
    np.testing.assert_array_equal(
        tjt._axis_choice(vt).numpy(),
        np.argmax(np.asarray(jjt._axis_onehot(vj, F64)), axis=-1))
    spj = jjt.sig_princ_vals(sj)
    _close(tjt.sig_princ_vals(st).numpy(), spj)
    for a, b in zip(tjt.sig_princ_device(st), jjt.sig_princ_device(sj)):
        _close(a.numpy(), b)
    spt = torch.tensor(np.asarray(spj))
    _close(tjt.seq_j2_princ(spt).numpy(), jjt.seq_j2_princ(spj))
    # the polar angle is periodic: +pi and -pi (a signed zero apart in the
    # deviatoric b component) are one direction
    d = tjt.polar_ang_princ(spt).numpy() - np.asarray(jjt.polar_ang_princ(spj))
    assert np.abs((d + np.pi) % (2. * np.pi) - np.pi).max() <= RTOL * np.pi


def test_degenerate_rotated_invariants_match_jax():
    """Two equal eigenvalues in a rotated frame: the eigenvectors of the
    pair are ill-defined in both implementations (the identity frame or
    rounding decides), and Cardano's arccos turns rounding of r near 1
    into 1e-8 splits of the pair; the invariants agree."""
    sig = _states('rotated_degenerate')
    spj = np.asarray(jjt.sig_princ_vals(jnp.asarray(sig)))
    spt = tjt.sig_princ_vals(torch.tensor(sig))
    _close(tjt.seq_j2_princ(spt).numpy(), jjt.seq_j2_princ(spj))
    _close(spt.sum(-1).numpy(), spj.sum(-1))
    _close(tjt.seq_j2_princ(spt).numpy(), jjt.seq_j2_voigt(sig))


def _sdim3_material(hill):
    m = FE.Material()
    m.elasticity(E=200.e3, nu=0.3)
    m.plasticity(sy=150., khard=500., sdim=3, hill=hill)
    dm = jcon.device_material_from(m, dtype=F64)
    assert dm.sdim3
    tm = convert.materials_from_params(
        [{k: v if isinstance(v, bool) else np.asarray(v)
          for k, v in dm._asdict().items()}], dtype=torch.float64,
        device='cpu')[0]
    assert tm.sdim3
    return dm, tm, np.asarray(m.CV)


@pytest.mark.parametrize('hill', [None, [0.7, 1., 1.4]])
def test_sdim3_criterion_and_return_map_match_jax(hill):
    """seq, the principal-space gradient (zero shear slots) and the fast
    return map of sdim=3 J2 and 3-parameter Hill at 1e-10."""
    dm, tm, CV = _sdim3_material(hill)
    rng = np.random.default_rng(3)
    N = 256
    u = rng.normal(size=(N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * 150. * rng.uniform(0.5, 1.0, (N, 1))
    peeq = rng.uniform(0., 1e-3, N)
    deps = rng.normal(0., 2e-4, (N, 6))
    sj, st = jnp.asarray(sig), torch.tensor(sig)
    _close(tcon.seq_hill(tm, st).numpy(), jcon.seq_hill(dm, sj))
    gt = tcon.fgrad(tm, st).numpy()
    _close(gt, jcon.fgrad(dm, sj))
    assert not gt[:, 3:].any()
    for a, b in zip(tcon.yf_and_fgrad(tm, st, torch.tensor(peeq)),
                    jcon.yf_and_fgrad(dm, sj, jnp.asarray(peeq))):
        _close(torch.as_tensor(a).numpy(), b)
    out_j = jcon.response_fast(dm, (sj, jnp.zeros_like(sj)),
                               jnp.asarray(deps), jnp.asarray(CV), 12, 4)
    out_t = tcon.response_fast(tm, (st, torch.zeros_like(st)),
                               torch.tensor(deps), torch.tensor(CV), 12, 4)
    plastic = np.abs(np.asarray(out_j[2])).sum(-1) > 0
    assert 20 < plastic.sum() < N
    for a, b in zip(out_t, out_j):
        _close(a.numpy(), b)


def test_sqrt_rn_is_correctly_rounded():
    """The eigensolver's square root is numpy's correctly rounded one, bit
    for bit, over magnitudes from 1e-260 to 1e260 (the card's
    ``torch.sqrt`` is too; PyTorch's CPU one may be an ulp off)."""
    rng = np.random.default_rng(6)
    x = np.concatenate([np.abs(rng.normal(size=100_000)),
                        np.exp(rng.uniform(-600., 600., 100_000)),
                        [0., 1., 2., 4., 0.25]])
    np.testing.assert_array_equal(tjt._sqrt_rn(torch.tensor(x)).numpy(),
                                  np.sqrt(x))
