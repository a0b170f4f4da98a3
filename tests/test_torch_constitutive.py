"""PyTorch port: tensor helpers and the cutting-plane return map against
the JAX reference in float64, with the trained SVC of REF_SOLVE_svc.npz."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops import jtensors as jjt
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import jtensors as tjt

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'REF_SOLVE_svc.npz')
SY = 150.


def _materials():
    """The trained SVC as JAX and torch DeviceMaterials (f64) and CV."""
    mat, CV, _ = convert.material_from_npz(NPZ, dtype=torch.float64,
                                           device='cpu')
    f64 = jnp.float64
    dm = jcon.DeviceMaterial(
        hill=jnp.ones(6, f64), sy=jnp.asarray(mat.sy, f64),
        khard=jnp.asarray(0., f64), drucker=jnp.asarray(0., f64),
        sv=jnp.asarray(mat.sv.numpy()), dc=jnp.asarray(mat.dc.numpy()),
        rho=jnp.asarray(mat.rho, f64), gamma=jnp.asarray(mat.gamma, f64),
        scale_seq=jnp.asarray(mat.scale_seq, f64),
        scale_wh=jnp.asarray(1., f64), feat_mean=jnp.zeros(0, f64),
        feat_scale=jnp.zeros(0, f64), tex=jnp.zeros(0, f64), is_svc=True,
        dev_only=mat.dev_only)
    return dm, mat, CV


def _states(N, seed=1):
    """Stress states near the yield locus and strain increments that drive
    plastic flow (the bench.py return-map workload)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * SY * rng.uniform(0.55, 0.95, (N, 1))
    deps = rng.normal(0., 1.0e-4, (N, 6))
    return sig, np.zeros((N, 6)), deps


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def test_tensor_helpers_match_jax_f64():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 6)) * 80.
    x[0] = 0.
    for name in ('seq_j2_voigt', 'sig_dev', 'eps_eq'):
        _close(getattr(tjt, name)(torch.tensor(x)),
               getattr(jjt, name)(jnp.asarray(x)), 1e-15)
    _close(tjt.sig_dev(torch.tensor(x[:, :3])), jjt.sig_dev(jnp.asarray(
        x[:, :3])), 1e-15)
    v = np.abs(x[:, 0]) - 40.
    _close(tjt.safe_sqrt(torch.tensor(v)), jjt.safe_sqrt(jnp.asarray(v)), 0.)


def test_flow_stress_and_hard_modulus_match_jax_f64():
    dm, mat, _ = _materials()
    kw = dict(khard=100., voce_r=30., voce_b=50.)
    dm = dm._replace(**{k: jnp.asarray(v) for k, v in kw.items()})
    mat = tcon.DeviceMaterial(**{**mat.__dict__, **kw})
    peeq = np.linspace(0., 0.05, 40)
    for name in ('flow_stress', 'hard_modulus'):
        _close(getattr(tcon, name)(mat, torch.tensor(peeq)),
               getattr(jcon, name)(dm, jnp.asarray(peeq)), 1e-14)


@pytest.mark.parametrize('full3', [True, False])
def test_small_inverses_match_jax_f64(full3):
    _, _, CV = _materials()
    CV = CV.copy()
    if not full3:           # plane-stress reduced stiffness: empty row 2
        CV[2, :] = CV[:, 2] = 0.
    for name in ('_inv6x6_spd', '_compliance'):
        _close(getattr(tcon, name)(torch.tensor(CV)),
               getattr(jcon, name)(jnp.asarray(CV)), 1e-12)


@pytest.mark.parametrize('nsub', [1, 4])
def test_response_fast_matches_jax_f64(nsub):
    """N=512 states, trained SVC: sig, depl, f and tangent to 1e-9
    relative, and the same set of plastic lanes."""
    dm, mat, CV = _materials()
    sig, epl, deps = _states(512)
    fj, sj, dj, gj = jcon.response_fast(
        dm, (jnp.asarray(sig), jnp.asarray(epl)), jnp.asarray(deps),
        jnp.asarray(CV), 12, nsub)
    ft, st, dt, gt = tcon.response_fast(
        mat, (torch.tensor(sig), torch.tensor(epl)), torch.tensor(deps),
        torch.tensor(CV), 12, nsub)
    plastic_j = np.abs(np.asarray(dj)).sum(-1) > 0
    plastic_t = dt.abs().sum(-1).numpy() > 0
    assert plastic_j.sum() > 20
    np.testing.assert_array_equal(plastic_t, plastic_j)
    for a, b in ((ft, fj), (st, sj), (dt, dj), (gt, gj)):
        _close(a.numpy(), b, 1e-9)


def test_response_fast_chunked_equals_unchunked():
    """Lanes are independent: chunking changes no result."""
    _, mat, CV = _materials()
    sig, epl, deps = _states(300, seed=2)
    args = (mat, (torch.tensor(sig), torch.tensor(epl)), torch.tensor(deps),
            torch.tensor(CV), 12, 2)
    whole = tcon.response_fast(*args)
    parts = tcon.response_fast_chunked(*args, chunk=128)
    for a, b in zip(parts, whole):
        _close(a.numpy(), b.numpy(), 1e-12)
