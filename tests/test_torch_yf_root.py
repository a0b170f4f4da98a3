"""PyTorch port: the yield-locus root finder of ``ml_yf_dist`` (kernel G
on the card, its plain version ``svc_yf_root_plain`` here) against the JAX
``ml_yf_dist``.

Inputs are made with numpy from a seed and handed to both.  Two SVCs: the
trained 135-SV SVC of REF_SOLVE_svc.npz with a low flow stress (sy 30 MPa
and a hardening slope of 3000 MPa, so that sflow is 30-60 MPa and roots at
105-190 MPa lie below 4 sflow, beyond it, or beyond the marching top of
5 sflow), and a small 16-SV synthetic one whose decision function is
positive at zero stress (lanes outside its patchy negative shell march
down ``MAXMARCH`` steps and find no sign change).  Each runs with
``dev_only`` False and True.  Float64 is held to 1e-12 of the distances'
scale; float32 to 1e-3 of it (the float32 tolerance of
``tests/test_torch_faithful.py``).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import jtensors as jt
from pylabfea_tpu_torch.ops import rootfind
from pylabfea_tpu_torch.ops import svc_kernels as sk

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'REF_SOLVE_svc.npz')
N = 128
#: hardening slope of the distances (MPa): sflow = sy + KHARD peeq
KHARD = 3000.


def _material(kind, dev_only, dtype):
    if kind == 'trained':
        mat, _, _ = convert.material_from_npz(NPZ, dtype=dtype, device='cpu')
        mat = dataclasses.replace(mat, sy=30.)
    else:
        # chip_smoke.synthetic_svc cut to 16 SVs, intercept 0.36: f(0) =
        # 0.026 > 0
        mat = convert.material_from_params(
            dict(chip_smoke.synthetic_svc(16), rho=0.36), is_svc=True,
            dtype=dtype, device='cpu')
    return dataclasses.replace(mat, dev_only=dev_only)


def _jax_material(mat, dtype):
    def a(v):
        return jnp.asarray(np.asarray(v), dtype)
    return jcon.DeviceMaterial(
        hill=a(mat.hill.numpy()), sy=a(mat.sy), khard=a(mat.khard),
        drucker=a(mat.drucker), sv=a(mat.sv.numpy()), dc=a(mat.dc.numpy()),
        rho=a(mat.rho), gamma=a(mat.gamma), scale_seq=a(mat.scale_seq),
        scale_wh=a(1.), feat_mean=jnp.zeros(0, dtype),
        feat_scale=jnp.zeros(0, dtype), tex=jnp.zeros(0, dtype),
        is_svc=True, dev_only=mat.dev_only)


def _states(seed=11):
    """N stresses: random directions at 20-400 MPa, four zero rows and
    four of seq < 0.01, and a plastic strain of 0-0.01."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * rng.uniform(20., 400., (N, 1))
    sig[:4] = 0.
    sig[4:8] *= 1e-5
    return sig, rng.uniform(0., 0.01, N)


def _categories(mat, sig, peeq, khard):
    """Lane masks of the branches ``ml_yf_dist`` takes: seq < 0.01, no
    sign change, a root beyond 4 sflow, and the down march cut at
    ``MAXMARCH`` steps (from the plain root finder's own pieces)."""
    sig, peeq = torch.tensor(sig), torch.tensor(peeq)
    seq = jt.seq_j2_voigt(sig)
    sflow = mat.sy + peeq * khard
    small = seq < 0.01
    su = sig / torch.where(small, 1., seq)[:, None]
    start = torch.where(su[:, 0] * su[:, 1] < -1.e-5, 0.5 * sflow, sflow)
    args = (mat.sv, mat.dc, mat.gamma, mat.rho,
            sk.FeatureMap(mat.scale_seq, dev_only=mat.dev_only))
    xs, ok = sk.svc_yf_root_plain(su, start, 5. * sflow, *args)

    def f_of(x):
        s = x[:, None] * su
        s = jt.sig_dev(s) if mat.dev_only else s
        return sk.svc_f_grad_plain(s / mat.scale_seq, mat.sv, mat.dc,
                                   mat.gamma, mat.rho, with_grad=False)[0]

    x0 = sk._march(f_of, start, 0.98, lambda x, f: (f >= 0.) & (x > 0.01))
    cut = (f_of(x0) >= 0.) & (x0 > 0.01)
    return dict(small=small, no_root=~ok & ~small,
                beyond=ok & (xs >= 4. * sflow) & ~small, maxmarch=cut & ~small)


@pytest.mark.parametrize('dev_only', [False, True], ids=['full', 'dev'])
@pytest.mark.parametrize('kind', ['trained', 'small'])
def test_ml_yf_dist_matches_jax_f64(kind, dev_only):
    mat = _material(kind, dev_only, torch.float64)
    sig, peeq = _states()
    khard = KHARD
    ref = np.asarray(jcon.ml_yf_dist(_jax_material(mat, jnp.float64),
                                     jnp.asarray(sig), jnp.asarray(peeq),
                                     khard=khard))
    out = tcon.ml_yf_dist(mat, torch.tensor(sig), torch.tensor(peeq),
                          khard=khard).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    # every branch of the root finder is taken on these lanes
    cats = _categories(mat, sig, peeq, khard)
    assert int(cats['small'].sum()) == 8
    assert int(cats['no_root'].sum()) > 0
    if kind == 'trained':
        assert int(cats['beyond'].sum()) > 0
    else:
        assert int(cats['maxmarch'].sum()) > 0


@pytest.mark.parametrize('kind', ['trained', 'small'])
def test_ml_yf_dist_matches_jax_f32(kind):
    """Float32, at the tolerance of the float32 checks of
    ``tests/test_torch_faithful.py`` (1e-3 of the scale).  Brent's stopping
    test (xtol 1e-5) lies below the float32 spacing at roots above ~80 MPa,
    so such a lane converges only where f hits 0 exactly and otherwise
    falls back to seq - 0.85 sflow: which of the two a lane takes turns on
    the last bit of f, and the two frameworks sum f in different orders.
    So every lane either agrees or parts on that branch (one side's
    distance is the fallback), and at least 3/4 agree (``chip_smoke.py``
    phase 4's rule)."""
    mat = _material(kind, False, torch.float32)
    sig, peeq = _states(12)
    sig32, peeq32 = sig.astype(np.float32), peeq.astype(np.float32)
    ref = np.asarray(jcon.ml_yf_dist(_jax_material(mat, jnp.float32),
                                     jnp.asarray(sig32), jnp.asarray(peeq32),
                                     khard=KHARD))
    out = tcon.ml_yf_dist(mat, torch.tensor(sig32), torch.tensor(peeq32),
                          khard=KHARD)
    assert out.dtype == torch.float32
    out = out.numpy()
    tol = 1e-3 * np.abs(ref).max()
    seq = jt.seq_j2_voigt(torch.tensor(sig32)).numpy()
    fallback = seq - 0.85 * (mat.sy + peeq32 * KHARD)
    agree = np.abs(out - ref) <= tol
    parts = (np.abs(out - fallback) <= tol) | (np.abs(ref - fallback) <= tol)
    assert (agree | parts).all()
    assert agree.sum() >= 0.75 * N


def test_plain_root_finder_has_no_kernel_launches():
    """On the CPU ``svc_yf_root`` takes its plain version (no launch of G
    or F) and refuses the evaluation counter, which only the kernel
    fills."""
    mat = _material('small', False, torch.float64)
    sig, peeq = _states()
    def counts():
        return (sk.svc_yf_root.launches, sk.svc_decision.launches,
                rootfind.brent_step.launches)

    before = counts()
    su = torch.nn.functional.normalize(torch.tensor(sig[8:]), dim=-1)
    start = torch.full((N - 8,), 150., dtype=torch.float64)
    args = (su, start, 5. * start, mat.sv, mat.dc, mat.gamma, mat.rho,
            sk.FeatureMap(mat.scale_seq))
    xs, ok = sk.svc_yf_root(*args)
    xp, okp = sk.svc_yf_root_plain(*args)
    assert torch.equal(xs, xp) and torch.equal(ok, okp)
    assert counts() == before
    with pytest.raises(ValueError):
        sk.svc_yf_root(*args, evals=torch.zeros(N - 8, dtype=torch.int32))
