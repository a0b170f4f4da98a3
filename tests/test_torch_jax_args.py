"""PyTorch port: the arguments of the JAX functions that the port once
fixed as module constants (``load_step_split(max_inner,
gate_dst_rtol)``, ``ml_yf_dist(maxmarch)``, ``response(maxit)``,
``response_chunked(maxit)``, ``solve_uniaxial(split)``), each against
JAX, and the Chebyshev smoother of the 2-D multigrid
(``multigrid.SMOOTHER``).  The gated float32 steps and the solves under
both smoothers are held against JAX's results committed in
``pylabfea_tpu_torch/data/ref_jax_args.npz``
(``tools/make_torch_ref_fixtures.py jax_args``), the rest live."""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pylabfea_tpu as FE
from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import fe_kernels as tfek
from pylabfea_tpu_torch.ops import multigrid as tmg

# One torch thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, 'REF_SOLVE_svc.npz')
REF = os.path.join(ROOT, 'pylabfea_tpu_torch', 'data', 'ref_jax_args.npz')
F32, F64 = jnp.float32, jnp.float64
T = dict(device='cpu')


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope='module')
def ref():
    """JAX's results of ``tools/make_torch_ref_fixtures.py jax_args``."""
    with np.load(REF) as z:
        return {k: z[k] for k in z.files}


def _j2(dtype, khard=5000.):
    """J2 + linear hardening as JAX's DeviceMaterial and the port's (from
    its leaves)."""
    m = FE.Material()
    m.elasticity(E=200.e3, nu=0.3)
    m.plasticity(sy=150., khard=khard, sdim=6)
    dm = jcon.device_material_from(m, dtype=dtype)
    tm = convert.materials_from_params(
        [{k: v if isinstance(v, bool) else np.asarray(v)
          for k, v in dm._asdict().items()}],
        dtype=getattr(torch, np.dtype(dtype).name), **T)[0]
    return dm, tm, np.asarray(m.CV, float)


def _svc(dtype):
    tm, CV, _ = convert.material_from_npz(
        NPZ, dtype=getattr(torch, np.dtype(dtype).name), **T)
    f = lambda a: jnp.asarray(np.asarray(a, float), dtype)  # noqa: E731
    dm = jcon.DeviceMaterial(
        hill=f(np.ones(6)), sy=f(tm.sy), khard=f(0.), drucker=f(0.),
        sv=f(tm.sv.numpy()), dc=f(tm.dc.numpy()), rho=f(tm.rho),
        gamma=f(tm.gamma), scale_seq=f(tm.scale_seq), scale_wh=f(1.),
        feat_mean=f(np.zeros(0)), feat_scale=f(np.zeros(0)),
        tex=f(np.zeros(0)), is_svc=True, dev_only=tm.dev_only)
    return dm, tm, CV


def test_gate_warns_at_max_inner():
    """The twin of tests/test_device.py's non-convergence warning: a load
    step 20 yield strains wide with ``max_inner=3`` runs 4 rounds and
    warns, naming the argument."""
    _, tm, CV = _svc(F32)
    md = tfek.rect_mesh(8, 8, uniax='y', eps_tot=0.01, **T)
    st = tfek.init_state(md, CV, dtype=torch.float32)
    with pytest.warns(UserWarning, match='no convergence.*max_inner=3'):
        _, d = tfek.load_step_split(md, st, tm, CV, 1., n_inner=1, nsub=4,
                                    gate=True, max_inner=3)
    assert len(d['cg_iters_hist']) == 4


@pytest.mark.parametrize('rtol', [1e-4, 0.])
def test_gate_dst_rtol_rounds_match_jax(ref, rtol):
    """A gated float32 step (16 x 16, J2 + khard 5000, half the load):
    the relative tangent test (default) exits after 7 rounds, the absolute
    one (``gate_dst_rtol=0``) runs the full ``max_inner=8`` budget; the
    port's rounds equal JAX's (from the committed fixture)."""
    _, tm, CV = _j2(F32)
    mt = tfek.rect_mesh(16, 16, eps_tot=0.002, dtype=torch.float32, **T)
    kw = dict(n_inner=1, gate=True, max_inner=8, gate_dst_rtol=rtol)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        _, dt = tfek.load_step_split(
            mt, tfek.init_state(mt, CV, dtype=torch.float32), tm, CV, 0.5,
            **kw)
    assert len(dt['cg_iters_hist']) == len(ref[f'gate.{rtol}.hist']) \
        == (7 if rtol else 9)
    assert _rel(dt['glob_sig'].numpy(), ref[f'gate.{rtol}.glob_sig']) \
        <= 1e-3


def test_ml_yf_dist_maxmarch_matches_jax():
    """``maxmarch=5`` cuts the bracket marching short: lanes whose root
    lies beyond 5 steps take the fallback, in the port as in JAX
    (float64, 1e-9 of the scale); the default finds more roots."""
    dm, tm, _ = _svc(F64)
    rng = np.random.default_rng(4)
    u = rng.normal(size=(64, 6))
    sig = u / np.linalg.norm(u, axis=1, keepdims=True) \
        * rng.uniform(20., 400., (64, 1))
    peeq = np.zeros(64)
    dj = np.asarray(jcon.ml_yf_dist(dm, jnp.asarray(sig), jnp.asarray(peeq),
                                    maxmarch=5))
    dt = tcon.ml_yf_dist(tm, torch.as_tensor(sig), torch.as_tensor(peeq),
                         maxmarch=5).numpy()
    full = tcon.ml_yf_dist(tm, torch.as_tensor(sig),
                           torch.as_tensor(peeq)).numpy()
    assert _rel(dt, dj) <= 1e-9
    assert (np.abs(dt - full) > 1e-6).sum() > 8


def test_response_maxit_matches_jax():
    """The faithful return map with ``maxit=10`` substeps (float64): the
    port's ``response`` and ``response_chunked`` within 1e-10 of JAX's, and
    apart from the default 50."""
    dm, tm, CV = _svc(F64)
    rng = np.random.default_rng(2)
    u = rng.normal(size=(32, 6))
    sig = u / np.linalg.norm(u, axis=1, keepdims=True) \
        * rng.uniform(60., 140., (32, 1))
    epl = np.zeros((32, 6))
    deps = rng.normal(0., 1.5e-3, (32, 6))
    ref = jcon.response(dm, (jnp.asarray(sig), jnp.asarray(epl)),
                        jnp.asarray(deps), jnp.asarray(CV), maxit=10)
    args = ((torch.as_tensor(sig), torch.as_tensor(epl)),
            torch.as_tensor(deps), torch.as_tensor(CV))
    out = tcon.response(tm, *args, maxit=10)
    chunked = tcon.response_chunked(tm, *args, maxit=10, chunk=20)
    for a, c, b in zip(out, chunked, ref):
        assert _rel(a.numpy(), b) <= 1e-10
        assert _rel(c.numpy(), b) <= 1e-10
    assert _rel(tcon.response(tm, *args)[1].numpy(), ref[1]) > 1e-8


def test_solve_uniaxial_split_false_raises():
    """``split=False`` names JAX's monolithic ``load_step``, which the port
    leaves out; ``split=True`` is the default."""
    _, tm, CV = _j2(F64)
    md = tfek.rect_mesh(4, 4, eps_tot=0.002, dtype=torch.float64, **T)
    with pytest.raises(NotImplementedError, match='monolithic load_step'):
        tfek.solve_uniaxial(md, tm, CV, nsteps=1, split=False)
    _, hist = tfek.solve_uniaxial(md, tm, CV, nsteps=1, split=True,
                                  dtype=torch.float64)
    assert np.isfinite(hist[0][0].numpy()).all()


def test_chebyshev_smoother_matches_jax(ref):
    """The twin of tests/test_utils.py's smoother test at 32 x 32 in
    float64: under both smoothers the solve reaches res < 1e-10 in JAX's
    CG iteration count, and the Chebyshev levels' lambda_max(D^-1 K)
    estimates agree within 1e-10 (JAX's from the committed fixture)."""
    CV = convert.elastic_cv(200.e3, 0.3)
    mt = tfek.rect_mesh(32, 32, uniax='y', eps_tot=0.001,
                        dtype=torch.float64, **T)
    elt = torch.as_tensor(np.broadcast_to(CV.reshape(36, 1, 1),
                                          (36, 32, 32)).copy())
    zero = torch.zeros_like(mt.fixed_val)
    iters = {}
    try:
        for sm in ('jacobi', 'chebyshev'):
            tmg.SMOOTHER = sm
            _, rt, it = tfek._mg_solve(mt, tfek._hier_kes(mt, elt),
                                       mt.fixed_val, zero, 1e-10, 100, zero)
            assert rt < 1e-10 and float(ref[f'smoother.{sm}.res']) < 1e-10
            assert it == int(ref[f'smoother.{sm}.iters']), sm
            iters[sm] = it
            if sm == 'chebyshev':
                lj = ref['smoother.lmax']
                lt = [float(lv.lmax) for lv in tmg.build_hierarchy(mt, elt)]
                assert len(lt) == len(lj)
                assert np.allclose(lt, lj, rtol=1e-10, atol=0.)
    finally:
        tmg.SMOOTHER = 'jacobi'
    assert iters['chebyshev'] <= iters['jacobi'] + 2
