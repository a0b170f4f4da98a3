"""PyTorch port: the SVC feature layouts beyond 6-D stress against the JAX
package, in float64 on the CPU (the plain versions of kernels A, D, E and
G), with the trained fixtures of ``pylabfea_tpu_torch/data`` (made by
``tools/make_torch_svc_fixtures.py``; no training here):

* ``svc_cyl``: cylindrical sdim=3 features (2), from Voigt and from
  principal stresses;
* ``svc_wh``: stress + work hardening (15), with the batch-mean khard;
* ``svc_tex_gsh3``: texture-conditioned, GSH_3 descriptors (6 + 3);
* ``svc_tex_adv``: PCA-whitened ADV_12 descriptors (6 + 10).

Both sides get the same leaves and inputs made with numpy from a seed.
The yield functions, their gradients and distances, the chunked
work-hardening map and the plain kernels run live in JAX; the return maps
and the uniaxial solves are held against JAX's results committed in
``pylabfea_tpu_torch/data/ref_layouts.npz``
(``tools/make_torch_ref_fixtures.py layouts``).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import constitutive as jcon
from pylabfea_tpu.ops.pallas_kernels import (svc_decision_pallas,
                                             svc_f_grad_pallas,
                                             svc_f_grad_pallas_mxu)
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import constitutive as tcon
from pylabfea_tpu_torch.ops import fe_kernels as tfek
from pylabfea_tpu_torch.ops import svc_kernels as sk

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pylabfea_tpu_torch', 'data')
REF = os.path.join(DATA, 'ref_layouts.npz')
F64 = jnp.float64
FLAGS = ('is_svc', 'dev_only', 'sdim3')


def _materials(name):
    """(JAX DeviceMaterial, port DeviceMaterial, CV, eps) of a fixture, in
    float64."""
    path = os.path.join(DATA, name + '.npz')
    mat, CV, eps = convert.material_from_npz(path, dtype=torch.float64,
                                             device='cpu')
    with np.load(path) as z:
        dm = jcon.DeviceMaterial(
            **{k: jnp.asarray(z[k], F64) for k in jcon.DeviceMaterial._fields
               if k not in FLAGS},
            **{k: bool(z[k]) for k in FLAGS})
    return dm, mat, CV, eps


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope='module')
def ref():
    """JAX's results of ``tools/make_torch_ref_fixtures.py layouts``."""
    with np.load(REF) as z:
        return {k: z[k] for k in z.files}


def _close(a, b, rtol):
    """a and b NaN on the same lanes, elsewhere within rtol of max|b|."""
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, equal_nan=True,
                               atol=rtol * np.abs(b[np.isfinite(b)]).max())


#: (fixture, stress rows): cylindrical from Voigt and principal stresses
CASES = [('svc_cyl', 6), ('svc_cyl', 3), ('svc_wh', 6), ('svc_tex_gsh3', 6),
         ('svc_tex_adv', 6)]


@pytest.mark.parametrize('name,rows', CASES)
def test_yield_function_gradient_and_distance_match_jax(name, rows):
    """yf, fgrad and yf_and_fgrad (its khard included) within 1e-10
    relative; the yield-locus distance within 1e-8 (the JAX package's own
    bound against the host); with work hardening a plastic strain, and the
    masked batch-mean khard."""
    dm, mat, _, _ = _materials(name)
    rng = np.random.default_rng(3)
    n = 24
    sig = rng.normal(0., 80., (n, rows))
    epl = rng.normal(0., 2e-3, (n, 6)) if rows == 6 else None
    peeq = rng.uniform(0., 0.01, n)
    j = [jnp.asarray(sig), jnp.asarray(peeq),
         None if epl is None else jnp.asarray(epl)]
    t = [torch.tensor(sig), torch.tensor(peeq),
         None if epl is None else torch.tensor(epl)]
    fj, gj, kj = jcon.yf_and_fgrad(dm, *j)
    ft, gt, kt = tcon.yf_and_fgrad(mat, *t)
    assert _rel(ft, fj) <= 1e-10 and _rel(gt, gj) <= 1e-10
    assert abs(float(kt) - float(kj)) <= 1e-10 * max(abs(float(kj)), 1.)
    assert _rel(tcon.yf(mat, *t), jcon.yf(dm, *j)) <= 1e-10
    assert _rel(tcon.fgrad(mat, t[0], t[2]), jcon.fgrad(dm, j[0], j[2])) \
        <= 1e-10
    dj = np.asarray(jcon.ml_yf_dist(dm, *j))
    dt = tcon.ml_yf_dist(mat, *t).numpy()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-8)
    if name == 'svc_wh':
        assert float(kj) > 0.
        mask = rng.uniform(size=n) < 0.5
        g = tcon.svc_gradient(mat, tcon._features(mat, t[0], t[2]))
        kmj = jcon.khard_of(dm, jnp.asarray(g.numpy()), jnp.asarray(mask))
        kmt = tcon.khard_of(mat, g, torch.tensor(mask))
        assert abs(float(kmt) - float(kmj)) <= 1e-10 * abs(float(kmj))


def _return_map_inputs(mat, n=40, seed=5):
    """Stresses at 0.5-0.95 sy in random directions, plastic strains of
    1e-3 and strain increments of 1.5e-4 (small: ``response_fast``'s
    iterates part chaotically at large ones)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * mat.sy * rng.uniform(0.5, 0.95, (n, 1))
    return sig, rng.normal(0., 1e-3, (n, 6)), rng.normal(0., 1.5e-4, (n, 6))


@pytest.mark.parametrize('fn', ['response_fast', 'response'])
@pytest.mark.parametrize('name', ['svc_cyl', 'svc_wh', 'svc_tex_gsh3',
                                  'svc_tex_adv'])
def test_return_maps_match_jax(ref, name, fn):
    """The fast and the reference-faithful return map, every output within
    1e-9 relative, with plastic lanes (JAX's from the committed
    fixture)."""
    _, mat, CV, _ = _materials(name)
    sig, epl, deps = _return_map_inputs(mat)
    np.testing.assert_array_equal(np.stack([sig, epl, deps]),
                                  ref[f'rm.{name}.inputs'])
    extra = (12, 1) if fn == 'response_fast' else ()
    oj = [ref[f'rm.{name}.{fn}.{i}'] for i in range(4)]
    ot = getattr(tcon, fn)(mat, (torch.tensor(sig), torch.tensor(epl)),
                           torch.tensor(deps), torch.tensor(CV), *extra)
    assert len(ot) == len(oj)
    for a, b in zip(ot, oj):
        _close(a.numpy(), b, 1e-9)
    assert (np.abs(oj[2]).sum(-1) > 0).sum() >= 5


def test_work_hardening_chunks_as_jax():
    """With work hardening a lane's result depends on the lanes of its
    chunk (the batch-mean khard): 150 lanes in chunks of 64, the last one
    zero-padded as the JAX package pads it, within 1e-9 relative; one
    batch of 150 gives another result."""
    dm, mat, CV, _ = _materials('svc_wh')
    sig, epl, deps = _return_map_inputs(mat, n=150, seed=6)
    oj = jcon.response_fast_chunked(
        dm, (jnp.asarray(sig), jnp.asarray(epl)), jnp.asarray(deps),
        jnp.asarray(CV), 12, 1, chunk=64)
    args = (mat, (torch.tensor(sig), torch.tensor(epl)), torch.tensor(deps),
            torch.tensor(CV), 12, 1)
    ot = tcon.response_fast_chunked(*args, chunk=64)
    for a, b in zip(ot, oj):
        _close(a.numpy(), b, 1e-9)
    whole = tcon.response_fast_chunked(*args, chunk=150)
    assert _rel(whole[1][:64].numpy(), oj[1][:64]) > 1e-9


def test_faithful_work_hardening_chunks(monkeypatch):
    """``response_chunked`` chunks a work-hardening material by the JAX
    package's 65536 unless told otherwise (other materials by 2^20), and
    its chunks are ``response`` on zero-padded blocks: 70 lanes in chunks
    of 32, the last block 6 lanes and 26 zero rows.  The padded lanes enter
    the batch-mean khard: their faithful split divides by their zero
    stress, so the plastic lanes of a padded chunk come out NaN, in the
    JAX package as here."""
    dm, mat, CV, _ = _materials('svc_wh')
    sig, epl, deps = (torch.tensor(a) for a in
                      _return_map_inputs(mat, n=70, seed=6))
    CVt = torch.tensor(CV)
    out = tcon.response_chunked(mat, (sig, epl), deps, CVt, chunk=32)
    blk = [torch.cat([t[64:], torch.zeros(26, 6, dtype=t.dtype)])
           for t in (sig, epl, deps)]
    ref = tcon.response(mat, (blk[0], blk[1]), blk[2], CVt)
    for o, r in zip(out, ref):
        assert torch.equal(o[64:].isnan(), r[:6].isnan())
        assert torch.equal(o[64:].nan_to_num(), r[:6].nan_to_num())
    seen = []
    monkeypatch.setattr(tcon, '_chunked',
                        lambda m, fn, st, d, chunk: seen.append(chunk))
    tcon.response_chunked(mat, (sig, epl), deps, CVt)
    tcon.response_chunked(_materials('svc_cyl')[1], (sig, epl), deps, CVt)
    assert seen == [tcon.JAX_FAITHFUL_CHUNK, 1 << 20]


@pytest.mark.parametrize('F', [2, 9, 15])
def test_plain_kernels_match_pallas_f32(F):
    """The plain versions of kernels A, D and E at F features against
    ``svc_f_grad_pallas``, ``svc_decision_pallas`` and
    ``svc_f_grad_pallas_mxu`` in interpret mode, float32, N = 300: atol
    2e-5 max(1, sum|dc|) on f, times 2 gamma max|x - sv| on g."""
    rng = np.random.default_rng(F)
    x = rng.normal(size=(300, F)) * 0.6
    sv = rng.normal(size=(96, F)) * 0.8
    dc = rng.choice([-1., 1.], 96) * rng.uniform(0.1, 1., 96)
    gamma, rho = 2.5 / F, 0.3
    jx, jsv, jdc = (jnp.asarray(a, jnp.float32) for a in (x, sv, dc))
    tx, tsv, tdc = (torch.tensor(a, dtype=torch.float32) for a in (x, sv, dc))
    tol = 2e-5 * max(1., np.abs(dc).sum())
    gtol = tol * 2. * gamma * (np.abs(x).max() + np.abs(sv).max())
    fj, gj = svc_f_grad_pallas(jx, jsv, jdc, gamma, rho, interpret=True)
    ft, gt = sk.svc_f_grad(tx, tsv, tdc, gamma, rho)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=tol)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=gtol)
    fj = svc_decision_pallas(jx, jsv, jdc, gamma, rho, interpret=True)
    np.testing.assert_allclose(sk.svc_decision(tx, tsv, tdc, gamma,
                                               rho).numpy(),
                               np.asarray(fj), rtol=0, atol=tol)
    fj, gj = svc_f_grad_pallas_mxu(jx, jsv, jdc, gamma, rho, interpret=True)
    ft, gt = sk.svc_f_grad_mm(tx, tsv, tdc, gamma, rho)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=tol)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=gtol)


def _record_cg(monkeypatch, module, hist):
    """Wrap ``module.load_step_split`` to record each step's CG
    iteration history."""
    inner = module.load_step_split

    def step(*a, **kw):
        new, diag = inner(*a, **kw)
        hist.append([int(i) for i in diag['cg_iters_hist']])
        return new, diag

    monkeypatch.setattr(module, 'load_step_split', step)


@pytest.mark.parametrize('name,N,kw', [
    ('svc_wh', 16, dict(nsteps=3, n_inner=2)),
    ('svc_cyl', 16, dict(nsteps=3, n_inner=2)),
    ('svc_cyl', 8, dict(nsteps=2, n_inner=2, gate=True, nsub=4,
                        commit_faithful=True))],
    ids=['wh-steps', 'cyl-steps', 'cyl-faithful'])
def test_uniaxial_solves_match_jax(monkeypatch, ref, name, N, kw):
    """The slice end to end: ``solve_uniaxial`` (uniaxial y, eps 0.002) on
    an N x N mesh, three steps of the split load step with the fast return
    map, or two of the gated REF_SOLVE protocol with the faithful tail
    (whose gate does not fire with this material: every step runs its 16
    rounds and warns, in the JAX package as here); every step's glob_sig
    within 1e-9 relative, the states within 1e-9, identical CG histories
    (JAX's from the committed fixture)."""
    tag = {16: {'svc_wh': 'wh-steps', 'svc_cyl': 'cyl-steps'},
           8: {'svc_cyl': 'cyl-faithful'}}[N][name]
    _, mat, CV, eps = _materials(name)
    mt = tfek.rect_mesh(N, N, LX=2., LY=2., uniax='y', eps_tot=eps,
                        dtype=torch.float64, device='cpu')
    cg_t = []
    _record_cg(monkeypatch, tfek, cg_t)
    st, ht = tfek.solve_uniaxial(mt, mat, CV, dtype=torch.float64, **kw)
    cg_j = [list(ref[f'uni.{tag}.cg{k}']) for k in range(kw['nsteps'])]
    assert cg_t == cg_j
    assert len(ht) == len(ref[f'uni.{tag}.glob_sig'])
    for a, b in zip(ht, ref[f'uni.{tag}.glob_sig']):
        assert _rel(a[0].numpy(), b) <= 1e-9
    for f in ('u', 'sig', 'epl'):
        assert _rel(getattr(st, f).numpy(), ref[f'uni.{tag}.{f}']) <= 1e-9, f
    assert ref[f'uni.{tag}.epl'].any()
