"""PyTorch port: the SVC dual trainer against the JAX trainer in float64 on
the small Hill training set (``pylabfea_tpu_torch/data/train_small.npz``,
480 points), the K-fold grid search, and the trained SVC carried through
the fixture format."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu import ml_train as jml
from pylabfea_tpu.ops import svc as jsvc
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch import ml_train as tml
from pylabfea_tpu_torch.ops import constitutive as tcon

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pylabfea_tpu_torch', 'data', 'train_small.npz')
ITERS = 500
CPU64 = dict(dtype=torch.float64, device='cpu')


def _set():
    z = np.load(DATA)
    return (z['X'], z['y'].astype(float), float(z['C']), float(z['gamma']),
            float(z['sy']))


@pytest.fixture(scope='module')
def jax_fit():
    X, y, C, gamma, _ = _set()
    params, a = jml.fit_svc_jax(X, y, C=C, gamma=gamma, iters=ITERS,
                                dtype=jnp.float64)
    return params, a


def _probe(n=300, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return u * rng.uniform(0.3, 1.7, (n, 1))


def test_fit_svc_matches_jax(jax_fit):
    X, y, C, gamma, _ = _set()
    pj, aj = jax_fit
    pt, at = tml.fit_svc(X, y, C=C, gamma=gamma, iters=ITERS, **CPU64)
    np.testing.assert_allclose(at, aj, rtol=0, atol=1e-10 * C)
    np.testing.assert_array_equal(pt['sv'], pj.support_vectors)
    P = np.concatenate([X, _probe()])
    fj = jsvc.decision_function(pj, P)
    ft = jsvc.decision_function(jsvc.SVCParams(pt['sv'], pt['dc'], pt['rho'],
                                               pt['gamma']), P)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-8 * np.abs(fj).max())


def test_gridsearch_scores_match_jax():
    X, y, _, _, _ = _set()
    cvals, gvals = [1., 4., 10.], [0.5, 1.5, 2.5]
    Cj, gj, sj = jml.gridsearch_svc_jax(X, y, cvals, gvals, n_splits=3,
                                        iters=200, dtype=jnp.float64)
    Ct, gt, st = tml.gridsearch_svc(X, y, cvals, gvals, n_splits=3,
                                    iters=200, **CPU64)
    np.testing.assert_array_equal(st, sj)
    assert (Ct, gt) == (Cj, gj)
    assert st.shape == (3, 3) and 0.8 < st.max() <= 1.


def test_trained_svc_serves_and_crosses_the_fixture_format(tmp_path,
                                                          jax_fit):
    """train_svc returns a DeviceMaterial whose decision function is the
    JAX trainer's, that classifies its training set, and that the fixture
    format carries exactly (``material_to_npz`` -> ``material_from_npz``)."""
    X, y, C, gamma, sy = _set()
    mat, score, params = tml.train_svc(X, y, sy, C=C, gamma=gamma,
                                       iters=ITERS, **CPU64)
    assert mat.is_svc and mat.scale_seq == sy and score > 97.
    P = torch.as_tensor(_probe(), **CPU64)
    fj = jsvc.decision_function(jax_fit[0], P.numpy())
    ft = tcon.svc_decision(mat, P).numpy()
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-8 * np.abs(fj).max())
    CV = np.eye(6) * 1e5
    path = str(tmp_path / 'trained.npz')
    convert.material_to_npz(path, mat, CV, eps=0.002)
    back, CVb, eps = convert.material_from_npz(path, **CPU64)
    for k in ('hill', 'sv', 'dc', 'feat_mean', 'feat_scale', 'tex'):
        assert torch.equal(getattr(back, k), getattr(mat, k)), k
    for k in ('sy', 'khard', 'drucker', 'rho', 'gamma', 'scale_seq',
              'scale_wh', 'voce_r', 'voce_b', 'is_svc', 'dev_only',
              'sdim3'):
        assert getattr(back, k) == getattr(mat, k), k
    assert np.array_equal(CVb, CV) and eps == 0.002
