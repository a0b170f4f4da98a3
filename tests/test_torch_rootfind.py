"""PyTorch port: the batched Brent zeroin against the JAX ``brent_jax`` in
float64 on the functions of ``tests/test_rootfind.py``.  Inputs are made
with numpy from a seed and handed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops.rootfind import brent_jax
from pylabfea_tpu_torch.ops import rootfind

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)


def _sweep_cases(n=200, seed=42):
    """Brackets and slopes of the sweep of ``tests/test_rootfind.py``, with
    a root r inside each bracket."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-3, 1, n)
    b = a + rng.uniform(0.5, 6, n)
    k = rng.uniform(0.3, 4.0, n)
    r = a + rng.uniform(0.05, 0.95, n) * (b - a)
    return a, b, k, r


def _f(lib, k, r):
    """f(x) = (x - r)^3 + k (x - r): one root at r, built from operations
    both frameworks round the same way (the sweep's tanh differs in the
    last bit between them, which moves iterates by ~1e-10)."""
    k, r = lib.asarray(k), lib.asarray(r)
    return lambda x: (x - r) ** 3 + k * (x - r)


@pytest.mark.parametrize('check_every', [1, rootfind.CHECK_EVERY])
def test_brent_matches_jax_f64(monkeypatch, check_every):
    """Equal roots and flags, with the done flag read every iteration (as
    on the CPU) and every CHECK_EVERY iterations (as on the card; frozen
    lanes make both exact)."""
    monkeypatch.setattr(rootfind, 'check_every', lambda x: check_every)
    a, b, k, r = _sweep_cases()
    rj, okj = brent_jax(_f(jnp, k, r), a, b, xtol=1.e-5)
    rt, okt = rootfind.brent(_f(torch, k, r), torch.tensor(a),
                             torch.tensor(b), xtol=1.e-5)
    assert okt.all()
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def test_brent_bracket_ends_match_jax_f64():
    """Exact roots at either end of the bracket, and brackets without a
    sign change (unconverged, root xb), on a cubic that both frameworks
    evaluate exactly the same way."""
    a, b, k, _ = _sweep_cases(60, seed=7)
    r = a + 0.3 * (b - a)
    r[::5] = a[::5]                           # root at xa
    r[1::5] = b[1::5]                         # root at xb
    r[2::5] = b[2::5] + 1.                    # no sign change

    def fj(x):
        return jnp.asarray(k) * (x - jnp.asarray(r)) ** 3

    rj, okj = brent_jax(fj, a, b, xtol=1.e-5)
    kt, rt_ = torch.tensor(k), torch.tensor(r)
    rt, okt = rootfind.brent(lambda x: kt * (x - rt_) ** 3, torch.tensor(a),
                             torch.tensor(b), xtol=1.e-5)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt[::5].all() and okt[1::5].all() and not okt[2::5].any()
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def test_brent_respects_maxiter():
    """A tolerance no lane can meet: the loop runs exactly maxiter
    iterations (no lane finishes, so no done test ends it early) and
    matches JAX."""
    a, b, k, r = _sweep_cases(20, seed=3)
    calls = []
    ft = _f(torch, k, r)

    def f(x):
        calls.append(1)
        return ft(x)

    rj, okj = brent_jax(_f(jnp, k, r), a, b, xtol=-1., maxiter=5)
    rt, okt = rootfind.brent(f, torch.tensor(a), torch.tensor(b), xtol=-1.,
                             maxiter=5)
    assert len(calls) == 2 + 5
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    # iterates below every tolerance: the cubic's last bit may differ
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-14)
