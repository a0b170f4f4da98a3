"""The one traffic generator: it reads a mix's parameters (a
``traffic/<name>.json`` file) and makes the requests of a run from its
seed.  Two kinds:

* ``fe_solve``: a closed loop of whole load histories on one mesh
  (``mesh``: elements per axis; ``nsteps`` load steps of ``n_inner`` + 1
  rounds each).  Request i ends at the configuration's strain times a
  scale drawn from ``strain_scale`` [lo, hi]: the range is cut into
  ``strata`` equal strata, every pass over them visits each once in an
  order drawn from the seed, at a uniform point inside it, so every seed
  runs the same mix of sizes in another order.
* ``return_map``: a closed loop of return-map calls on ``states`` rows
  each, cycling through a ``pool`` of batches made on the device from the
  seed: stresses along unit directions at ``radius`` [lo, hi] times sy,
  zero plastic strain, strain increments with standard deviation
  ``deps_std`` (``bench.py``'s return-map workload).
"""
import numpy as np
import torch


def strain_scales(mix, seed):
    """Endless scales of the end strain of successive ``fe_solve``
    requests."""
    lo, hi = mix['strain_scale']
    k = int(mix['strata'])
    rng = np.random.default_rng(seed)
    while True:
        for s in rng.permutation(k):
            yield lo + (hi - lo) * (s + rng.random()) / k


def return_map_pool(mix, seed, sy, dtype, device):
    """(sig0, epl0, deps), each (pool, states, 6), made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shape = (int(mix['pool']), int(mix['states']), 6)
    lo, hi = mix['radius']
    u = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    r = lo + (hi - lo) * torch.rand(shape[:2] + (1,), generator=gen,
                                    dtype=dtype, device=device)
    sig0 = u * (sy * r)
    deps = float(mix['deps_std']) * torch.randn(
        shape, generator=gen, dtype=dtype, device=device)
    return sig0, torch.zeros_like(sig0), deps
