"""What a forward-mode Jacobian of ``calibrate.simulate_paths`` costs, by
mechanism.

    python -m pylabfea_tpu_torch.profile_fwd [--device cuda|cpu]
        [--paths 1024] [--steps 30] [--maxiter 40] [--out profile_out]

On the hidden material of ``examples/calibrate_plasticity.py`` (chip_smoke
phase 14c's paths and theta, float64), for each integrator ('unrolled',
the fixed-trip return map; 'implicit', the backward-Euler projection)
times, each closed by a device synchronise:

* ``map``: ``simulate_paths`` alone, no derivative;
* ``dual``: ``dual.jacfwd``, every column of the Jacobian in one pass
  (what ``fit_plasticity`` runs);
* ``forward_ad``: one column through ``torch.autograd.forward_ad``;
* ``func_jvp``: one column through ``torch.func.jvp``;

with the CUDA-graph replays of ``ops.graphs`` off (``eager``) and, on the
card, on (``graphed``; ``forward_ad`` and ``torch.func`` calls never
replay).  ``map`` and ``dual`` are the second of two calls (the first
captures the graphs), ``forward_ad`` and ``func_jvp`` one call after
those.  Prints one JSON line and writes ``profile_fwd.json`` to
``--out``.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from pylabfea_tpu_torch.ops import calibrate as cal
from pylabfea_tpu_torch.ops import dual, graphs

#: the hidden material of ``examples/calibrate_plasticity.py``
HILL, SY, KHARD = (1.3, 0.85, 1., 1., 1., 1.), 180., 800.


def _paths(npaths, nsteps, seed=0):
    """chip_smoke's ``cal_paths``: random unit directions, five small
    steps through the yield onset, then 1.6e-3 steps."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(npaths, 6))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    steps = np.full(nsteps, 1.6e-3)
    steps[:5] = 2.5e-4
    return dirs[:, None, :] * steps[None, :, None]


def _cv(E=200.e3, nu=0.3):
    lam, mu = E * nu / ((1 + nu) * (1 - 2 * nu)), E / (2 * (1 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(6), np.arange(6)] += [2 * mu] * 3 + [mu] * 3
    return C


def _seconds(fn, dev, warm=True):
    if warm:
        fn()
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile(dev, npaths, nsteps, maxiter):
    f64 = torch.float64
    deps = torch.as_tensor(_paths(npaths, nsteps), dtype=f64, device=dev)
    CV = torch.as_tensor(_cv(), dtype=f64, device=dev)
    theta = {k: torch.as_tensor(np.asarray(v, float), dtype=f64, device=dev)
             for k, v in dict(log_sy=np.log(SY), log_hill=np.log(HILL),
                              raw_dsy=KHARD).items()}
    x0, unravel = cal.ravel_theta(theta)
    e = torch.zeros_like(x0)
    e[0] = 1.
    out = {}
    for integ in ('unrolled', 'implicit'):
        def f(x):
            return cal.simulate_paths(unravel(x), CV, deps, maxiter,
                                      integrator=integ)

        def fwd_ad():
            from torch.autograd import forward_ad
            with forward_ad.dual_level():
                forward_ad.unpack_dual(f(forward_ad.make_dual(x0, e)))

        runs = dict(map=lambda: f(x0), dual=lambda: dual.jacfwd(f, x0),
                    forward_ad=fwd_ad,
                    func_jvp=lambda: torch.func.jvp(f, (x0,), (e,)))
        modes = ('eager', 'graphed') if dev.type == 'cuda' else ('eager',)
        for mode in modes:
            graphs.ENABLED = mode == 'graphed'
            try:
                with torch.no_grad():
                    for name in ('map', 'dual'):
                        out[f'{integ} {mode} {name}'] = _seconds(
                            runs[name], dev)
                if mode == 'eager':
                    for name in ('forward_ad', 'func_jvp'):
                        out[f'{integ} {name}'] = _seconds(runs[name], dev,
                                                          warm=False)
            finally:
                graphs.ENABLED = True
    out.update(columns=int(x0.numel()), paths=npaths, steps=nsteps,
               maxiter=maxiter, device=str(dev),
               name=(torch.cuda.get_device_name(0) if dev.type == 'cuda'
                     else 'cpu'))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--paths', type=int, default=1024)
    ap.add_argument('--steps', type=int, default=30)
    ap.add_argument('--maxiter', type=int, default=40)
    ap.add_argument('--out', default='profile_out')
    a = ap.parse_args()
    dev = torch.device(a.device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('profile_fwd: no CUDA device; pass --device cpu')
    res = profile(dev, a.paths, a.steps, a.maxiter)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, 'profile_fwd.json'), 'w') as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == '__main__':
    main()
