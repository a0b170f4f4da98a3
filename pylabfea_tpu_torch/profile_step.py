"""Where the time of one load step goes on the card.

    python -m pylabfea_tpu_torch.profile_step [--n 1024] [--out profile_out]

Runs the main path of ``chip_smoke.py`` (1024^2 Hill-ML mesh, trained SVC,
float32; one untimed step, then warm-started steps) and reports

* per-phase wall time of the timed steps (multigrid hierarchy build, MG-CG
  solve, return map + tangent update), each phase closed by a device
  synchronise;
* a ``torch.profiler`` trace of one more warm step: device time by kernel,
  the number of kernel launches, and the device-busy share of the step's
  wall time.

Writes ``profile_step.json`` and the profiler table to ``--out``.  Needs a
CUDA card; the timings include the per-phase synchronisation.
"""
import argparse
import json
import os
import time

import torch

from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import fe_kernels as fek

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(fn, acc, key):
    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc[key] = acc.get(key, 0.) + time.perf_counter() - t0
        return out
    return wrapper


def _step(md, st, mat, CV, d):
    return fek.load_step_split(md, st, mat, CV, 0.25, n_inner=2,
                               du0=d['du'], kes0=d['kes'], dst0=d['dstiff'])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=1024)
    ap.add_argument('--out', default=os.path.join(ROOT, 'profile_out'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_step: needs a CUDA card')
    dev = torch.device('cuda', 0)
    mat, CV, eps = convert.material_from_npz(
        os.path.join(ROOT, 'REF_SOLVE_svc.npz'), device=dev)
    md = fek.rect_mesh(args.n, args.n, eps_tot=eps, device=dev)
    st = fek.init_state(md, CV)
    st, d = fek.load_step_split(md, st, mat, CV, 0.25, n_inner=2)
    torch.cuda.synchronize()

    phases = {}
    orig = {k: getattr(fek, k) for k in ('_hier_kes', '_mg_solve',
                                         '_respond_and_update')}
    steps = []
    try:
        for k, fn in orig.items():
            setattr(fek, k, _timed(fn, phases, k))
        for _ in range(2):
            t0 = time.perf_counter()
            st, d = _step(md, st, mat, CV, d)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
    finally:
        for k, fn in orig.items():
            setattr(fek, k, fn)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, d = _step(md, st, mat, CV, d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    res = {
        'mesh': f'{args.n}x{args.n}', 'card': torch.cuda.get_device_name(0),
        'steps_s': steps, 'phase_s_over_2_steps': phases,
        'profiled_step_wall_s': wall, 'profiled_step_device_s': dev_us * 1e-6,
        'device_busy_share': dev_us * 1e-6 / wall,
        'device_kernel_launches': launches,
        'cg_iters_hist': d['cg_iters_hist'],
        'top_kernels': [{'name': e.key[:90], 'count': e.count,
                         'device_ms': e.self_device_time_total / 1e3}
                        for e in top]}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'profile_step.json'), 'w') as f:
        json.dump(res, f, indent=1)
    with open(os.path.join(args.out, 'profile_step.txt'), 'w') as f:
        f.write(prof.key_averages().table(sort_by='self_device_time_total',
                                          row_limit=40))
    print(json.dumps(res, indent=1))


if __name__ == '__main__':
    main()
