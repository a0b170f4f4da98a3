"""Where the time of one load step goes on the card.

    python -m pylabfea_tpu_torch.profile_step [--dim 2|3] [--n N]
                                              [--inclusion]
                                              [--out profile_out]

``--dim 2`` (default ``--n 1024``) runs the 2-D path of ``chip_smoke.py``
(N^2 Hill-ML mesh, trained SVC, float32; one untimed step, then two
warm-started steps).  ``--dim 3`` (default ``--n 128``) runs its 3-D path
(N^3 hex8 box, J2 + linear hardening, float32; ``bench.py``'s untimed 0.4
step, then two warm 0.3 steps).  ``--inclusion`` takes ``bench.py``'s
inclusion workloads instead (``workloads.inclusion_case``, the 2-D
3-material mesh, and ``box_inclusion_case``, the 3-D stiff cube), with the
same steps.  Reports

* per-phase wall time of the timed steps (multigrid hierarchy build, MG-CG
  solve, return map + tangent update), each phase closed by a device
  synchronise;
* a ``torch.profiler`` trace of one more warm step: device time by kernel,
  the number of kernel launches, and the device-busy share of the step's
  wall time.

Writes ``profile_step[3d][_inclusion].json`` and the profiler table to
``--out``.
Needs a CUDA card; the timings include the per-phase synchronisation.
"""
import argparse
import json
import os
import time

import torch

from pylabfea_tpu_torch import convert, workloads
from pylabfea_tpu_torch.ops import fe3d
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


def _setup2(n, dev, inclusion=False):
    """2-D path after its untimed step: (step function, phase functions of
    ``fek`` by name)."""
    if inclusion:
        md, mat, CV = workloads.inclusion_case(n, torch.float32, dev)
    else:
        mat, CV, eps = convert.material_from_npz(workloads.NPZ, device=dev)
        md = fek.rect_mesh(n, n, eps_tot=eps, device=dev)
    st = fek.init_state(md, CV)
    carry = dict(zip(('st', 'd'), fek.load_step_split(md, st, mat, CV, 0.25,
                                                      n_inner=2)))

    def step():
        d = carry['d']
        carry['st'], carry['d'] = fek.load_step_split(
            md, carry['st'], mat, CV, 0.25, n_inner=2, du0=d['du'],
            kes0=d['kes'], dst0=d['dstiff'])
        return carry['d']
    return step, (fek, ('_hier_kes', '_mg_solve', '_respond_and_update'))


def _setup3(n, dev, inclusion=False):
    """3-D path after its untimed 0.4 step (bench.py protocol).  Every
    step is the same warm 0.3 step from that state: a second equal step
    would start converged and do no CG work."""
    if inclusion:
        md, mat, CV = workloads.box_inclusion_case(n, torch.float32, dev)
    else:
        CV = convert.elastic_cv(200.e3, 0.3)
        mat = convert.material_from_params(
            dict(hill=[1.] * 6, sy=150., khard=500., drucker=0.),
            is_svc=False, device=dev)
        md = fe3d.box_mesh(n, n, n, uniax='z', eps_tot=0.002, device=dev)
    st, d0 = fe3d.load_step3(md, fe3d.init_state3(md, CV), mat, CV, 0.4,
                             n_inner=2)

    def step():
        return fe3d.load_step3(md, st, mat, CV, 0.3, n_inner=2,
                               du0=d0['du'])[1]
    return step, (fe3d, ('build_hierarchy3', 'mg_cg_solve3',
                         'respond_grouped3'))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--dim', type=int, choices=(2, 3), default=2)
    ap.add_argument('--n', type=int, default=None)
    ap.add_argument('--inclusion', action='store_true')
    ap.add_argument('--out', default=os.path.join(ROOT, 'profile_out'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_step: needs a CUDA card')
    dev = torch.device('cuda', 0)
    n = args.n or (1024 if args.dim == 2 else 128)
    step, (mod, names) = (_setup2 if args.dim == 2 else _setup3)(
        n, dev, args.inclusion)
    torch.cuda.synchronize()

    phases = {}
    orig = {k: getattr(mod, k) for k in names}
    steps = []
    try:
        for k, fn in orig.items():
            setattr(mod, k, _timed(fn, phases, k))
        for _ in range(2):
            t0 = time.perf_counter()
            d = step()
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
    finally:
        for k, fn in orig.items():
            setattr(mod, k, fn)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        d = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    res = {
        'mesh': 'x'.join([str(n)] * args.dim),
        'card': torch.cuda.get_device_name(0),
        'steps_s': steps, 'phase_s_over_2_steps': phases,
        'profiled_step_wall_s': wall, 'profiled_step_device_s': dev_us * 1e-6,
        'device_busy_share': dev_us * 1e-6 / wall,
        'device_kernel_launches': launches,
        'cg_iters_hist': [int(x) for x in d['cg_iters_hist']],
        'top_kernels': [{'name': e.key[:90], 'count': e.count,
                         'device_ms': e.self_device_time_total / 1e3}
                        for e in top]}
    os.makedirs(args.out, exist_ok=True)
    stem = 'profile_step' + ('3d' if args.dim == 3 else '') \
        + ('_inclusion' if args.inclusion else '')
    with open(os.path.join(args.out, stem + '.json'), 'w') as f:
        json.dump(res, f, indent=1)
    with open(os.path.join(args.out, stem + '.txt'), 'w') as f:
        f.write(prof.key_averages().table(sort_by='self_device_time_total',
                                          row_limit=40))
    print(json.dumps(res, indent=1))


if __name__ == '__main__':
    main()
