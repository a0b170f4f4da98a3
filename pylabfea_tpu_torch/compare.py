"""Hold this checkout's kernels and load steps against another checkout's,
on one card.

    python -m pylabfea_tpu_torch.compare --base DIR [--pairs 3]
                                         [--profile] [--out chiprun_out]

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive`` into a git-ignored directory).  Every part
runs in fresh Python processes, one checkout at a time, so that each
checkout builds and loads its own kernels into its own
``pylabfea_tpu_torch/build/``; the checkouts take turns (base, this, this,
base, ...), so that a drift of the card falls on both.

* bits: kernels A (``svc_f_grad``: f and g with the gradient, f without),
  D (``svc_decision``: f) and E (``svc_f_grad_mm``: f and g), float32 and
  float64, at 2^20+17 points x 135 SVs (the trained SVC of
  ``REF_SOLVE_svc.npz``), 2^20+17 x 512 (``chip_smoke.synthetic_svc``) and
  1024 x 135; E also at N x 135 on each side of every switch of its launch
  form (a group of GT = 32, 16, 8 threads a point up to sm_count * 64
  points, then P = 1, 2, 4 points a thread); kernel C (``k_apply3``) at
  128^3, 40x24x72 and 67x29x93 in float32 and 16^3 in float64; kernel
  G through ``constitutive.ml_yf_dist`` (the distances) on 1024
  stresses with the trained SVC and 2^16 with the synthetic one, float32
  and float64; on inputs made from seeds.  Every output of every run is
  compared bit for bit with the base's first run; each run also times A,
  E and C in float32 (CUDA events; E at 1024 x 135 also a launch in a
  CUDA graph, ``chip_smoke.graph_ms``) and E at 2^18 x 512 in float64.
* steps (``--pairs`` pairs): ``chip_smoke.phase_main_path`` at 1024^2
  (``step_s``, ``step_s_rep``) and the timed warm 0.3 step of the 128^3
  3-D path (``step_s_128cubed``, ``chip_smoke.run_steps3``).
* ``--profile``: ``python -m pylabfea_tpu_torch.profile_step`` (2-D and
  ``--dim 3``) in each checkout, into ``--out``/``profile_{base,this}``.

Both checkouts must have ``chip_smoke.py`` with those functions.  Prints
the card and one JSON line per part, and writes them to
``--out``/``compare.json``.  Needs a CUDA card.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: kernel A cases: (label, points, SVC)
A_CASES = (('2^20+17 x 135', 2 ** 20 + 17, 'trained'),
           ('2^20+17 x 512', 2 ** 20 + 17, 'synthetic'),
           ('1024 x 135', 1024, 'trained'))
#: kernel E's launch-form switches, as N = sm_count * 1024 * num // den:
#: a group of GT = 32, 16, 8 threads a point up to sm_count * 8, 16, 64
#: points, then one point a thread, two and four from 2 and 4 x
#: sm_count * 1024; each is evaluated at N and N + 1 (N - 1 and N at the
#: last two)
E_SWITCHES = ((1, 128), (1, 64), (1, 16), (2, 1), (4, 1))
#: kernel C cases: (shape, dtype name)
C_CASES = (((128, 128, 128), 'float32'), ((40, 24, 72), 'float32'),
           ((67, 29, 93), 'float32'), ((16, 16, 16), 'float64'))


def svc_params(kind):
    """The trained (``REF_SOLVE_svc.npz``) or the synthetic 512-SV SVC."""
    import chip_smoke
    if kind == 'synthetic':
        return chip_smoke.synthetic_svc()
    z = np.load(chip_smoke.NPZ)
    return dict(sv=z['support_vectors'], dc=z['dual_coef'],
                gamma=float(z['gamma']), rho=float(z['intercept']))


def seeded_points(n):
    """N feature points at radii 0.3-1.3 in random directions (seed 2)."""
    rng = np.random.default_rng(2)
    u = rng.normal(size=(n, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return u * rng.uniform(0.3, 1.3, (n, 1))


def e_cases(sms):
    """Kernel E's cases on a card of ``sms`` SMs: (label, points, SVC)."""
    fill = sms * 1024
    cases = list(A_CASES)
    for num, den in E_SWITCHES:
        n = fill * num // den
        for m in ((n - 1, n) if den == 1 else (n, n + 1)):
            cases.append((f'{m} x 135', m, 'trained'))
    return cases


def g_bits(dev):
    """Kernel G's outputs through ``ml_yf_dist``: {key: distance} on
    seeded stresses at 0.3-2 sy, both SVCs, float32 and float64."""
    import chip_smoke
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import constitutive as con
    outs = {}
    for kind, n in (('trained', 1024), ('synthetic', 2 ** 16)):
        rng = np.random.default_rng(4)
        u = rng.normal(size=(n, 6))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        sig = u * chip_smoke.SY * rng.uniform(0.3, 2.0, (n, 1))
        for dt in (torch.float32, torch.float64):
            if kind == 'trained':
                mat = convert.material_from_npz(chip_smoke.NPZ, dtype=dt,
                                                device=dev)[0]
            else:
                mat = convert.material_from_params(
                    chip_smoke.synthetic_svc(), is_svc=True, dtype=dt,
                    device=dev)
            d = con.ml_yf_dist(mat, torch.as_tensor(sig, dtype=dt,
                                                    device=dev),
                               torch.zeros(n, dtype=dt, device=dev))
            outs[f'G {n} x {kind} {str(dt)[6:]} distance'] = d.cpu()
    return outs


def bits_worker(out_file):
    """Run in a checkout: its kernels A, D, E, G and C on the seeded
    inputs; saves the outputs and the times (ms) to ``out_file``."""
    import chip_smoke
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    from pylabfea_tpu_torch.ops import volume
    dev = torch.device('cuda', 0)
    outs, ms = {}, {}
    for label, n, kind in A_CASES:
        p = svc_params(kind)
        x64 = seeded_points(n)
        for dt in (torch.float32, torch.float64):
            x, sv, dc = (torch.as_tensor(a, dtype=dt, device=dev)
                         for a in (x64, p['sv'], p['dc']))
            f, g = sk.svc_f_grad(x, sv, dc, p['gamma'], p['rho'])
            f0, _ = sk.svc_f_grad(x, sv, dc, p['gamma'], p['rho'],
                                  with_grad=False)
            key = f'A {label} {str(dt)[6:]}'
            outs.update({f'{key} f': f.cpu(), f'{key} g': g.cpu(),
                         f'{key} f (no grad)': f0.cpu()})
            outs[f'D {label} {str(dt)[6:]} f'] = sk.svc_decision(
                x, sv, dc, p['gamma'], p['rho']).cpu()
            if dt == torch.float32:
                ms[f'A {label}'] = chip_smoke.timed_ms(
                    lambda: sk.svc_f_grad(x, sv, dc, p['gamma'], p['rho']),
                    20)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, n, kind in e_cases(sms):
        p = svc_params(kind)
        x64 = seeded_points(n)
        for dt in (torch.float32, torch.float64):
            x, sv, dc = (torch.as_tensor(a, dtype=dt, device=dev)
                         for a in (x64, p['sv'], p['dc']))
            f, g = sk.svc_f_grad_mm(x, sv, dc, p['gamma'], p['rho'])
            key = f'E {label} {str(dt)[6:]}'
            outs.update({f'{key} f': f.cpu(), f'{key} g': g.cpu()})
            if dt == torch.float32 and (label, n, kind) in A_CASES:
                ms[f'E {label}'] = chip_smoke.timed_ms(
                    lambda: sk.svc_f_grad_mm(x, sv, dc, p['gamma'],
                                             p['rho']), 20)
                if n <= chip_smoke.SMALL_N:
                    ms[f'E {label} (graph)'] = chip_smoke.graph_ms(
                        lambda: sk.svc_f_grad_mm(x, sv, dc, p['gamma'],
                                                 p['rho']), 200)
    p = svc_params('synthetic')
    x, sv, dc = (torch.as_tensor(a, dtype=torch.float64, device=dev)
                 for a in (seeded_points(2 ** 18), p['sv'], p['dc']))
    ms['E 2^18 x 512 float64'] = chip_smoke.timed_ms(
        lambda: sk.svc_f_grad_mm(x, sv, dc, p['gamma'], p['rho']), 20)
    for shape, dname in C_CASES:
        dt = getattr(torch, dname)
        Cp, u = chip_smoke.kapply3_inputs(shape, dt, dev)
        h = (1. / shape[0], 1.3 / shape[1], 0.7 / shape[2])
        o = volume.k_apply3(Cp, *u, *h)
        key = f'C {"x".join(map(str, shape))} {dname}'
        outs.update({f'{key} o{c}': o[c].cpu() for c in range(3)})
        if shape == (128, 128, 128):
            ms[f'C {key[2:]}'] = chip_smoke.timed_ms(
                lambda: volume.k_apply3(Cp, *u, *h), 20)
    outs.update(g_bits(dev))
    torch.save(dict(outs=outs, ms=ms), out_file)


def steps_worker(out_file):
    """Run in a checkout: one 1024^2 main-path run and one 128^3 3-D run
    of its ``chip_smoke``; saves the step seconds as JSON."""
    import chip_smoke
    dev = torch.device('cuda', 0)
    run = chip_smoke.phase_main_path(dev, 1024, torch.cuda.get_device_name(0))
    secs = chip_smoke.run_steps3(128, (0.4, 0.3), torch.float32, dev)[3]
    with open(out_file, 'w') as f:
        json.dump(dict(step_s=run['step_s'], step_s_rep=run['step_s_rep'],
                       step_s_128cubed=secs[1]), f)


def _in(checkout, worker, out_file):
    """Run ``worker(out_file)`` of this file in a fresh process whose
    imports resolve to ``checkout``."""
    code = ('import importlib.util as u; '
            f's = u.spec_from_file_location("compare_worker", '
            f'{os.path.abspath(__file__)!r}); m = u.module_from_spec(s); '
            f's.loader.exec_module(m); m.{worker}({out_file!r})')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, '-c', code], cwd=checkout, env=env,
                       capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f'compare: {worker} in {checkout} failed '
                           f'({r.returncode}):\n{r.stdout[-4000:]}\n'
                           f'{r.stderr[-4000:]}')


def _turns(n_pairs):
    """base, this, this, base, ... for ``n_pairs`` pairs."""
    order = []
    for i in range(n_pairs):
        order += ['base', 'this'] if i % 2 == 0 else ['this', 'base']
    return order


def compare_bits(dirs, tmp):
    runs = []
    for i, who in enumerate(_turns(2)):
        path = os.path.join(tmp, f'bits_{i}.pt')
        _in(dirs[who], 'bits_worker', path)
        runs.append((who, torch.load(path)))
    ref = runs[0][1]['outs']
    same, diff = {}, {}
    for key, r in ref.items():
        for who, run in runs[1:]:
            o = run['outs'][key]
            if torch.equal(o, r):
                continue
            diff.setdefault(key, []).append(
                (who, float((o.double() - r.double()).abs().max())))
        same[key] = key not in diff
    ms = {}
    for who, run in runs:
        for k, v in run['ms'].items():
            ms.setdefault(k, {}).setdefault(who, []).append(v)
    return dict(all_bitwise_equal=all(same.values()), bitwise_equal=same,
                max_abs_diff=diff, ms=ms)


def compare_steps(dirs, tmp, pairs):
    res = {}
    for i, who in enumerate(_turns(pairs)):
        path = os.path.join(tmp, f'steps_{i}.json')
        _in(dirs[who], 'steps_worker', path)
        with open(path) as f:
            for k, v in json.load(f).items():
                res.setdefault(k, {}).setdefault(who, []).append(v)
    return res


def profile(dirs, out):
    res = {}
    for who in ('base', 'this'):
        dest = os.path.abspath(os.path.join(out, f'profile_{who}'))
        for dim in (2, 3):
            r = subprocess.run([sys.executable, '-m',
                                'pylabfea_tpu_torch.profile_step', '--dim',
                                str(dim), '--out', dest], cwd=dirs[who],
                               capture_output=True, text=True, timeout=1800)
            if r.returncode != 0:
                raise RuntimeError(f'compare: profile_step --dim {dim} in '
                                   f'{dirs[who]} failed:\n{r.stderr[-4000:]}')
            stem = 'profile_step' + ('3d' if dim == 3 else '')
            with open(os.path.join(dest, stem + '.json')) as f:
                p = json.load(f)
            res[f'{who} {dim}-D'] = dict(
                steps_s=p['steps_s'],
                device_busy_share=p['device_busy_share'],
                kernels={k['name']: [k['count'], k['device_ms']]
                         for k in p['top_kernels']
                         if 'kapply' in k['name'] or 'svc' in k['name']})
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--base', required=True)
    ap.add_argument('--pairs', type=int, default=3)
    ap.add_argument('--profile', action='store_true')
    ap.add_argument('--out', default=os.path.join(ROOT, 'profile_out'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('compare: needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    dirs = dict(base=os.path.abspath(args.base), this=ROOT)
    tmp = os.path.join(ROOT, 'pylabfea_tpu_torch', 'build', 'compare')
    os.makedirs(tmp, exist_ok=True)
    os.makedirs(args.out, exist_ok=True)
    res = dict(card=card)
    try:
        res['bits'] = compare_bits(dirs, tmp)
        print(json.dumps(dict(bits=res['bits'])), flush=True)
        if args.pairs:
            res['steps'] = compare_steps(dirs, tmp, args.pairs)
            print(json.dumps(dict(steps=res['steps'])), flush=True)
        if args.profile:
            res['profile'] = profile(dirs, args.out)
            print(json.dumps(dict(profile=res['profile'])), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        with open(os.path.join(args.out, 'compare.json'), 'w') as f:
            json.dump(res, f, indent=1)
    return 0 if res['bits']['all_bitwise_equal'] else 1


if __name__ == '__main__':
    sys.exit(main())
