"""How the bridge's serving path behaves on the card-trained Hill SVC.

    python -m pylabfea_tpu_torch.bridge_study [--device cuda|cpu]
        [--N 1024] [--nel 256] [--out chiprun_out]

The SVC is chip_smoke phase 14a's: ``ml_train.train_svc`` in float32 on
the Hill training set of ``examples/train_hill.py``
(``data/train_hill.npz``; rv [1.2, 1, 0.8, 1, 1, 1], sy 50), compressed at
'auto' as phase 15a does.  Both material records go to
``<out>/card_svc.npz`` (``raw.<name>``, ``red.<name>``), so that the
host-profile tools can run the same SVC.  Then, each run timed:

* ``props``: ``properties_record`` (the body of
  ``calc_properties_on_device``) in float32 at ``calc_properties``'s
  default protocol (eps 0.005 in 20 steps) and at phase 15d's (eps 0.001
  in 10 steps), with the raw and the compressed SVC, at Nel 8 and
  ``--nel``: each load case's prop and propJ2 yield strengths beside the
  analytic Hill values (propJ2 along the elastic stress direction of the
  case, prop along the last stress), the relative errors and the touch
  scale;
* ``noise``: phase 15b's solve (``solve_record``, N x N, plane strain,
  top displaced by 0.002, 20 steps x n_inner 2) in float32 with the raw
  SVC, again with its dual coefficients moved by one float32 ulp (signs
  from a seed), and with the compressed SVC; and the raw against the
  compressed solve in float64 at N / 4: max |glob_sig - glob_sig'| /
  |sigma_yy| of each pair.

Prints one line per result, the card's name and power limit first, and
writes ``bridge_study.json`` to ``--out``.
"""
import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from pylabfea_tpu_torch import bridge, convert, ml_train
from pylabfea_tpu_torch.ops import constitutive as con
from pylabfea_tpu_torch.ops import jtensors as jt

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
#: (eps, nsteps) of ``calc_properties``'s defaults and of phase 15d
PROTOCOLS = {'default': (0.005, 20), 'smoke': (0.001, 10)}


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _card(device):
    if torch.device(device).type != 'cuda':
        return 'cpu'
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip()


def train(device):
    """(raw material record, compressed record, training set) of phase
    14a's SVC and 15a's compression."""
    z = np.load(os.path.join(DATA, 'train_hill.npz'))
    _, score, p = ml_train.train_svc(
        z['X'], z['y'].astype(np.float32), float(z['sy']), C=float(z['C']),
        gamma=float(z['gamma']), iters=int(z['iters']), dtype=torch.float32,
        device=device)
    CV = np.asarray(z['CV'], float)
    nu = CV[0, 1] / (CV[0, 0] + CV[0, 1])
    E = 2. * CV[3, 3] * (1. + nu)
    raw = convert.material_record_from(E, nu, sy=float(z['sy']), svc=p)
    red = convert.compress_record(raw, 'auto', device)
    return raw, red, z, score


def _hill_j2(hill, d):
    d = torch.as_tensor(np.asarray(d, float))[None]
    return float(hill.sy * jt.seq_j2_voigt(d) / con.seq_hill(hill, d))


def _onset(sel, CVps):
    uniax, fx, fy = bridge.LOAD_CASES[sel]
    if uniax in ('x', 'y'):
        return np.eye(6)['xy'.index(uniax)]
    return CVps @ np.array([fx, fy, 0., 0., 0., 0.])


def props(raw, red, z, device, nels, card):
    hill = convert.material_from_params(
        dict(hill=z['hill'], sy=float(z['sy']), khard=0., drucker=0.),
        is_svc=False, dtype=torch.float64, device='cpu')
    CVps = convert.elastic_cv(raw['E'], raw['nu'], planestress=True)
    out = []
    for tag, (eps, nsteps) in PROTOCOLS.items():
        for svc, mrec in (('raw', raw), ('auto', red)):
            for nel in nels:
                _sync(device)
                t0 = time.perf_counter()
                res = bridge.properties_record(
                    mrec, Nel=nel, eps=eps, nsteps=nsteps,
                    dtype=torch.float32, device=device)
                _sync(device)
                dt = time.perf_counter() - t0
                for sel, r in res.items():
                    on = _hill_j2(hill, _onset(sel, CVps))
                    last = _hill_j2(hill, r['sigeps']['sig'][-1])
                    row = dict(protocol=tag, svc=svc, nel=nel, case=sel,
                               seconds=dt, propJ2=float(r['propJ2']['ys']),
                               hill_onset=on, prop=float(r['prop']['ys']),
                               hill_last=last, scale=float(r['scale']))
                    row['errJ2'] = abs(row['propJ2'] - on) / on
                    row['err'] = abs(row['prop'] - last) / last
                    out.append(row)
                    print(f'[props] {tag} (eps {eps:g}, {nsteps} steps) '
                          f'{svc} Nel {nel} {sel}: propJ2 ys '
                          f'{row["propJ2"]:.4f} (Hill onset {on:.4f}, '
                          f'{row["errJ2"]:.2%}), prop ys {row["prop"]:.4f} '
                          f'(Hill at the last stress {last:.4f}, '
                          f'{row["err"]:.2%}), touch scale '
                          f'{row["scale"]:.4f}; {dt:.3f} s for 4 cases  '
                          f'[{card}]', flush=True)
    return out


def _solve(mrec, CV, N, dtype, device):
    rec = bridge.grid_record(N, N, [mrec], [CV], bct=(0., 0.002),
                             ubctop=(False, True))
    _sync(device)
    t0 = time.perf_counter()
    res = bridge.solve_record(rec, nsteps=20, n_inner=2, dtype=dtype,
                              compress=None, device=device)
    _sync(device)
    return res['sgl'][-1], time.perf_counter() - t0


def noise(raw, red, z, device, N, card):
    CV = np.asarray(z['CV'], float)
    ulp = np.random.default_rng(0).choice([-1., 1.], raw['dc'].shape)
    moved = dict(raw, dc=raw['dc'] * (1. + 2. ** -23 * ulp))
    runs = {}
    for name, mrec, n, dtype in (
            ('raw f32', raw, N, torch.float32),
            ('raw+1ulp f32', moved, N, torch.float32),
            ('auto f32', red, N, torch.float32),
            ('raw f64', raw, N // 4, torch.float64),
            ('auto f64', red, N // 4, torch.float64)):
        gsig, dt = _solve(mrec, CV, n, dtype, device)
        runs[name] = dict(N=n, glob_sig=gsig.tolist(), seconds=dt)
        print(f'[noise] {name} {n}x{n}: glob_sig '
              f'{np.array2string(gsig, precision=5, max_line_width=200)}, '
              f'{dt:.3f} s  [{card}]', flush=True)
    pairs = {}
    for a, b in (('raw+1ulp f32', 'raw f32'), ('auto f32', 'raw f32'),
                 ('auto f64', 'raw f64')):
        ga, gb = np.array(runs[a]['glob_sig']), np.array(runs[b]['glob_sig'])
        pairs[f'{a} - {b}'] = d = float(np.abs(ga - gb).max() / abs(gb[1]))
        print(f'[noise] |glob_sig {a} - {b}| / |sigma_yy| {d:.3e} at '
              f'{runs[a]["N"]}x{runs[a]["N"]}  [{card}]', flush=True)
    return dict(runs=runs, pairs=pairs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--N', type=int, default=1024)
    ap.add_argument('--nel', type=int, default=256)
    ap.add_argument('--out', default='chiprun_out')
    a = ap.parse_args(argv)
    card = _card(a.device)
    print(card, flush=True)
    os.makedirs(a.out, exist_ok=True)
    t0 = time.perf_counter()
    raw, red, z, score = train(a.device)
    print(f'[train] {raw["sv"].shape[0]} SVs, training accuracy {score:.2f} '
          f"%, 'auto' keeps {red['sv_red'].shape[0]} (relative RKHS error "
          f"{red['compress_rel']:.3e}); {time.perf_counter() - t0:.3f} s  "
          f'[{card}]', flush=True)
    np.savez_compressed(os.path.join(a.out, 'card_svc.npz'),
                        **{f'raw.{k}': np.asarray(v) for k, v in raw.items()},
                        **{f'red.{k}': np.asarray(v) for k, v in red.items()})
    out = dict(card=card, props=props(raw, red, z, a.device,
                                      sorted({8, a.nel}), card),
               noise=noise(raw, red, z, a.device, a.N, card))
    with open(os.path.join(a.out, 'bridge_study.json'), 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps(dict(card=card, noise=out['noise']['pairs'])))


if __name__ == '__main__':
    main()
