"""Time kernel E's launch forms and record-loop unrolling on one card.

    python -m pylabfea_tpu_torch.sweep_e [--out DIR]

Builds copies of ``csrc/svc_fgrad_mm.cu`` (beside copies of its headers)
into ``pylabfea_tpu_torch/build/sweep_e/``, each with one change: the
launch rule bypassed by one fixed form (a group of GT = 8, 16 or 32 threads
a point, or one thread a point), or the P-points-a-thread record loop
(``svc_eval.cuh`` ``svc_grad_accumulate``) unrolled 1 or 2 times in place
of 4.  Every copy must give the bits of the kernel as built (it raises
otherwise).  Times, float32, the trained 135-SV SVC of
``REF_SOLVE_svc.npz``, the copies in turns (forward, then backward):

* each launch form a launch in a CUDA graph (``chip_smoke.graph_ms``) at
  N = 64 .. 135168 points;
* the unroll variants with CUDA events at 2^20+17 x 135, 2^20+17 x 512
  (``chip_smoke.synthetic_svc``) and, in float64, 2^18 x 512.

Prints the card and one JSON line, and writes ``sweep_e.json`` to
``--out`` (default ``profile_out/``).  Needs a CUDA card and nvcc.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess

import torch

from pylabfea_tpu_torch.kernels import build

SRC = 'svc_fgrad_mm.cu'
#: the line of the launch rule (inside its per-feature-count lambda)
#: before which a fixed form is inserted
RULE = '    const int chains = fm.n() + 1;\n'
#: the record loop of svc_grad_accumulate
UNROLL = ('svc_grad_accumulate(', '#pragma unroll 4')
FORMS = {'GT=32': 'launch_group<T, 32>', 'GT=16': 'launch_group<T, 16>',
         'GT=8': 'launch_group<T, 8>', 'P=1': 'launch_points<T, 1>'}
SWEEP_N = (64, 256, 1024, 2112, 4096, 8448, 16896, 33792, 67584, 135168)


def _variant(name, dest):
    """Copy the sources into ``dest`` with the change ``name``."""
    os.makedirs(dest, exist_ok=True)
    for f in build.CSRC_DIR.glob('*.cuh'):
        shutil.copy(f, dest)
    src = (build.CSRC_DIR / SRC).read_text()
    if name in FORMS:
        assert src.count(RULE) == 1, 'launch rule not found'
        src = src.replace(RULE, f'    {FORMS[name]}(x, sv, dc, n, nsv, '
                          'gamma, rho, f, g, fm, s);\n    return;\n' + RULE)
    else:
        hdr = os.path.join(dest, 'svc_eval.cuh')
        text = open(hdr).read()
        at = text.index(UNROLL[1], text.index(UNROLL[0]))
        text = (text[:at] + f'#pragma unroll {name[len("unroll "):]}'
                + text[at + len(UNROLL[1]):])
        with open(hdr, 'w') as fh:
            fh.write(text)
    with open(os.path.join(dest, SRC), 'w') as fh:
        fh.write(src)
    return os.path.join(dest, SRC)


def _load(names, root):
    """Build every variant (one nvcc each, in parallel) and load them."""
    nvcc = build._nvcc()
    jobs = {}
    for name in names:
        d = os.path.join(root, name.replace(' ', '_').replace('=', ''))
        lib = os.path.join(d, 'lib.so')
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, '-o', lib, _variant(name, d)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'sweep_e: nvcc failed for {name}:\n{out}')
        dll = ctypes.CDLL(lib)
        for t in ('f32', 'f64'):
            fn = getattr(dll, f'pylabfea_svc_fgrad_mm_{t}')
            fn.argtypes = build.SIGNATURES[f'pylabfea_svc_fgrad_mm_{t}']
            fn.restype = ctypes.c_int
            fns[name, t] = fn
    return fns


def main():
    import chip_smoke
    from pylabfea_tpu_torch.compare import seeded_points, svc_params
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=os.path.join(
        os.path.dirname(build.PKG_DIR), 'profile_out'))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('sweep_e: needs a CUDA card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader', '--id=0'],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device('cuda', 0)
    fns = _load([*FORMS, 'unroll 1', 'unroll 2'],
                str(build.BUILD_DIR / 'sweep_e'))

    def inputs(n, kind, dtype):
        p = svc_params(kind)
        x, sv, dc = (torch.as_tensor(a, dtype=dtype, device=dev)
                     for a in (seeded_points(n), p['sv'], p['dc']))
        return x, sv, dc, p['gamma'], p['rho']

    def caller(name, x, sv, dc, gamma, rho):
        f = torch.empty(x.shape[0], dtype=x.dtype, device=dev)
        g = torch.empty_like(x)
        if name == 'built':
            return lambda: sk.svc_f_grad_mm(x, sv, dc, gamma, rho)
        fn = fns[name, 'f32' if x.dtype == torch.float32 else 'f64']

        def call():
            build.check(fn(x.data_ptr(), sv.data_ptr(), dc.data_ptr(),
                           x.shape[0], sv.shape[0], 6, gamma, rho,
                           f.data_ptr(), g.data_ptr(),
                           torch.cuda.current_stream().cuda_stream), name)
            return f, g
        return call

    def timed(names, args, time_fn):
        ms = {}
        for name in [*names, *names[::-1]]:
            ms.setdefault(name, []).append(time_fn(caller(name, *args)))
        return ms

    res = dict(card=card, forms={}, unroll={})
    for n in SWEEP_N:
        args = inputs(n, 'trained', torch.float32)
        ref = caller('built', *args)()
        for name in FORMS:
            out = caller(name, *args)()
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise RuntimeError(f'sweep_e: {name} at N={n} changes bits')
        res['forms'][n] = timed(['built', *FORMS], args,
                                lambda fn: chip_smoke.graph_ms(fn, 100))
        print(n, json.dumps(res['forms'][n]), flush=True)
    for label, n, kind, dt in (
            ('2^20+17 x 135', 2 ** 20 + 17, 'trained', torch.float32),
            ('2^20+17 x 512', 2 ** 20 + 17, 'synthetic', torch.float32),
            ('2^18 x 512 float64', 2 ** 18, 'synthetic', torch.float64)):
        args = inputs(n, kind, dt)
        ref = caller('built', *args)()
        for name in ('unroll 1', 'unroll 2'):
            out = caller(name, *args)()
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise RuntimeError(f'sweep_e: {name} at {label} changes '
                                   'bits')
        res['unroll'][label] = timed(
            ['built', 'unroll 1', 'unroll 2'], args,
            lambda fn: chip_smoke.timed_ms(fn, 20))
        print(label, json.dumps(res['unroll'][label]), flush=True)
    os.makedirs(opts.out, exist_ok=True)
    with open(os.path.join(opts.out, 'sweep_e.json'), 'w') as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
