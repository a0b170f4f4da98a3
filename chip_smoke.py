#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pylabfea_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for sm_90a), nvcc
under $CUDA_HOME or /usr/local/cuda, and PyTorch with CUDA; JAX is not
used.  Phases, each of which must pass:

1. device: card name and power limit (nvidia-smi), torch/CUDA versions,
   TF32 off;
2. build: nvcc builds the seven kernels from ``pylabfea_tpu_torch/csrc``
   (one compiler per source, in parallel);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with times (kernel E also in each of its launch forms);
   A, D and E also at F = 2, 9 and 15 features (2^20+17 points x 512
   synthetic SVs), G on 1024 stresses with the trained fixtures of those
   widths (``pylabfea_tpu_torch/data``);
4. the SVC return maps (512-SV synthetic SVC): the fast ``response_fast``
   (kernel A) on 2^20 states and the reference-faithful
   ``response_chunked`` (kernels D, E and G; F not at all) on 2^18 of
   them in float64 and on all of them in float32, each held against the
   CPU on 64 lanes;
5. the 2-D path: a 1024 x 1024 Hill-ML load step (the trained SVC of
   ``REF_SOLVE_svc.npz``), one untimed step then two timed warm-started
   steps, which must launch kernels A and B; then one timed step of the
   accuracy profile (``gate``, ``n_refine=1``, ``commit_f64``) with its
   round count and yield excess;
6. the same steps at 32 x 32 on the card and on the CPU (plain versions),
   in float32 and float64, which must agree; a fresh 0.5 step of the
   accuracy profile in float32, and the main path's four-step history
   (three plain steps, then the accuracy profile's) in float64 and
   float32;
7. the 3-D path: a 128^3 hex8 box (2,097,152 elements) with J2 + linear
   hardening, the ``bench.py`` protocol (an untimed 0.4 step, a timed
   warm-started 0.3 step), which must launch kernel C and meet the uniaxial
   closed form; then the same at 64^3;
8. three 3-D steps at 8^3 on the card and on the CPU, float64 and float32,
   which must agree;
9. the REF_SOLVE boundary-value problem (``bench.py`` ``ref_solve_fields``
   protocol: eight gated load steps with the faithful tail) at 8^2, 16^2
   and 32^2 in float32 and at 8^2 in float64, one untimed 8^2 solve and
   one timed solve each, which must launch kernels D, E and G (and not F;
   D and G at most ``MAX_DG_LAUNCHES`` times) and land on the converged
   float64 answers of ``REF_SOLVE.json``; the float64 8^2 solve also on the
   CPU, which must agree;
10. ``bench.py``'s 1024 x 1024 3-material inclusion (Hill sdim=6, J2
   sdim=3, elastic E = 1e3; general BCs, corner pin): an untimed and a
   timed warm-started 0.25 step, which must launch kernel B; 10b. the
   plane-stress laminate (5 sections) at 1024 x 1024, one step, with its
   E_yy beside the Voigt average;
11. ``bench.py``'s 3-D inclusion: ``incl3d_parity_16cubed`` (float32
   against float64, < 5e-4) and a timed 64^3 step, which must launch
   kernel C; 11b. the reference-faithful 3-D route (``load_step3(fast=
   False)``) at 8^3 with the trained SVC, which must launch D, E and G
   and not F;
12. float64 card against CPU on these paths: the inclusion, the laminate
   (E_yy within 1e-3 of Voigt) and a two-group SVC + elastic mesh (A and
   D on blocks of odd size) at 32^2, the 3-D inclusion at 8^3 (1e-9,
   the same CG histories), the 3-D faithful route at 4^3 (1e-6);
13. the SVC feature layouts beyond 6-D stress, with the trained fixtures:
   13a. phase 5's 1024 x 1024 path with the work-hardening SVC (15
   features; kernel A at F = 15, the batch-mean khard_of of each step);
   13b. the same with the cylindrical SVC (2 features, through the
   closed-form eigensolver on 2^20 lanes); 13c. phase 9's solve at 16 x 16
   float32 with the cylindrical SVC (D, E and G at F = 2, F not at all);
   13d. the GSH_3 texture SVC (9 features, the kernels' runtime-F form):
   ``response_fast`` on 2^20 states and ``ml_yf_dist`` on 2^16 (A, D, G),
   64 lanes of each against the CPU; 13e. float64 card against CPU: the
   13a/13b steps at 32 x 32 (1e-9, the same CG histories) and the
   cylindrical faithful solve's first 4 steps at 4 x 4 (1e-6);
14. training and inverse identification: 14a. ``ml_train.train_svc`` on
   the card (f32, 4000 iterations) on the ~15,000-point Hill training set
   of ``examples/train_hill.py`` (``pylabfea_tpu_torch/data/
   train_hill.npz``), its accuracy and its decision values against the
   JAX trainer's on a probe set; 14b. that SVC served: ``ml_yf_dist``
   (kernel G) against the analytic Hill locus, ``response_fast`` on 2^20
   states (A) and one warm 1024 x 1024 step (A, B, D), which must launch
   A, B, D and G, then G on the same stresses and A and D at 2^20 points
   against their plain versions at the trained SVC's size; 14c. ``calibrate.fit_plasticity`` round trips on 1024 paths x
   30 steps simulated on the card (f64 and f32 unrolled, f64 implicit)
   under the JAX package's round-trip tolerances; 14d. ``femu.fit_field``
   on the 16 x 16 two-material inclusion (sy and hill[0] within 1e-6);
   14e. f64 card against CPU at small size: ``simulate_paths``, one
   ``step_implicit`` with one forward-mode column, ``fit_svc``'s dual
   variables (1e-9); no CUDA-graph capture of phase 14 may fail;
15. the host-model bridge (``bridge.py``) on records built from arrays
   (phase 19 hands it the port's host ``Model``): 15a. ``reduce_svc`` of 14a's SVC at 'auto' (k, the
   relative RKHS error, max |f - f~| on 2^16 probes within abs_tol, the
   compressed locus by 14b's rule), A and D at 2^20 points x k against
   their plain versions; 15b. ``solve_record`` (``solve_on_device``) at
   1024 x 1024 from a record built from arrays, compress 'auto' and
   None, 20 steps (A, B, D); 15c. ``solve_record_adaptive`` on
   ``tests/test_bridge.py``'s ``_model`` at 1024 x 1024 (J2, f64, fast;
   B) and on the compressed SVC at 32 x 32 (f64, faithful; D, E, G, G
   also in the fixed-direction root find), then E at that shape and G
   in that root find against their plain versions; 15d.
   ``properties_record`` (``calc_properties_on_device``) at 256 x 256
   (A, B, G) against the Hill locus of the training material; 15e. the
   committed records of ``ACCURACY.md``'s golden models
   (``pylabfea_tpu_torch/data/bridge_*.npz``) in f64 on the card and the
   CPU, and ``hessian`` / ``epl_dot`` / ``c_tan`` card vs CPU;
16. ``bench.py``'s ``step_s_2048`` row: one cold and one warm 0.25
   ``load_step_split`` at 2048 x 2048 with phase 5's SVC (the 'auto'
   compression count printed beside it), which must launch A, B and D,
   then B, A and D against their plain versions at its shapes;
17. the domain decomposition (``pylabfea_tpu_torch.parallel``): 17a.
   ``strip_load_step`` on phase 5's 1024 x 1024 geometry at world size 1
   (two-level Schwarz; A and B) within 5e-3 of the unsharded step, with
   both times; 17b. ``solve_uniaxial3_slab`` on the 64^3 box at world size
   1 (C) within 1e-4 of ``fe3d.solve_uniaxial3``; 17c. strips at 256^2
   (f32, f64, the grouped inclusion) and the slab at 32^3 on W ranks
   spawned on the host (W = min(4, cards) under NCCL with two cards or
   more, else 2 ranks on the one card under Gloo) against world size 1
   (f32 1e-4, f64 1e-9, duplicated layers bitwise); then C at the slab
   block shapes.  Phases 16 and 17 print their seconds (budget 150 s);
18. element-axis sharding (``parallel.mesh``, ``mesh3d``) and the
   path-sharded fit: 18a. the flat 2-D step sharded over the elements on
   phase 5's 1024 x 1024 geometry (a cold and a warm 0.25 step, the scale
   demo's Jacobi-CG settings; A) at world size 1 against the unsharded
   flat step (equal CG histories, 1e-6), its seconds beside phase 5's
   multigrid step; 18b. the 3-D step sharded over element x-planes on
   ``bench.py``'s 64^3 row (C) against ``load_step3`` (equal CG
   histories, 1e-6), with ``field_volumes`` of its state; 18c. on 17c's
   W ranks: the 2-D step at 256^2 (f32) and 64^2 (f64), the 3-D step at
   32^3 (f32, f64), the fit on 256 paths x 30 steps (f64, 10 LM steps)
   against world size 1 (f64 1e-9, khard 1e-8; f32 glob_sig 1e-4), every
   rank launching A or C (budget 60 s);
19. the host profile (``import pylabfea_tpu_torch as FE``: ``Material``,
   ``Model``, numpy as in the JAX package) on ``examples/train_hill.py``'s
   workflow: 19a. ``train_SVC(backend='jax')``, the training data on the
   host and the fit on the card (score at least 95 %); 19b. the example's
   12 x 4 laminate with the Hill reference in the ML section, the host
   ``Model.solve()`` against ``bridge.solve_on_device_adaptive`` (f64,
   faithful; B) within ``tests/test_bridge.py:283-288``'s bounds, and the
   ML law's host rows against ``bridge.HostLaw`` on the card in f64
   (``calc_seq``, ``_yf_rows`` through D, ``_sflow_rows`` within 1e-12;
   ``_ml_full_yf_rows`` through G within 1e-4 MPa); 19c. the example's
   model meshed 768 x 256 on the host, ``read_model`` against
   ``grid_record`` array for array, ``solve_on_device`` (f32, 'auto', 2
   steps; A, B, D); 19d. ``calc_properties_on_device`` of the trained
   ``Material`` at 16^2 (A, B, G), every strength within 5 % of the Hill
   locus; 19e. the UMAT export and import, ``save_model`` / ``load_model``
   (bitwise) and ``compress_svc(tol=1e-3)`` on the card (its RKHS bound
   on 2^16 probes); no ``jax``, ``sklearn`` or ``pylabfea_tpu`` module
   may be imported; then B, A, D and G at phase 19's shapes against their
   plain versions.

Every launch count of a path is set to 0 just before that path runs and
read just after (also by feature count, ``launches_by_nfeat``).  The last
two lines are a JSON object with every kernel's launches, error, times and
bound (a kernel at another feature count than 6 as ``name[F=n]``, with its
launches on the path of phase 13 that ran it; A, D and G at the SVC
trained in 14a as ``name[card-trained]``, with their launches in 14b;
A, B, D, E and G on the bridge's path as ``name[bridge]``, with their
launches in 15b-15d; A, B and D on the 2048^2 row as ``name[2048]``, B and
A on 17a's strip as ``name[strip]``, C on 17b's slab as
``k_apply3[slab]``, A on 18a's element share as ``svc_f_grad[elem]``, C on
18b's x-plane block as ``k_apply3[elem]``, B, A, D and G on phase 19's
path as ``name[host]``, with their launches in 19b-19d), and ``{"ok": true,
"device": {...}}``.
Any failure raises and exits non-zero without those lines.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(ROOT, 'REF_SOLVE_svc.npz')
#: the trained SVC fixtures of the other feature layouts (work hardening,
#: cylindrical, texture; ``tools/make_torch_svc_fixtures.py``)
DATA = os.path.join(ROOT, 'pylabfea_tpu_torch', 'data')
REF_JSON = os.path.join(ROOT, 'REF_SOLVE.json')
#: states of the float64 faithful return-map phase (2^20 would take about
#: 100 s there) and of the Brent-step kernel check
FAITHFUL_N = 2 ** 18
SY = 150.
#: J2 + linear hardening of the 3-D path (bench.py fe3d_fields), MPa
E3, KHARD3 = 200.e3, 500.
#: shapes up to this many points also get a device time from a CUDA graph
SMALL_N = 4096
#: H100 SXM data sheet: HBM3 bytes/s and float32 FLOP/s outside the tensor
#: cores, at the full 700 W power limit
HBM_BPS, F32_FLOPS = 3.35e12, 67.e12


def fail(msg):
    raise RuntimeError(f'chip_smoke: {msg}')


#: seconds between consecutive log lines, summed by the phase that the
#: later line's tag names ('[15b solve_on_device] ...' -> '15b'): a line
#: reports the work that ran before it
CLOCK = {'start': time.perf_counter(), 'last': time.perf_counter(),
         'phases': {}}


def log(msg):
    now = time.perf_counter()
    if msg.startswith('['):
        phase = msg[1:].split(']')[0].split()[0]
        CLOCK['phases'][phase] = CLOCK['phases'].get(phase, 0.) \
            + now - CLOCK['last']
    CLOCK['last'] = now
    print(msg, flush=True)


def timed_ms(fn, reps, warm=1):
    """Mean milliseconds of ``fn`` over ``reps`` calls on the card (CUDA
    events), after ``warm`` untimed calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps):
    """Mean device milliseconds of ``fn`` a call: ``reps`` calls captured
    in one CUDA graph and replayed, so that no host work lies between the
    launches (at small shapes ``timed_ms`` measures the host's launch
    path)."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                            # warm on the capturing stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return timed_ms(graph.replay, 3) / reps


def by_rows(fn, x, rows):
    """``fn`` on ``x``, in chunks of ``rows`` rows where ``rows`` is given
    (the plain SVC versions' (N, nsv) matrices at 2^20 points x thousands
    of SVs outgrow the card's memory)."""
    if rows is None:
        return fn(x)
    for i in range(0, x.shape[0], rows):
        fn(x[i:i + rows])


def chunks(rows):
    return '' if rows is None else f' (in chunks of {rows} points)'


def bound_ms(nbytes, flops):
    """Least time on the card for work that moves ``nbytes`` (each input
    read once, each output written once) and does ``flops`` float32
    operations: (ms, 'bytes' | 'operations')."""
    tb, tf = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize()


def elastic_cv(E=200.e3, nu=0.3, planestress=False):
    """Isotropic elastic stiffness (MPa), E = 200 GPa and nu = 0.3 unless
    given; the reduced one of a plane-stress element with
    ``planestress``."""
    from pylabfea_tpu_torch import convert
    return convert.elastic_cv(E, nu, planestress)


def synthetic_svc(nsv=512, nfeat=6):
    """The 512-SV synthetic SVC of ``bench.py`` (``flagship``): unit
    directions at radii 0.9 / 1.1 with dual coefficients -/+0.5; with
    ``nfeat`` other than 6 the same construction in that many
    features."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(nsv, nfeat))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    lab = np.where(np.arange(nsv) % 2 == 0, 0.9, 1.1)
    return dict(hill=np.ones(6), sy=SY, khard=0., drucker=0.,
                sv=u * lab[:, None], dc=np.where(lab > 1., 1., -1.) * 0.5,
                rho=0.05, gamma=2.5, scale_seq=SY)


def return_map_states(N, seed=1, sy=SY):
    """Stress states near the yield locus (of yield strength ``sy``) and
    strain increments that drive plastic flow (``bench.py`` return-map
    workload)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * sy * rng.uniform(0.55, 0.95, (N, 1))
    deps = rng.normal(0., 1.0e-4, (N, 6))
    return sig, deps


def phase_device():
    import torch
    from pylabfea_tpu_torch import config
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f'[1 device] {torch.cuda.get_device_name(0)}; torch '
        f'{torch.__version__}, CUDA {torch.version.cuda}, python '
        f'{sys.version.split()[0]}; TF32 off: {config.tf32_off()}')
    if not config.tf32_off():
        fail('TF32 is enabled')
    return card


def ptxas_table(text):
    """Each compiled kernel of an nvcc ``-Xptxas -v`` log: (source, kernel
    name demangled by cu++filt where the toolkit has it, registers, spill
    store and load bytes, stack frame bytes)."""
    import re
    rows, src, cur = [], None, None
    for ln in text.splitlines():
        if ln.startswith('--- '):
            src = ln[4:].strip()
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = [src, m.group(1), 0, 0, 0, 0]
            rows.append(cur)
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', ln)
        if m and cur is not None:
            cur[5], cur[3], cur[4] = (int(g) for g in m.groups())
        m = re.search(r'Used (\d+) registers', ln)
        if m and cur is not None:
            cur[2] = int(m.group(1))
    filt = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'cu++filt')
    if rows and os.path.exists(filt):
        out = subprocess.run([filt], input='\n'.join(r[1] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, n in zip(rows, names):
                n = n[:n.rindex('>(') + 1] if '>(' in n else n
                r[1] = re.sub(r'^void |\(anonymous namespace\)::|pylabfea::|'
                              r'\((int|bool)\)', '', n)
    return rows


def phase_build():
    from pylabfea_tpu_torch.kernels import build
    t0 = time.perf_counter()
    built = build.load()
    wall = time.perf_counter() - t0
    log(f'[2 build] {", ".join(p.name for p in built.paths)}: nvcc '
        f'{built.seconds:.2f} s (parallel), load {wall:.2f} s')
    rows = ptxas_table(built.log)
    for src, name, regs, sst, sld, stack in rows:
        log(f'    ptxas: {src} {name}: {regs} registers, spill stores '
            f'{sst} B, loads {sld} B, stack {stack} B')
    spills = [r for r in rows if r[3] or r[4]]
    log(f'[2 build] {len(rows)} kernels, {len(spills)} with spills'
        + (f' ({", ".join(r[1] for r in spills)})' if spills else ''))


def check_kapply(device, NX, NY, reps, card):
    import torch
    from pylabfea_tpu_torch.ops import fe_kernels as fek, stencil
    rng = np.random.default_rng(0)
    md = fek.rect_mesh(NX, NY, LX=1., LY=1.5, dtype=torch.float32,
                       device=device)
    els = torch.as_tensor(rng.uniform(0.5, 2.0, (36, NX, NY)) * 1e5,
                          dtype=torch.float32, device=device)
    Kp = fek.element_stiffness_planes(md, els)
    u0, u1 = (torch.as_tensor(rng.normal(size=(NX + 1, NY + 1)),
                              dtype=torch.float32, device=device)
              for _ in range(2))
    out = stencil.k_apply(Kp, u0, u1)
    ref = stencil.k_apply_plain(Kp, u0, u1)
    sync(device)
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    scale = max(float(r.abs().max()) for r in ref)
    ok = err <= 2e-6 * scale
    ms = timed_ms(lambda: stencil.k_apply(Kp, u0, u1), reps)
    pms = timed_ms(lambda: stencil.k_apply_plain(Kp, u0, u1),
                   max(reps // 4, 1))
    gbs = Kp.numel() * 4 / (ms * 1e-3) / 1e9
    log(f'[3 kernel B] k_apply {NX}x{NY} f32: max|err| {err:.3e} '
        f'(bound 2e-6*{scale:.3e} = {2e-6 * scale:.3e}) '
        f'{"ok" if ok else "FAIL"}; kernel {ms:.4f} ms ({gbs:.0f} GB/s '
        f'of stiffness planes), plain {pms:.4f} ms  [{card}]')
    if not ok:
        fail(f'k_apply {NX}x{NY} disagrees with its plain version')
    # every Ke entry read once and used in one multiply-add
    bnd = bound_ms(Kp.numel() * 4 + 4 * u0.numel() * 4, 2 * Kp.numel())
    return err, ms, pms, bnd


def kapply3_inputs(shape, dtype, device, seed=0):
    """Symmetric diagonally-dominant random tangent volumes (36, NX, NY, NZ)
    and random nodal volumes, made on the card from a seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    NX, NY, NZ = shape
    C6 = torch.randn((6, 6, NX, NY, NZ), generator=gen, dtype=dtype,
                     device=device)
    C6 = 0.5 * (C6 + C6.transpose(0, 1))
    C6 += 6. * torch.eye(6, dtype=dtype, device=device)[:, :, None, None,
                                                         None]
    u = [torch.randn((NX + 1, NY + 1, NZ + 1), generator=gen, dtype=dtype,
                     device=device) for _ in range(3)]
    return C6.reshape(36, NX, NY, NZ), u


def check_kapply3(device, shape, dtype, rtol, reps, card):
    """Kernel C against its plain version at ``shape``; with ``reps``, the
    kernel and plain times and the bound as well."""
    import torch
    from pylabfea_tpu_torch.ops import volume
    Cp, u = kapply3_inputs(shape, dtype, device)
    NX, NY, NZ = shape
    lx, ly, lz = 1. / NX, 1.3 / NY, 0.7 / NZ
    out = volume.k_apply3(Cp, *u, lx, ly, lz)
    again = volume.k_apply3(Cp, *u, lx, ly, lz)
    ref = volume.k_apply3_plain(Cp, *u, lx, ly, lz)
    sync(device)
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    scale = max(float(r.abs().max()) for r in ref)
    same = all(torch.equal(o, a) for o, a in zip(out, again))
    ok = err <= rtol * scale and same
    name = 'x'.join(map(str, shape))
    log(f'[3 kernel C] k_apply3 {name} {dtype}: max|err| {err:.3e} (bound '
        f'{rtol:g}*{scale:.3e} = {rtol * scale:.3e}); a second launch '
        f'gives the same bits {same} {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'k_apply3 {name} {dtype} disagrees with its plain version or '
             'with itself')
    if not reps:
        return err, None, None, None
    ms = timed_ms(lambda: volume.k_apply3(Cp, *u, lx, ly, lz), reps)
    pms = timed_ms(lambda: volume.k_apply3_plain(Cp, *u, lx, ly, lz), 2)
    isz = Cp.element_size()
    nel, nn = Cp[0].numel(), u[0].numel()
    # bench.py's single-pass traffic model: tangents once, u twice, out once
    gbs = (36 * nel + 9 * nn) * isz / (ms * 1e-3) / 1e9
    # the bound: every input read once, every output written once; 612
    # flops per element (the kernel's transforms, 7 modes with their 138
    # tangent multiply-adds, the transposed transforms, the node sums)
    bnd = bound_ms((36 * nel + 6 * nn) * isz, 612 * nel)
    log(f'[3 kernel C] k_apply3 {name} {dtype}: kernel {ms:.4f} ms '
        f'({gbs:.0f} GB/s by the bench.py traffic model), plain {pms:.4f} '
        f'ms, bound {bnd[0]:.4f} ms ({bnd[1]}, {bnd[0] / ms:.0%} of it)  '
        f'[{card}]')
    return err, ms, pms, bnd


def check_svc(device, N, params, reps, card, n_ref=None, plain_rows=None):
    """Kernel A at N points against its plain float64 version (on the
    first ``n_ref`` points, all by default: the plain version's (N, nsv)
    matrices), then kernel and plain float32 times (the plain one in
    chunks of ``plain_rows`` points where given) and the bound."""
    import torch
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    rng = np.random.default_rng(2)
    u = rng.normal(size=(N, np.shape(params['sv'])[1]))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    x64 = torch.as_tensor(u * rng.uniform(0.3, 1.3, (N, 1)),
                          dtype=torch.float64, device=device)
    sv64 = torch.as_tensor(params['sv'], dtype=torch.float64, device=device)
    dc64 = torch.as_tensor(params['dc'], dtype=torch.float64, device=device)
    x, sv, dc = x64.float(), sv64.float(), dc64.float()
    gamma, rho = float(params['gamma']), float(params['rho'])
    sdc = max(1., float(dc64.abs().sum()))
    ftol = 2e-5 * sdc
    gtol = ftol * 2. * gamma * (float(x64.abs().max())
                                + float(sv64.abs().max()))
    errs = []
    nr = N if n_ref is None else n_ref
    for with_grad in (True, False):
        f, g = sk.svc_f_grad(x, sv, dc, gamma, rho, with_grad)
        fr, gr = sk.svc_f_grad_plain(x64[:nr], sv64, dc64, gamma, rho,
                                     with_grad)
        sync(device)
        ef = float((f[:nr].double() - fr).abs().max())
        eg = float((g[:nr].double() - gr).abs().max()) if with_grad else 0.
        ok = ef <= ftol and eg <= gtol
        log(f'[3 kernel A] svc_f_grad N={N} nsv={sv.shape[0]} '
            f'F={sv.shape[1]} with_grad={with_grad} f32 vs plain f64 (first '
            f'{nr} points): max|err| f {ef:.3e} '
            f'(bound {ftol:.3e}), g {eg:.3e} (bound {gtol:.3e}) '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'svc_f_grad nsv={sv.shape[0]} disagrees with its plain '
                 'version')
        errs.append(max(ef, eg))
    ms = timed_ms(lambda: sk.svc_f_grad(x, sv, dc, gamma, rho), reps)
    pms = timed_ms(lambda: by_rows(lambda xx: sk.svc_f_grad_plain(
        xx, sv, dc, gamma, rho), x, plain_rows), max(reps // 4, 1))
    nsv, F = sv.shape
    gexp = N * nsv / (ms * 1e-3) / 1e9
    # x, sv, dc read, f and g written once; 5F + 4 flops per point-SV pair
    # (F subtracts and F multiply-adds of the distance, the gamma product,
    # the exp, the dc product, the f sum and F multiply-adds of g)
    bnd = bound_ms((2 * N * F + N + nsv * (F + 1)) * 4,
                   N * nsv * (5 * F + 4))
    log(f'[3 kernel A] svc_f_grad N={N} nsv={nsv} F={F} f32 with_grad: '
        f'kernel {ms:.4f} ms ({gexp:.1f} G point-SV pairs/s), plain '
        f'{pms:.4f} ms{chunks(plain_rows)}, bound {bnd[0]:.4f} ms '
        f'({bnd[1]}, {bnd[0] / ms:.0%} of it)  [{card}]')
    if N <= SMALL_N:
        dms = graph_ms(lambda: sk.svc_f_grad(x, sv, dc, gamma, rho), reps)
        log(f'[3 kernel A] svc_f_grad N={N} nsv={nsv} f32 with_grad: '
            f'device {dms:.4f} ms a launch in a CUDA graph ({bnd[0] / dms:.0%}'
            f' of the bound)  [{card}]')
    return max(errs), ms, pms, bnd


def check_svc_mm(device, N, params, reps, card, which, n_ref=None,
                 plain_rows=None):
    """Kernel D (``which='D'``, the decision function) or E (``'E'``, value
    and gradient), both with matmul-expansion distances: f32 at N points
    against the plain f64 version under kernel A's bounds, f64 at 4099
    points against the plain f64 version (1e-12 max(1, sum|dc|)), then
    kernel and plain f32 times and the bound.  The f32 comparison takes
    the first ``n_ref`` points (all by default); the plain version is
    timed in chunks of ``plain_rows`` points where given."""
    import torch
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    rng = np.random.default_rng(2)
    u = rng.normal(size=(N, np.shape(params['sv'])[1]))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    x64 = torch.as_tensor(u * rng.uniform(0.3, 1.3, (N, 1)),
                          dtype=torch.float64, device=device)
    sv64 = torch.as_tensor(params['sv'], dtype=torch.float64, device=device)
    dc64 = torch.as_tensor(params['dc'], dtype=torch.float64, device=device)
    x, sv, dc = x64.float(), sv64.float(), dc64.float()
    gamma, rho = float(params['gamma']), float(params['rho'])
    sdc = max(1., float(dc64.abs().sum()))
    grad = which == 'E'

    def kern(*a):
        if grad:
            return sk.svc_f_grad_mm(*a, gamma, rho)
        return sk.svc_decision(*a, gamma, rho), None

    def plain(*a):
        return sk.svc_f_grad_plain(*a, gamma, rho, with_grad=grad)

    name = 'svc_f_grad_mm' if grad else 'svc_decision'
    errs = []
    nr = N if n_ref is None else n_ref
    for xx, s_, d_, ftol in ((x, sv, dc, 2e-5 * sdc),
                             (x64[:4099], sv64, dc64, 1e-12 * sdc)):
        gtol = ftol * 2. * gamma * (float(x64.abs().max())
                                    + float(sv64.abs().max()))
        f, g = kern(xx, s_, d_)
        n = min(nr, xx.shape[0])
        fr, gr = plain(x64[:n], sv64, dc64)
        sync(device)
        ef = float((f[:n].double() - fr).abs().max())
        eg = float((g[:n].double() - gr).abs().max()) if grad else 0.
        ok = ef <= ftol and eg <= gtol
        log(f'[3 kernel {which}] {name} N={xx.shape[0]} nsv={sv.shape[0]} '
            f'F={sv.shape[1]} {xx.dtype} vs plain f64: max|err| f {ef:.3e} '
            f'(bound {ftol:.3e}), g {eg:.3e} (bound {gtol:.3e}) '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'{name} nsv={sv.shape[0]} {xx.dtype} disagrees with its '
                 'plain version')
        errs.append(max(ef, eg))
    ms = timed_ms(lambda: kern(x, sv, dc), reps)
    pms = timed_ms(lambda: by_rows(lambda xx: plain(xx, sv, dc), x,
                                   plain_rows), max(reps // 4, 1))
    nsv, F = sv.shape
    # x, sv, dc read, f (and g) written once.  Operations per point-SV
    # pair: 2F of the cross term's F multiply-adds, 3 of the distance (an
    # add and a multiply-add), the gamma product, the exp, 2 of the dc
    # multiply-add into f: 2F + 7; E adds 2F of the F multiply-adds of
    # w @ sv: 4F + 7
    outs = N * (F + 1) if grad else N
    bnd = bound_ms((N * F + outs + nsv * (F + 1)) * 4,
                   N * nsv * ((4 if grad else 2) * F + 7))
    log(f'[3 kernel {which}] {name} N={N} nsv={nsv} F={F} f32: kernel '
        f'{ms:.4f} ms ({N * nsv / (ms * 1e-3) / 1e9:.1f} G point-SV '
        f'pairs/s), plain '
        f'{pms:.4f} ms{chunks(plain_rows)}, bound {bnd[0]:.4f} ms '
        f'({bnd[1]}, {bnd[0] / ms:.0%} of it)  [{card}]')
    if N <= SMALL_N:
        dms = graph_ms(lambda: kern(x, sv, dc), reps)
        log(f'[3 kernel {which}] {name} N={N} nsv={nsv} f32: device '
            f'{dms:.4f} ms a launch in a CUDA graph ({bnd[0] / dms:.0%} of '
            f'the bound)  [{card}]')
    return max(errs), ms, pms, bnd


def brent_states(N, dtype, device, seed=5):
    """A random Brent state for every branch of the step: finished lanes,
    brackets and none, swaps, secant (xpre == xblk) and inverse quadratic
    steps, exact zeros of f."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)

    def r(scale=1.):
        return torch.randn(N, generator=gen, dtype=dtype,
                           device=device) * scale

    def coin(p):
        return torch.rand(N, generator=gen, device=device) < p

    xpre, xcur = 100. + r(5.), 100. + r(5.)
    xblk = torch.where(coin(0.3), xpre, 100. + r(5.))
    fcur = torch.where(coin(0.05), 0., r())
    st = dict(done=coin(0.2), ok=coin(0.1), root=r(), xpre=xpre, fpre=r(),
              xcur=xcur, fcur=fcur, xblk=xblk, fblk=r(), spre=r(1e-3),
              scur=r(1e-3))
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in st.items()}


def check_brent_step(device, N, reps, card):
    """Kernel F against its plain version on the card: the same bits in
    float32 and float64 (one IEEE operation at a time, in the same
    order), then kernel and plain times and the bound."""
    import torch
    from pylabfea_tpu_torch.ops import rootfind
    err = 0.
    for dtype in (torch.float32, torch.float64):
        st = brent_states(N, dtype, device)
        ref = rootfind.brent_step_plain(st, 1.e-5, rootfind._RTOL)
        out = rootfind.brent_step({k: v.clone() for k, v in st.items()},
                                  1.e-5, rootfind._RTOL)
        sync(device)
        same = all(torch.equal(out[k], ref[k]) for k in rootfind.STATE)
        e = max(float((out[k].double() - ref[k].double()).abs().max())
                for k in rootfind.STATE)
        log(f'[3 kernel F] brent_step N={N} {dtype}: bitwise equal to the '
            f'plain version {same} (max|err| {e:.3e}, bound 0)')
        if not same:
            fail(f'brent_step {dtype} differs from its plain version')
        err = max(err, e)
    st = brent_states(N, torch.float32, device)
    ms = timed_ms(lambda: rootfind.brent_step(st, 1.e-5, rootfind._RTOL),
                  reps)
    st = brent_states(N, torch.float32, device)
    pms = timed_ms(lambda: rootfind.brent_step_plain(st, 1.e-5,
                                                     rootfind._RTOL), reps)
    # 9 float32 arrays and 2 bool arrays read and written once; about 40
    # operations per lane
    bnd = bound_ms(2 * N * (9 * 4 + 2), 40 * N)
    log(f'[3 kernel F] brent_step N={N} f32: kernel {ms:.4f} ms, plain '
        f'{pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})  [{card}]')
    return err, ms, pms, bnd


def check_yf_root(device, N, mat_of, reps, card, label, sig_np=None):
    """Kernel G against its plain version on the card, both through
    ``ml_yf_dist`` on N stresses at 0.3-2 sy along random directions
    (inside, across and outside the locus), or on the N stresses
    ``sig_np`` where given.  Float64: every finite lane's
    distance within 1e-6 of the distances' scale (a Brent iterate that
    flips moves a root by up to xtol), the same lanes finite.  Float32:
    phase 4's rule, at most 1e-3 of the lanes non-finite and at least 48
    of 64 sampled lanes within 1e-3 (rounding decides per lane between
    Brent's root and the fallback).  Then kernel and plain float32 times
    and the bound, from the evaluations the kernel counted (each nsv x
    (2F + 7) operations).  A work-hardening material gets plastic strains
    of 2e-3 (fixed features along each ray).  Returns (max error of the
    agreeing lanes, ms, plain ms, bound)."""
    import torch
    from pylabfea_tpu_torch.ops import constitutive as con
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    rng = np.random.default_rng(4)
    u = rng.normal(size=(N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig_np = u * SY * rng.uniform(0.3, 2.0, (N, 1)) if sig_np is None \
        else sig_np
    epl_np = rng.normal(0., 2e-3, (N, 6))
    pick = np.random.default_rng(5).choice(N, 64, replace=False)
    errs, seen = [], {}

    def kernel(*a, **kw):
        seen['call'] = a, kw
        return sk.svc_yf_root(*a, **kw)

    for dtype in (torch.float32, torch.float64):
        mat = mat_of(dtype)
        sig = torch.as_tensor(sig_np, dtype=dtype, device=device)
        peeq = torch.zeros(N, dtype=dtype, device=device)
        epl = torch.as_tensor(epl_np, dtype=dtype, device=device) \
            if con._has_wh(mat) else None
        d = con.ml_yf_dist(mat, sig, peeq, epl, root=kernel)
        dp = con.ml_yf_dist(mat, sig, peeq, epl, root=sk.svc_yf_root_plain)
        sync(device)
        fin, fin_k = torch.isfinite(dp), torch.isfinite(d)
        scale = float(dp[fin].abs().max())
        diff = torch.where(fin & fin_k, (d - dp).abs(), 0.).cpu().numpy()
        nbad = int((~fin_k).sum())
        if dtype == torch.float64:
            err = float(diff.max())
            ok = bool((fin == fin_k).all()) and err <= 1e-6 * scale
            rule = (f'{N - nbad} finite lanes, max|err| {err:.3e} (bound '
                    f'1e-6*{scale:.1f} = {1e-6 * scale:.3e})')
        else:
            fk = fin_k.cpu().numpy()[pick] & fin.cpu().numpy()[pick]
            agree = fk & (diff[pick] <= 1e-3 * scale)
            err = float(diff[pick][agree].max()) if agree.any() else np.inf
            ok = nbad <= 1e-3 * N and int(agree.sum()) >= 48
            rule = (f'{nbad} non-finite lanes (bound {1e-3 * N:.0f}); '
                    f'{int(agree.sum())} of 64 sampled lanes within 1e-3*'
                    f'{scale:.1f} (bound 48), max|err| of those {err:.3e}')
        log(f'[3 kernel G] svc_yf_root N={N} {label} nsv={mat.sv.shape[0]} '
            f'F={mat.sv.shape[1]} {dtype} vs plain, distances of '
            f'ml_yf_dist: {rule} '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'svc_yf_root {label} {dtype} disagrees with its plain '
                 'version')
        errs.append(err)
        if dtype == torch.float32:
            a, kw = seen['call']
            evals = torch.zeros(N, dtype=torch.int32, device=device)
            sk.svc_yf_root(*a, **kw, evals=evals)
            nev = int(evals.sum())
            ms = timed_ms(lambda: sk.svc_yf_root(*a, **kw), reps)
            pms = timed_ms(lambda: sk.svc_yf_root_plain(*a, **kw), 1)
            nsv, F = mat.sv.shape
            fmap = a[7]
            nextra = 0 if fmap.extra is None else fmap.extra.numel()
            # su, start, top, the per-lane features, sv, dc read and xs,
            # ok written once
            bnd = bound_ms((a[0].numel() + 2 * N + nextra + (F + 1) * nsv
                            + N) * 4 + N, nev * nsv * (2 * F + 7))
    log(f'[3 kernel G] svc_yf_root N={N} {label} nsv={nsv} F={F} f32: '
        f'kernel '
        f'{ms:.4f} ms ({nev} evaluations, {nev / N:.1f} per lane), plain '
        f'{pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, {bnd[0] / ms:.0%} '
        f'of it)  [{card}]')
    return max(errs), ms, pms, bnd


def phase_return_map(device, N, reps, card):
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import constitutive as con, svc_kernels as sk
    mat = convert.material_from_params(synthetic_svc(), is_svc=True,
                                       dtype=torch.float32, device=device)
    CV = torch.as_tensor(elastic_cv(), dtype=torch.float32, device=device)
    sig_np, deps_np = return_map_states(N)
    sig = torch.as_tensor(sig_np, dtype=torch.float32, device=device)
    deps = torch.as_tensor(deps_np, dtype=torch.float32, device=device)
    epl = torch.zeros_like(sig)

    def step():
        return con.response_fast(mat, (sig, epl), deps, CV, 12)

    out = step()
    sync(device)
    n0 = sk.svc_f_grad.launches
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step()
    sync(device)
    dt = (time.perf_counter() - t0) / reps
    per_call = (sk.svc_f_grad.launches - n0) // reps
    fin = all(bool(torch.isfinite(o).all()) for o in out)
    nplastic = int((out[2].abs().sum(-1) > 0).sum())
    log(f'[4 return map] response_fast N={N}, 512-SV synthetic SVC, f32: '
        f'{dt * 1e3:.2f} ms -> {N / dt:,.0f} maps/s; kernel A launches per '
        f'call {per_call}; plastic lanes {nplastic}; finite {fin}  [{card}]')
    if not fin or per_call == 0:
        fail('return map output not finite or kernel A not launched')
    return N / dt


#: the faithful return-map phase per dtype: the non-finite lanes allowed
#: (share of N), and the least number of the 64 lanes held against the CPU
#: that must agree (same finite outputs, each within ``rtol`` of its scale)
FAITHFUL_CHECKS = {'float64': dict(nonfinite=1e-4, agree=64, rtol=1e-6),
                   'float32': dict(nonfinite=1e-3, agree=48, rtol=1e-3)}


def phase_faithful_map(device, N, dtype, card):
    """One reference-faithful ``response_chunked`` call on phase 4's
    states, which must launch kernels D, E and G and not F (the
    yield-locus distance runs its Brent in G).  On a few of these
    states (a step split far outside the synthetic SVC's band) the
    faithful algorithm itself yields NaN, in the JAX package as here
    (``tests/test_torch_faithful.py``), so the phase bounds their share
    and holds 64 lanes (the first 8 non-finite, 24 plastic, the rest
    elastic) against the plain version on the CPU.  In float64 all 64
    must agree: the same lanes non-finite, the finite values within 1e-6
    relative (a Brent iterate that flips on a lane moves it by up to
    xtol).  In float32 the Brent stopping test (xtol 1e-5) lies below the
    float32 spacing at roots of 128-256 MPa, so whether a lane converges,
    or falls back to seq - 0.85 sflow, turns on the last bit of f: card
    and CPU, which sum in different orders, may part on such lanes, and
    3/4 of the 64 must agree within 1e-3."""
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import constitutive as con, rootfind
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    cpu = torch.device('cpu')
    chk = FAITHFUL_CHECKS[str(dtype).split('.')[-1]]
    sig_np, deps_np = return_map_states(N)

    def run(dev, idx):
        mat = convert.material_from_params(synthetic_svc(), is_svc=True,
                                           dtype=dtype, device=dev)
        CV = torch.as_tensor(elastic_cv(), dtype=dtype, device=dev)
        sig = torch.as_tensor(sig_np[idx], dtype=dtype, device=dev)
        deps = torch.as_tensor(deps_np[idx], dtype=dtype, device=dev)
        return con.response_chunked(mat, (sig, torch.zeros_like(sig)), deps,
                                    CV)

    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    out = run(device, slice(None))
    sync(device)
    dt = time.perf_counter() - t0
    nd, ne = sk.svc_decision.launches, sk.svc_f_grad_mm.launches
    nf, ng = rootfind.brent_step.launches, sk.svc_yf_root.launches
    bad = torch.zeros(N, dtype=torch.bool, device=device)
    for o in out:
        bad |= ~torch.isfinite(o.reshape(N, -1)).all(-1)
    bad = bad.cpu().numpy()
    plastic = (out[2].abs().sum(-1) > 0).cpu().numpy() & ~bad
    idx = np.concatenate([np.flatnonzero(bad)[:8],
                          np.flatnonzero(plastic)[:24],
                          np.flatnonzero(~bad & ~plastic)])[:64]
    ref = run(cpu, idx)
    # per lane: the same outputs finite, each finite one within rtol of
    # that output's scale over the 64 lanes
    agree = np.ones(len(idx), dtype=bool)
    errs = []
    for o, r in zip(out, ref):
        a = o[idx].cpu().double().reshape(len(idx), -1)
        b = r.double().reshape(len(idx), -1)
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        scale = max(float(b[fb].abs().max()), 1e-300)
        d = torch.where(fa & fb, (a - b).abs(), 0.).max(-1).values / scale
        agree &= ((fa == fb).all(-1) & (d <= chk['rtol'])).numpy()
        errs.append(float(d.max()))
    nbad = int(bad.sum())
    ok = (nbad <= chk['nonfinite'] * N and int(agree.sum()) >= chk['agree']
          and min(nd, ne, ng) > 0 and nf == 0)
    log(f'[4 faithful map] response_chunked N={N}, 512-SV synthetic SVC, '
        f'{dtype}: {dt:.3f} s -> {N / dt:,.0f} maps/s; launches per call: '
        f'svc_decision {nd}, svc_f_grad_mm {ne}, svc_yf_root {ng}, '
        f'brent_step {nf} (bound 0), svc_f_grad {sk.svc_f_grad.launches}; '
        f'plastic lanes {int(plastic.sum())}; non-finite lanes {nbad} (bound '
        f'{chk["nonfinite"] * N:.0f}); 64 lanes ({min(8, nbad)} non-finite) '
        f'vs the CPU: {int(agree.sum())} agree (bound {chk["agree"]}; the '
        f'CPU non-finite on {int((~torch.isfinite(ref[1]).all(-1)).sum())}),'
        f' max rel err of fy, sig, depl, tangent over the finite outputs '
        f'{", ".join(f"{e:.2e}" for e in errs)} (bound {chk["rtol"]:g} on '
        f'the agreeing lanes) {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail(f'faithful return map {dtype}: non-finite share, CPU agreement, '
             'kernels D/E/G not launched or kernel F launched')
    return N / dt


def run_steps(md, mat, CV, dtype, n_timed, device, counters=()):
    """init_state, one untimed step, ``n_timed`` warm-started steps
    (bench.py protocol).  Returns (state, diag, step seconds, cg iteration
    histories, launch counts of ``counters`` before the timed steps)."""
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    st = fek.init_state(md, CV, dtype=dtype)
    st, d = fek.load_step_split(md, st, mat, CV, 0.25, n_inner=2)
    sync(device)
    before = [c.launches for c in counters]
    times, iters = [], [list(d['cg_iters_hist'])]
    for _ in range(n_timed):
        t0 = time.perf_counter()
        st, d = fek.load_step_split(md, st, mat, CV, 0.25, n_inner=2,
                                    du0=d['du'], kes0=d['kes'],
                                    dst0=d['dstiff'])
        sync(device)
        times.append(time.perf_counter() - t0)
        iters.append(list(d['cg_iters_hist']))
    return st, d, times, iters, before


def counters():
    """Every kernel wrapper's launch counter: kernels A, B, C, D, E, F,
    G."""
    from pylabfea_tpu_torch.ops import rootfind, stencil, svc_kernels, volume
    return (svc_kernels.svc_f_grad, stencil.k_apply, volume.k_apply3,
            svc_kernels.svc_decision, svc_kernels.svc_f_grad_mm,
            rootfind.brent_step, svc_kernels.svc_yf_root)


def reset_counts():
    from pylabfea_tpu_torch.ops import svc_kernels
    for c in counters():
        c.launches = 0
    svc_kernels.reset_launches()


def phase_main_path(device, NB, card):
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe_kernels as fek, stencil
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=torch.float32,
                                             device=device)
    md = fek.rect_mesh(NB, NB, LX=1., LY=1., uniax='y', eps_tot=eps,
                       dtype=torch.float32, device=device)
    path = (stencil.k_apply, sk.svc_f_grad)
    reset_counts()
    st, d, times, iters, before = run_steps(md, mat, CV, torch.float32, 2,
                                            device, path)
    launches = [c.launches for c in path]
    timed = [a - b for a, b in zip(launches, before)]
    gsig = d['glob_sig'].cpu().numpy()
    fin = all(bool(torch.isfinite(t).all())
              for t in (st.u, st.sig, st.epl, st.eps, st.elstiff,
                        d['glob_sig']))
    log(f'[5 main path] {NB}x{NB} load_step_split(0.25, n_inner=2), trained '
        f'SVC nsv={mat.sv.shape[0]}, f32: step_s {times[0]:.4f}, '
        f'step_s_rep {times[1]:.4f}; cg_iters_hist {iters}; cg_res '
        f'{d["cg_res"]:.2e}; glob_sig {np.array2string(gsig, precision=4)}'
        f'; finite {fin}  [{card}]')
    log(f'[5 main path] launches in the timed steps: k_apply {timed[0]}, '
        f'svc_f_grad {timed[1]}; in the whole phase: k_apply '
        f'{launches[0]}, svc_f_grad {launches[1]}, svc_decision (the yield '
        f'function at each response start) {sk.svc_decision.launches}')
    if not fin:
        fail('main path produced non-finite fields')
    if min(timed) == 0:
        fail('a kernel of the main path was not launched in the timed '
             'steps')
    if not 0.5 * SY < gsig[1] < 2. * SY:
        fail(f'axial stress {gsig[1]} outside the plausible range after '
             'three plastic load steps')
    return dict(step_s=times[0], step_s_rep=times[1], cg_iters_hist=iters,
                launches=launches, state=st, diag=d, mesh=md, mat=mat, CV=CV)


#: the accuracy profile of the 2-D load step: the convergence gate, one
#: mixed-precision refinement pass per solve, the float64 commit
ACCURACY = dict(gate=True, n_refine=1, commit_f64=True)


def accuracy_step(md, st, d, mat, CV):
    """One 0.25 step of the accuracy profile after ``(st, d)``, with the
    warnings it raised.  Returns (state, diag, seconds, round count, max
    yield function of the committed stresses, elements above tolerance,
    the no-convergence warning or None)."""
    import warnings
    from pylabfea_tpu_torch.config import yf_tolerance
    from pylabfea_tpu_torch.ops import constitutive as con
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    sync(md.device)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        st, d = fek.load_step_split(md, st, mat, CV, 0.25, n_inner=2,
                                    du0=d['du'], kes0=d['kes'],
                                    dst0=d['dstiff'], **ACCURACY)
    sync(md.device)
    dt = time.perf_counter() - t0
    fy = con.yf(mat, st.sig, None)
    warned = [str(w.message) for w in caught
              if 'no convergence' in str(w.message)]
    return (st, d, dt, len(d['cg_iters_hist']), float(fy.max()),
            int((fy > yf_tolerance).sum()), warned[0] if warned else None)


def phase_accuracy_step(device, main_run, card):
    """One timed 0.25 step of the accuracy profile at the main path's
    size, from the main path's state (its fourth step).  Some elements'
    stresses leave the trained SVC's band there: the decision function is
    its intercept rho, its gradient vanishes and no return map brings them
    back, so the yield excess stays above tolerance and the step ends with
    the no-convergence warning after its 16 rounds, as JAX's does
    (``tests/test_torch_faithful.py``); phase 6 runs the same history at
    64 x 64 on the card and the CPU."""
    import torch
    mat = main_run['mat']
    reset_counts()
    st, d, dt, rounds, fmax, nover, warned = accuracy_step(
        main_run['mesh'], main_run['state'], main_run['diag'], mat,
        main_run['CV'])
    launches = {c.__name__: c.launches for c in counters()}
    gsig = d['glob_sig'].double().cpu().numpy()
    fin = all(bool(torch.isfinite(t).all())
              for t in (st.u, st.sig, st.epl, st.elstiff))
    NB = main_run['mesh'].grid[0]
    log(f'[5 accuracy step] {NB}x{NB} load_step_split(0.25, gate, '
        f'n_refine=1, commit_f64): {dt:.4f} s; {rounds} rounds, '
        f'cg_iters_hist {d["cg_iters_hist"]}; committed max yf {fmax:.6f} '
        f'(SVC intercept rho {mat.rho:.6f}) on {nover} elements above '
        f'yf_tolerance; warning: {warned}; glob_sig '
        f'{np.array2string(gsig, precision=4, max_line_width=200)}; '
        f'launches {launches}; finite {fin}  [{card}]')
    if not fin or min(launches['svc_f_grad'], launches['k_apply']) == 0:
        fail('accuracy-profile step not finite or kernels A/B not launched')
    return dt


def phase_card_vs_cpu(device, NB, card):
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    cpu = torch.device('cpu')
    # the three plain steps on each device, kept for the four-step
    # history below (which continues them with the accuracy step)
    three = {}
    # float64 runs take identical CG paths and agree to round-off.  Two
    # float32 runs differ in summation order, so CG may stop one iteration
    # apart at its 1e-6 residual and the return map lands elsewhere inside
    # the +-yf_tolerance (5e-3) band: 1e-3 bounds that
    for dtype, rtol in ((torch.float32, 1e-3), (torch.float64, 1e-9)):
        res = {}
        for dev in (device, cpu):
            mat, CV, eps = convert.material_from_npz(NPZ, dtype=dtype,
                                                     device=dev)
            md = fek.rect_mesh(NB, NB, LX=1., LY=1., uniax='y', eps_tot=eps,
                               dtype=dtype, device=dev)
            st, d, _, iters, _ = run_steps(md, mat, CV, dtype, 2, dev)
            three[dtype, dev.type] = (md, st, d, mat, CV)
            res[dev.type] = (d['glob_sig'].cpu().double(),
                             st.sig.abs().max().cpu().double(), iters)
        (ga, ma, ia), (gb, mb, ib) = res[device.type], res['cpu']
        eg = float((ga - gb).abs().max() / gb.abs().max())
        em = float((ma - mb).abs() / mb)
        ok = eg <= rtol and em <= rtol and (dtype == torch.float32
                                            or ia == ib)
        log(f'[6 card vs cpu] {NB}x{NB} three steps {dtype}: glob_sig rel '
            f'{eg:.2e}, max|sig| rel {em:.2e} (bound {rtol:g}); '
            f'cg_iters_hist card {ia} cpu {ib} {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'card and CPU disagree at {NB}x{NB} {dtype}')
    # one plastic step (0.5 of the load) of the accuracy profile in
    # float32: gate and refinement on the card and on the CPU may stop a
    # round apart in the +-yf_tolerance band
    res = {}
    for dev in (device, cpu):
        mat, CV, eps = convert.material_from_npz(NPZ, dtype=torch.float32,
                                                 device=dev)
        md = fek.rect_mesh(NB, NB, LX=1., LY=1., uniax='y', eps_tot=eps,
                           dtype=torch.float32, device=dev)
        st, d = fek.load_step_split(md, fek.init_state(md, CV), mat, CV, 0.5,
                                    n_inner=2, **ACCURACY)
        res[dev.type] = (d['glob_sig'].cpu().double(),
                         st.sig.abs().max().cpu().double(),
                         d['cg_iters_hist'])
    (ga, ma, ia), (gb, mb, ib) = res[device.type], res['cpu']
    eg = float((ga - gb).abs().max() / gb.abs().max())
    em = float((ma - mb).abs() / mb)
    ok = eg <= 1e-3 and em <= 1e-3
    log(f'[6 card vs cpu] {NB}x{NB} a 0.5 step of the accuracy profile '
        f'(gate, n_refine=1, commit_f64) float32: glob_sig rel {eg:.2e}, '
        f'max|sig| rel {em:.2e} (bound 1e-3); cg_iters_hist card {ia} cpu '
        f'{ib} {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'card and CPU disagree at {NB}x{NB} in the accuracy profile')
    # the main path's four-step history (three plain 0.25 steps, then the
    # accuracy profile's step).  In its fourth step a few elements may
    # leave the trained SVC's band (at 1024 x 1024 they do): the decision
    # function is the intercept rho there, its gradient vanishes and no
    # return map brings them back.  In float64 card and CPU take the same
    # path, band exits included (the same rounds and CG histories, the
    # same elements above yf_tolerance, glob_sig within 1e-9).  In float32
    # rounding decides whether an element leaves the band, so the two may
    # part there: the same round count, glob_sig within 1e-2
    for dtype, rtol in ((torch.float64, 1e-9), (torch.float32, 1e-2)):
        res = {}
        for dev in (device, cpu):
            md, st, d, mat, CV = three[dtype, dev.type]
            st, d, _, rounds, fmax, nover, warned = accuracy_step(
                md, st, d, mat, CV)
            res[dev.type] = (d['glob_sig'].cpu().double(), rounds, fmax,
                             nover, warned is not None,
                             [int(i) for i in d['cg_iters_hist']])
        (ga, ra, fa, na, wa, ia), (gb, rb, fb, nb, wb, ib) = \
            res[device.type], res['cpu']
        eg = float((ga - gb).abs().max() / gb.abs().max())
        ok = ra == rb and eg <= rtol and (
            dtype == torch.float32 or (ia == ib and na == nb and wa == wb))
        log(f'[6 card vs cpu] {NB}x{NB} three 0.25 steps then one of the '
            f'accuracy profile, {dtype}: rounds card {ra} cpu {rb}; '
            f'committed max yf card {fa:.6f} cpu {fb:.6f} (rho '
            f'{mat.rho:.6f}) on {na} / {nb} elements above yf_tolerance; '
            f'no-convergence warning card {wa} cpu {wb}; cg_iters_hist card '
            f'{ia} cpu {ib}; glob_sig rel {eg:.2e} (bound {rtol:g}) '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'card and CPU end the {NB}x{NB} accuracy-profile history '
                 f'differently in {dtype}')


def j2_material(dtype, device):
    """J2 + linear hardening (sy 150, khard 500 MPa), the 3-D material of
    bench.py, as analytic DeviceMaterial leaves."""
    from pylabfea_tpu_torch import convert
    return convert.material_from_params(
        dict(hill=np.ones(6), sy=SY, khard=KHARD3, drucker=0.), is_svc=False,
        dtype=dtype, device=device)


def run_steps3(N, fracs, dtype, device):
    """``load_step3`` on an N^3 box for each load fraction of ``fracs``,
    each later step warm-started from the previous increment.  Returns
    (mesh, state, last diag, step seconds, cg iteration histories, kernel
    C launches of each step)."""
    import torch
    from pylabfea_tpu_torch.ops import fe3d, volume
    mat, CV = j2_material(dtype, device), elastic_cv()
    md = fe3d.box_mesh(N, N, N, uniax='z', eps_tot=0.002, dtype=dtype,
                       device=device)
    st = fe3d.init_state3(md, CV, dtype=dtype)
    d = {'du': torch.zeros_like(st.u)}
    secs, iters, launches = [], [], []
    for frac in fracs:
        sync(device)
        n0 = volume.k_apply3.launches
        t0 = time.perf_counter()
        st, d = fe3d.load_step3(md, st, mat, CV, frac, n_inner=2,
                                du0=d['du'])
        sync(device)
        secs.append(time.perf_counter() - t0)
        iters.append(list(d['cg_iters_hist']))
        launches.append(volume.k_apply3.launches - n0)
    return md, st, d, secs, iters, launches


def phase_3d_path(device, N, card):
    """bench.py's 3-D protocol at N^3: an untimed 0.4 step, a timed 0.3
    step.  Returns the kernel C launches of both steps."""
    import torch
    reset_counts()
    md, st, d, secs, iters, launches = run_steps3(N, (0.4, 0.3),
                                                  torch.float32, device)
    total = [c.launches for c in counters()]
    gsig = d['glob_sig'].double().cpu().numpy()
    fin = all(bool(torch.isfinite(t).all())
              for t in (st.u, st.sig, st.epl, st.eps, st.elstiff))
    # uniaxial stress with linear hardening at eps = 0.7 * 0.002
    eps = 0.7 * 0.002
    closed = (SY + KHARD3 * eps) * E3 / (E3 + KHARD3)
    rel = abs(gsig[2] - closed) / closed
    # the field is homogeneous up to the return map's acceptance band
    # (yf_tolerance 5e-3 of the flow stress) and the CG residual (1e-6)
    spread = float((st.sig - st.sig.mean(0)).abs().max())
    sbound = 5e-3 * closed
    name = f'{N}^3'
    key = {128: 'step_s_128cubed', 64: 'step_s_64cubed_3d'}.get(N, 'step_s')
    log(f'[7 3-D path] {name} box ({md.nel:,} hex8, {md.ndof:,} dofs) '
        f'load_step3(0.3, n_inner=2, du0) after an untimed 0.4 step, J2 + '
        f'hardening, f32: {key} {secs[1]:.4f} (untimed step '
        f'{secs[0]:.4f}); cg_iters_hist {iters}; cg_res '
        f'{float(d["cg_res"]):.2e}; k_apply3 launches timed step '
        f'{launches[1]}, both steps {total[2]} (k_apply {total[1]}, '
        f'svc_f_grad {total[0]}); finite {fin}  [{card}]')
    log(f'[7 3-D path] {name} glob_sig[2] {gsig[2]:.4f} vs closed form '
        f'{closed:.4f} (rel {rel:.2e}, bound 1e-2); max|sig - mean| '
        f'{spread:.3e} (bound 5e-3 * {closed:.1f} = {sbound:.3f})')
    if not fin:
        fail(f'3-D path {name} produced non-finite fields')
    if launches[1] == 0:
        fail(f'3-D path {name}: kernel C was not launched in the timed step')
    if rel > 1e-2 or spread > sbound:
        fail(f'3-D path {name}: stress off the uniaxial closed form')
    return total[2]


def phase_3d_card_vs_cpu(device, N, card):
    import torch
    cpu = torch.device('cpu')
    # the third step takes another fraction, so its warm start is off and
    # CG has work to do (an equal step would start converged)
    fracs = (0.4, 0.3, 0.2)
    for dtype, rtol in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        res = {}
        for dev in (device, cpu):
            _, st, d, _, iters, _ = run_steps3(N, fracs, dtype, dev)
            res[dev.type] = (d['glob_sig'].cpu().double(),
                             st.sig.abs().max().cpu().double(), iters)
        (ga, ma, ia), (gb, mb, ib) = res[device.type], res['cpu']
        eg = float((ga - gb).abs().max() / gb.abs().max())
        em = float((ma - mb).abs() / mb)
        ok = eg <= rtol and em <= rtol
        log(f'[8 3-D card vs cpu] {N}^3 three steps {dtype}: glob_sig rel '
            f'{eg:.2e}, max|sig| rel {em:.2e} (bound {rtol:g}); '
            f'cg_iters_hist card {ia} cpu {ib} {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'card and CPU disagree at {N}^3 {dtype}')


#: most launches of kernels D and G in one REF_SOLVE solve (the yield
#: function and one root finder per yield-locus distance; the eager
#: marching and Brent loops launched D 537,421 times in a 32^2 f32 solve)
MAX_DG_LAUNCHES = 10_000


def ref_solve(N, dtype, device):
    """``bench.py``'s REF_SOLVE solve on an N x N mesh: eight gated load
    steps with the faithful tail (nsub 4, n_inner 2).  Returns (final
    glob_sig as float64 numpy, final state)."""
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=dtype, device=device)
    md = fek.rect_mesh(N, N, LX=2., LY=2., uniax='y', eps_tot=eps,
                       dtype=dtype, device=device)
    st, hist = fek.solve_uniaxial(md, mat, CV, nsteps=8, n_inner=2,
                                  dtype=dtype, gate=True, nsub=4,
                                  commit_faithful=True)
    sync(device)
    return hist[-1][0].double().cpu().numpy(), st


def phase_ref_solve(device, cases, card):
    """The REF_SOLVE BVP for each (N, dtype, parity bound) of ``cases``:
    one untimed solve of the first case, then a timed solve of each whose
    launches are counted and whose glob_sig is held against
    ``converged_glob_sig``.  (Eager PyTorch compiles nothing per size: an
    untimed solve of every case, ``bench.py``'s protocol for XLA, took as
    long as the timed one in every case on the card, so only the first
    runs.)  Returns {(N, dtype): (seconds, launches, glob_sig)}."""
    import torch
    with open(REF_JSON) as fh:
        rec = json.load(fh)['sizes']
    out = {}
    t0 = time.perf_counter()
    ref_solve(*cases[0][:2], device)
    untimed = time.perf_counter() - t0
    for N, dtype, bound in cases:
        reset_counts()
        t0 = time.perf_counter()
        sig, st = ref_solve(N, dtype, device)
        dt = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters()}
        anchor = np.asarray(rec[str(N)]['converged_glob_sig'], float)
        par_yy = abs(sig[1] - anchor[1]) / abs(anchor[1])
        par_max = np.abs(sig - anchor).max() / max(1., np.abs(anchor).max())
        fin = bool(torch.isfinite(st.sig).all()) and np.isfinite(sig).all()
        ok = (fin and par_yy <= bound and par_max <= bound
              and min(launches['svc_decision'], launches['svc_f_grad_mm'],
                      launches['svc_yf_root']) > 0
              and launches['brent_step'] == 0
              and launches['svc_decision'] + launches['svc_yf_root']
              <= MAX_DG_LAUNCHES)
        log(f'[9 REF_SOLVE] {N}x{N} {dtype} solve_uniaxial(nsteps=8, '
            f'n_inner=2, gate, nsub=4, commit_faithful): {dt:.3f} s '
            f'(untimed first solve {untimed:.3f} s; reference pyLabFEA '
            f'{rec[str(N)]["solve_s"]} s); '
            f'fe_solve_parity_{N}sq {par_yy:.3e}, max-component parity '
            f'{par_max:.3e} (bound {bound:g}); glob_sig '
            f'{np.array2string(sig, precision=6, max_line_width=200)}; '
            f'launches {launches} '
            f'{"ok" if ok else "FAIL"}  [{card}]')
        if not ok:
            fail(f'REF_SOLVE {N}x{N} {dtype}: parity, finiteness, kernels '
                 'D/E/G not launched, kernel F launched or more than '
                 f'{MAX_DG_LAUNCHES} launches of D and G')
        out[(N, dtype)] = (dt, launches, sig)
    return out


def phase_ref_card_vs_cpu(card_sig, N, dtype):
    """The REF_SOLVE solve on the CPU against the card's timed one.  In
    float64 both take the same branches and agree to round-off (about
    1e-8 expected); a Brent iterate that flips on one lane would move
    glob_sig by up to xtol (1e-5 MPa) over that lane's share, so the bound
    is 1e-6 relative."""
    import torch
    sig, _ = ref_solve(N, dtype, torch.device('cpu'))
    rel = float(np.abs(card_sig - sig).max() / np.abs(sig).max())
    ok = rel <= 1e-6
    log(f'[9 card vs cpu] REF_SOLVE {N}x{N} {dtype}: glob_sig rel {rel:.2e} '
        f'(bound 1e-6) {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'REF_SOLVE {N}x{N} {dtype}: card and CPU disagree')


# -----------------------------------------------------------------
# multi-material, plane-stress and 3-D faithful paths (phases 10-12)
# -----------------------------------------------------------------
def finite(*ts):
    import torch
    return all(bool(torch.isfinite(t).all()) for t in ts)


def phase_inclusion(device, N, card):
    """bench.py's ``step_s_1024_inclusion`` protocol: one untimed 0.25 step,
    then one timed warm-started 0.25 step, n_inner=2, float32.  Kernel B
    must be launched in the timed step.  Returns the launches of B in the
    phase."""
    import torch
    from pylabfea_tpu_torch import workloads as wl
    from pylabfea_tpu_torch.ops import fe_kernels as fek, stencil
    md, mats, CVs = wl.inclusion_case(N, torch.float32, device)
    reset_counts()
    st = fek.init_state(md, CVs, dtype=torch.float32)
    t0 = time.perf_counter()
    st, d = fek.load_step_split(md, st, mats, CVs, 0.25, n_inner=2)
    sync(device)
    untimed = time.perf_counter() - t0
    nb = stencil.k_apply.launches
    t0 = time.perf_counter()
    st, d = fek.load_step_split(md, st, mats, CVs, 0.25, n_inner=2,
                                du0=d['du'], kes0=d['kes'], dst0=d['dstiff'])
    sync(device)
    dt = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters()}
    timed_b = launches['k_apply'] - nb
    gsig = d['glob_sig'].double().cpu().numpy()
    ok = finite(st.u, st.sig, st.epl, st.eps, st.elstiff) and timed_b > 0
    plastic = [int((st.epl[md.perm[a:a + n]].abs().sum(-1) > 0).sum())
               for a, n in md.groups]
    log(f'[10 inclusion] {N}x{N} 3 materials (Hill sdim=6, J2 sdim=3, '
        f'elastic E=1e3; groups {[n for _, n in md.groups]}), general BCs '
        f'+ corner pin, load_step_split(0.25, n_inner=2) f32: '
        f'step_s_{N}_inclusion {dt:.4f} (untimed first step {untimed:.4f}); '
        f'cg_iters_hist {d["cg_iters_hist"]}; k_apply launches timed step '
        f'{timed_b}, phase {launches["k_apply"]}; launches {launches}; '
        f'plastic elements per group {plastic}; glob_sig '
        f'{np.array2string(gsig, precision=4, max_line_width=200)}; finite '
        f'and B launched {ok}  [{card}]')
    if not ok:
        fail('2-D inclusion: non-finite fields or kernel B not launched')
    return launches['k_apply']


def phase_laminate(device, NX, NY, card):
    """The plane-stress laminate at NX x NY, one float32 load step (the
    whole displacement, n_inner=1).  Prints E_yy = sig_yy / eps_yy beside
    the Voigt value; phase 12 holds it to 1e-3 at 64^2."""
    import torch
    from pylabfea_tpu_torch import workloads as wl
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    md, mats, CVs = wl.laminate_case(NX, NY, torch.float32, device)
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    st, d = fek.load_step_split(md, fek.init_state(md, CVs), mats, CVs, 1.,
                                n_inner=1)
    sync(device)
    dt = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters()}
    gs = d['glob_sig'].double().cpu().numpy()
    ge = d['glob_eps'].double().cpu().numpy()
    eyy = gs[1] / ge[1]
    voigt = wl.LAM_VOIGT
    ok = finite(st.u, st.sig, st.eps) and launches['k_apply'] > 0
    log(f'[10b laminate] {NX}x{NY} plane stress, 5 sections (E 100e3 / '
        f'300e3), load_step_split(1.0, n_inner=1) f32: {dt:.4f} s; '
        f'cg_iters_hist {d["cg_iters_hist"]}; E_yy {eyy:.2f} vs Voigt '
        f'{voigt:.0f} (rel {abs(eyy - voigt) / voigt:.2e}, the '
        f'reference golden bound 1e-3 is held in phase 12); max|eps_33| '
        f'{float(st.eps[:, 2].abs().max()):.3e}; launches {launches}; '
        f'finite and B launched {ok}  [{card}]')
    if not ok:
        fail('laminate: non-finite fields or kernel B not launched')
    return dt, eyy


def phase_box_inclusion(device, N, card, n_parity=16):
    """bench.py's 3-D inclusion protocol: ``incl3d_parity_16cubed`` (four
    steps of ``solve_uniaxial3`` at ``n_parity``^3 in float32 against
    float64, < 5e-4) and at N^3 a timed 0.3 step after an untimed 0.4
    step, which must launch kernel C.  Returns (seconds, launches of C,
    parity)."""
    import torch
    from pylabfea_tpu_torch import workloads as wl
    from pylabfea_tpu_torch.ops import fe3d, volume
    gs = {}
    for dtype in (torch.float32, torch.float64):
        md, mats, CVs = wl.box_inclusion_case(n_parity, dtype, device)
        _, hist = fe3d.solve_uniaxial3(md, mats, CVs, nsteps=4, n_inner=2)
        gs[dtype] = hist[-1][0].double().cpu().numpy()
    par = float(np.abs(gs[torch.float32] - gs[torch.float64]).max()
                / np.abs(gs[torch.float64]).max())
    log(f'[11 3-D inclusion] {n_parity}^3 solve_uniaxial3(nsteps=4, '
        f'n_inner=2): incl3d_parity_{n_parity}cubed {par:.3e} (f32 vs f64 '
        f'glob_sig, bound 5e-4) {"ok" if par < 5e-4 else "FAIL"}')
    if not par < 5e-4:
        fail(f'3-D inclusion f32-vs-f64 parity {par:.2e}')
    md, mats, CVs = wl.box_inclusion_case(N, torch.float32, device)
    reset_counts()
    st = fe3d.init_state3(md, CVs, dtype=torch.float32)
    st, d = fe3d.load_step3(md, st, mats, CVs, 0.4, n_inner=2,
                            du0=torch.zeros_like(st.u))
    sync(device)
    nc = volume.k_apply3.launches
    t0 = time.perf_counter()
    st, d = fe3d.load_step3(md, st, mats, CVs, 0.3, n_inner=2, du0=d['du'])
    sync(device)
    dt = time.perf_counter() - t0
    timed_c = volume.k_apply3.launches - nc
    launches = {c.__name__: c.launches for c in counters()}
    gsig = d['glob_sig'].double().cpu().numpy()
    ok = finite(st.u, st.sig, st.epl, st.elstiff) and timed_c > 0
    log(f'[11 3-D inclusion] {N}^3 (groups {[n for _, n in md.groups]}) '
        f'load_step3(0.3, n_inner=2, du0) after an untimed 0.4 step, f32: '
        f'step_s_{N}cubed_3d_inclusion {dt:.4f}; cg_iters_hist '
        f'{d["cg_iters_hist"]}; k_apply3 launches timed step {timed_c}, '
        f'both steps {launches["k_apply3"]}; launches {launches}; glob_sig '
        f'{np.array2string(gsig, precision=4, max_line_width=200)}; finite '
        f'and C launched {ok}  [{card}]')
    if not ok:
        fail('3-D inclusion: non-finite fields or kernel C not launched')
    return dt, launches['k_apply3'], par


#: load fractions of the 3-D faithful route: through the yield onset of
#: the trained SVC (eps_tot 0.002 at the last step)
FAITHFUL3_FRACS = (0.5, 0.25, 0.25)


def faithful3(N, dtype, device):
    """``load_step3(fast=False)`` with the trained SVC on an N^3 box, the
    steps of ``FAITHFUL3_FRACS``.  Returns (state, last diag)."""
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe3d
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=dtype, device=device)
    md = fe3d.box_mesh(N, N, N, uniax='z', eps_tot=eps, dtype=dtype,
                       device=device)
    st, d = fe3d.init_state3(md, CV, dtype=dtype), None
    for frac in FAITHFUL3_FRACS:
        st, d = fe3d.load_step3(md, st, mat, CV, frac, n_inner=2, fast=False,
                                du0=None if d is None else d['du'])
    sync(device)
    return st, d


def phase_faithful3(device, N, card):
    """The 3-D reference-faithful route at N^3 in float32: kernels D, E and
    G launched, F not."""
    import torch
    reset_counts()
    t0 = time.perf_counter()
    st, d = faithful3(N, torch.float32, device)
    dt = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters()}
    gsig = d['glob_sig'].double().cpu().numpy()
    ok = (finite(st.u, st.sig, st.epl) and launches['brent_step'] == 0
          and min(launches['svc_decision'], launches['svc_f_grad_mm'],
                  launches['svc_yf_root']) > 0)
    log(f'[11b 3-D faithful] {N}^3 trained SVC, load_step3(fast=False, '
        f'n_inner=2) over the fractions {FAITHFUL3_FRACS}, f32: {dt:.3f} s; '
        f'last cg_iters_hist {d["cg_iters_hist"]}; plastic elements '
        f'{int((st.epl.abs().sum(-1) > 0).sum())}; glob_sig '
        f'{np.array2string(gsig, precision=4, max_line_width=200)}; '
        f'launches {launches} (D, E, G launched, F not: {ok})  [{card}]')
    if not ok:
        fail('3-D faithful route: non-finite fields, kernels D/E/G not '
             'launched or kernel F launched')
    return dt, launches


def phase_new_card_vs_cpu(device, card, N2=32, N3=8, N3f=4):
    """Float64 card against CPU on the new paths: the 3-material inclusion,
    the laminate and the two-group SVC + elastic mesh at N2^2 (a cold step
    and two warm-started ones), the 3-D inclusion at N3^3 (four steps of
    ``solve_uniaxial3``): glob_sig and max|sig| within 1e-9 and the same CG
    histories; the 3-D faithful route at N3f^3 within 1e-6 (phase 9's
    bound for a Brent iterate that flips).  The laminate's E_yy is held to
    the reference golden (Voigt, 1e-3)."""
    import torch
    from pylabfea_tpu_torch import workloads as wl
    from pylabfea_tpu_torch.ops import fe3d
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    cpu = torch.device('cpu')
    f64 = torch.float64

    def steps2d(case, fracs):
        def run(dev):
            md, mats, CVs = case(dev)
            st, d = fek.init_state(md, CVs, dtype=f64), None
            hist = []
            for frac in fracs:
                warm = {} if d is None else dict(
                    du0=d['du'], kes0=d['kes'], dst0=d['dstiff'])
                st, d = fek.load_step_split(md, st, mats, CVs, frac,
                                            n_inner=2, **warm)
                hist.append(list(d['cg_iters_hist']))
            return st, d, hist
        return run

    def steps3d(dev):
        md, mats, CVs = wl.box_inclusion_case(N3, f64, dev)
        st, hist = fe3d.solve_uniaxial3(md, mats, CVs, nsteps=4, n_inner=2)
        return st, {'glob_sig': hist[-1][0], 'glob_eps': hist[-1][1]}, \
            [int(h[2]) for h in hist]

    cases = [
        (f'3-material inclusion {N2}^2',
         steps2d(lambda dev: wl.inclusion_case(N2, f64, dev), (0.25,) * 3)),
        (f'laminate {N2}^2',
         steps2d(lambda dev: wl.laminate_case(N2, N2, f64, dev), (1.,))),
        (f'SVC + elastic groups {N2}^2',
         steps2d(lambda dev: wl.svc_elastic_case(N2, f64, dev),
                 (0.25,) * 3)),
        (f'3-D inclusion {N3}^3', steps3d)]
    for name, run in cases:
        reset_counts()
        sa, da, ia = run(device)
        sync(device)
        launches = {c.__name__: c.launches for c in counters()}
        sb, db, ib = run(cpu)
        ga, gb = da['glob_sig'].cpu(), db['glob_sig']
        eg = float((ga - gb).abs().max() / gb.abs().max())
        ma, mb = sa.sig.abs().max().cpu(), sb.sig.abs().max()
        em = float((ma - mb).abs() / mb)
        ok = eg <= 1e-9 and em <= 1e-9 and ia == ib
        extra = ''
        if name.startswith('laminate'):
            eyy = float(da['glob_sig'][1] / da['glob_eps'][1])
            rel = abs(eyy - wl.LAM_VOIGT) / wl.LAM_VOIGT
            ok = ok and rel < 1e-3
            extra = (f'; E_yy {eyy:.3f} vs Voigt {wl.LAM_VOIGT:.0f} (rel '
                     f'{rel:.2e}, bound 1e-3)')
        if name.startswith('SVC'):
            md = wl.svc_elastic_case(N2, f64, cpu)[0]
            ok = ok and min(launches['svc_f_grad'],
                            launches['svc_decision']) > 0
            extra = (f'; group blocks {[n for _, n in md.groups]}, launches '
                     f'on the card: svc_f_grad {launches["svc_f_grad"]}, '
                     f'svc_decision {launches["svc_decision"]}')
        log(f'[12 card vs cpu] {name} float64: glob_sig rel {eg:.2e}, '
            f'max|sig| rel {em:.2e} (bound 1e-9); cg iterations card {ia} '
            f'cpu {ib}{extra} {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'card and CPU disagree on the {name}')
    reset_counts()
    sa, da = faithful3(N3f, f64, device)
    launches = {c.__name__: c.launches for c in counters()}
    sb, db = faithful3(N3f, f64, cpu)
    ga, gb = da['glob_sig'].cpu(), db['glob_sig']
    eg = float((ga - gb).abs().max() / gb.abs().max())
    ma, mb = sa.sig.abs().max().cpu(), sb.sig.abs().max()
    em = float((ma - mb).abs() / mb)
    ok = eg <= 1e-6 and em <= 1e-6 and launches['svc_yf_root'] > 0
    log(f'[12 card vs cpu] 3-D faithful route {N3f}^3 float64: glob_sig rel '
        f'{eg:.2e}, max|sig| rel {em:.2e} (bound 1e-6); launches on the card '
        f'{launches} {"ok" if ok else "FAIL"}')
    if not ok:
        fail('card and CPU disagree on the 3-D faithful route')


# -----------------------------------------------------------------
# the SVC feature layouts beyond 6-D stress (phases 13a-13e)
# -----------------------------------------------------------------
def fixture(name, dtype, device):
    """(DeviceMaterial, CV, eps) of a trained fixture of ``DATA``."""
    from pylabfea_tpu_torch import convert
    return convert.material_from_npz(os.path.join(DATA, name + '.npz'),
                                     dtype=dtype, device=device)


def by_width():
    """Every SVC kernel's launches by feature count since the last reset."""
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    return {k.__name__: dict(k.launches_by_nfeat) for k in sk.KERNELS}


def layout_steps(md, mat, CV, dtype, n_timed, device):
    """``run_steps`` with the hardening modulus (``khard_of``, the batch
    mean for work-hardening features) of each step's committed state:
    (state, diag, seconds of the timed steps, cg histories, launches by
    width, khards).  The counts are read before the khards, whose
    evaluation launches kernel A."""
    from pylabfea_tpu_torch.ops import constitutive as con
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    from pylabfea_tpu_torch.ops import jtensors as jt
    st = fek.init_state(md, CV, dtype=dtype)
    states, times, iters, d = [], [], [], None
    for k in range(n_timed + 1):
        warm = {} if d is None else dict(du0=d['du'], kes0=d['kes'],
                                         dst0=d['dstiff'])
        sync(device)
        t0 = time.perf_counter()
        st, d = fek.load_step_split(md, st, mat, CV, 0.25, n_inner=2, **warm)
        sync(device)
        if k:
            times.append(time.perf_counter() - t0)
        iters.append([int(i) for i in d['cg_iters_hist']])
        states.append(st)
    widths = by_width()
    khards = [float(con.yf_and_fgrad(mat, s.sig, jt.eps_eq(s.epl),
                                     s.epl)[2]) for s in states]
    return st, d, times, iters, widths, khards


def phase_layout_path(device, name, NB, card, tag):
    """Phase 5's main path (NB x NB quads, uniaxial y, eps 0.002 in steps
    of 0.25, ``load_step_split(n_inner=2)``, float32: one untimed step,
    two timed warm-started ones) with a trained fixture of another feature
    layout, which must launch kernel A at its feature count and end with
    finite fields and an axial stress in (0.5 sy, 2 sy)."""
    import torch
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    mat, CV, eps = fixture(name, torch.float32, device)
    F = mat.sv.shape[1]
    md = fek.rect_mesh(NB, NB, LX=1., LY=1., uniax='y', eps_tot=eps,
                       dtype=torch.float32, device=device)
    reset_counts()
    st, d, times, iters, widths, khards = layout_steps(
        md, mat, CV, torch.float32, 2, device)
    gsig = d['glob_sig'].double().cpu().numpy()
    fin = finite(st.u, st.sig, st.epl, st.eps, st.elstiff, d['glob_sig'])
    nA = widths['svc_f_grad'].get(F, 0)
    ok = fin and nA > 0 and 0.5 * mat.sy < gsig[1] < 2. * mat.sy
    log(f'[{tag}] {NB}x{NB} load_step_split(0.25, n_inner=2), {name} '
        f'(F={F}, nsv={mat.sv.shape[0]}, sy {mat.sy:g}), f32: step_s '
        f'{times[0]:.4f}, step_s_rep {times[1]:.4f}; cg_iters_hist {iters}; '
        f'khard_of the steps {[f"{k:.6g}" for k in khards]}; glob_sig '
        f'{np.array2string(gsig, precision=4, max_line_width=200)}; '
        f'launches by feature count {widths}; plastic elements '
        f'{int((st.epl.abs().sum(-1) > 0).sum())}; finite {fin} '
        f'{"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail(f'{name} main path: non-finite fields, kernel A not launched at '
             f'F={F} or axial stress {gsig[1]} outside (0.5 sy, 2 sy)')
    return dict(step_s=times, launches=widths, F=F)


def cyl_faithful(N, dtype, device, nsteps=8):
    """The REF_SOLVE protocol (``solve_uniaxial(nsteps=8, n_inner=2, gate,
    nsub=4, commit_faithful)``) on an N x N mesh with the cylindrical
    fixture, or its first ``nsteps`` increments of eps / 8; its gate does
    not fire with this material (every step runs its 16 rounds and warns,
    in the JAX package as here), so the warnings are counted, not shown.
    Returns (state, history, warnings)."""
    import warnings
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    mat, CV, eps = fixture('svc_cyl', dtype, device)
    md = fek.rect_mesh(N, N, LX=2., LY=2., uniax='y',
                       eps_tot=eps * nsteps / 8, dtype=dtype, device=device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        st, hist = fek.solve_uniaxial(md, mat, CV, nsteps=nsteps, n_inner=2,
                                      dtype=dtype, gate=True, nsub=4,
                                      commit_faithful=True)
    sync(device)
    return st, hist, len(caught)


def phase_cyl_faithful(device, N, card):
    """Phase 9's solve at N x N in float32 with the cylindrical fixture:
    kernels D, E and G launched at F = 2, F not at all."""
    import torch
    reset_counts()
    t0 = time.perf_counter()
    st, hist, nwarn = cyl_faithful(N, torch.float32, device)
    dt = time.perf_counter() - t0
    widths = by_width()
    launches = {c.__name__: c.launches for c in counters()}
    gsig = hist[-1][0].double().cpu().numpy()
    ok = (finite(st.u, st.sig, st.epl) and launches['brent_step'] == 0
          and all(widths[k].get(2, 0) > 0 for k in
                  ('svc_decision', 'svc_f_grad_mm', 'svc_yf_root')))
    log(f'[13c cylindrical faithful] {N}x{N} solve_uniaxial(nsteps=8, '
        f'n_inner=2, gate, nsub=4, commit_faithful), svc_cyl, f32: {dt:.3f} '
        f's; {nwarn} no-convergence warnings; glob_sig '
        f'{np.array2string(gsig, precision=4, max_line_width=200)}; '
        f'launches {launches}, by feature count {widths} (D, E, G at F=2, '
        f'F not: {ok})  [{card}]')
    if not ok:
        fail('cylindrical faithful solve: non-finite fields, kernels D/E/G '
             'not launched at F=2 or kernel F launched')
    return dict(seconds=dt, launches=widths)


def lanes_vs_cpu(out, ref, idx):
    """Phase 4's float32 rule on the lanes ``idx`` of the card's outputs
    against the CPU's: per lane the same outputs finite, each finite one
    within 1e-3 of that output's scale.  Returns (agreeing lanes, max rel
    error per output)."""
    import torch
    agree = np.ones(len(idx), dtype=bool)
    errs = []
    for o, r in zip(out, ref):
        a = o[idx].cpu().double().reshape(len(idx), -1)
        b = r.double().reshape(len(idx), -1)
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        scale = max(float(b[fb].abs().max()), 1e-300)
        d = torch.where(fa & fb, (a - b).abs(), 0.).max(-1).values / scale
        agree &= ((fa == fb).all(-1) & (d <= 1e-3)).numpy()
        errs.append(float(d.max()))
    return int(agree.sum()), errs


def phase_texture(device, N, NG, card):
    """The GSH_3 texture fixture (F = 9, the kernels' runtime-F form):
    ``response_fast`` on N states (kernels A and D) and ``ml_yf_dist`` on
    NG stresses at 0.3-2 sy (kernel G), float32, finite, 64 lanes of each
    against the CPU under phase 4's rule (at most 1e-3 of the lanes
    non-finite, 48 of 64 within 1e-3)."""
    import torch
    from pylabfea_tpu_torch.ops import constitutive as con
    cpu, f32 = torch.device('cpu'), torch.float32
    res = {}
    for dev in (device, cpu):
        mat, CV, _ = fixture('svc_tex_gsh3', f32, dev)
        res[dev.type] = mat, torch.as_tensor(CV, dtype=f32, device=dev)
    mat, CV = res[device.type]
    F = mat.sv.shape[1]
    sig_np, deps_np = return_map_states(N, sy=mat.sy)
    sig = torch.as_tensor(sig_np, dtype=f32, device=device)
    deps = torch.as_tensor(deps_np, dtype=f32, device=device)
    rng = np.random.default_rng(4)
    u = rng.normal(size=(NG, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sg_np = u * mat.sy * rng.uniform(0.3, 2.0, (NG, 1))
    sg = torch.as_tensor(sg_np, dtype=f32, device=device)
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    out = con.response_fast(mat, (sig, torch.zeros_like(sig)), deps, CV, 12)
    sync(device)
    t1 = time.perf_counter()
    dist = con.ml_yf_dist(mat, sg, torch.zeros(NG, dtype=f32, device=device))
    sync(device)
    t2 = time.perf_counter()
    widths = by_width()
    pick = np.random.default_rng(5).choice(N, 64, replace=False)
    mc, CVc = res['cpu']
    ref = con.response_fast(mc, (torch.as_tensor(sig_np[pick], dtype=f32),
                                 torch.zeros(64, 6)),
                            torch.as_tensor(deps_np[pick], dtype=f32), CVc,
                            12)
    na, ea = lanes_vs_cpu(out, ref, pick)
    gpick = np.random.default_rng(6).choice(NG, 64, replace=False)
    gref = con.ml_yf_dist(mc, torch.as_tensor(sg_np[gpick], dtype=f32),
                          torch.zeros(64))
    ng, eg = lanes_vs_cpu((dist,), (gref,), gpick)
    nbad = sum(int((~torch.isfinite(o.reshape(o.shape[0], -1))).any(-1)
                   .sum()) for o in out)
    nbad_g = int((~torch.isfinite(dist)).sum())
    ok = (nbad <= 1e-3 * N and nbad_g <= 1e-3 * NG and na >= 48
          and ng >= 48 and all(widths[k].get(F, 0) > 0 for k in
                               ('svc_f_grad', 'svc_decision', 'svc_yf_root')))
    log(f'[13d texture] svc_tex_gsh3 (F={F}, nsv={mat.sv.shape[0]}), f32: '
        f'response_fast N={N} {(t1 - t0) * 1e3:.2f} ms, plastic lanes '
        f'{int((out[2].abs().sum(-1) > 0).sum())}, non-finite lanes {nbad}; '
        f'ml_yf_dist N={NG} {(t2 - t1) * 1e3:.2f} ms, non-finite {nbad_g}; '
        f'vs the CPU on 64 lanes: response_fast {na} agree (max rel err of '
        f'f, sig, depl, tangent {", ".join(f"{e:.2e}" for e in ea)}), '
        f'ml_yf_dist {ng} agree (max rel err {eg[0]:.2e}) (bounds: 48 of '
        f'64 within 1e-3, non-finite at most 1e-3 of the lanes); launches '
        f'by feature count {widths} {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('texture layout: non-finite share, CPU agreement or kernels '
             f'A/D/G not launched at F={F}')
    return dict(launches=widths, F=F)


def phase_layouts_card_vs_cpu(device, card, NB=32, NF=4):
    """Float64 card against CPU: the work-hardening and the cylindrical
    fixtures through phase 13a's three steps at NB x NB (glob_sig within
    1e-9 relative, the same CG histories), and the cylindrical faithful
    solve at NF x NF (1e-6, phase 9's bound for a flipped Brent
    iterate)."""
    import torch
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    cpu, f64 = torch.device('cpu'), torch.float64
    for name in ('svc_wh', 'svc_cyl'):
        res = {}
        for dev in (device, cpu):
            mat, CV, eps = fixture(name, f64, dev)
            md = fek.rect_mesh(NB, NB, LX=1., LY=1., uniax='y', eps_tot=eps,
                               dtype=f64, device=dev)
            st, d, _, iters, _, khards = layout_steps(md, mat, CV, f64, 2,
                                                      dev)
            res[dev.type] = (d['glob_sig'].cpu(), iters, khards)
        (ga, ia, ka), (gb, ib, kb) = res[device.type], res['cpu']
        eg = float((ga - gb).abs().max() / gb.abs().max())
        ok = eg <= 1e-9 and ia == ib
        log(f'[13e card vs cpu] {name} {NB}x{NB} three 0.25 steps float64: '
            f'glob_sig rel {eg:.2e} (bound 1e-9); cg_iters_hist card {ia} '
            f'cpu {ib}; khard_of card {[f"{k:.4f}" for k in ka]} cpu '
            f'{[f"{k:.4f}" for k in kb]} {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'card and CPU disagree on the {name} steps')
    reset_counts()
    # the first 4 of the protocol's 8 increments (the card's side is
    # host-bound: 16 faithful rounds a step)
    sa, ha, _ = cyl_faithful(NF, f64, device, nsteps=4)
    widths = by_width()
    sb, hb, _ = cyl_faithful(NF, f64, cpu, nsteps=4)
    ga, gb = ha[-1][0].cpu(), hb[-1][0]
    eg = float((ga - gb).abs().max() / gb.abs().max())
    ok = eg <= 1e-6 and widths['svc_yf_root'].get(2, 0) > 0
    log(f'[13e card vs cpu] cylindrical faithful solve {NF}x{NF} float64: '
        f'glob_sig rel {eg:.2e} (bound 1e-6); launches on the card by '
        f'feature count {widths} {"ok" if ok else "FAIL"}')
    if not ok:
        fail('card and CPU disagree on the cylindrical faithful solve')


# -----------------------------------------------------------------
# training and inverse identification (phases 14a-14e)
# -----------------------------------------------------------------
#: the Hill training set of ``examples/train_hill.py`` with the JAX
#: trainer's decision values on a probe set
#: (``tools/make_torch_svc_fixtures.py``)
TRAIN = os.path.join(DATA, 'train_hill.npz')
#: the hidden material of ``examples/calibrate_plasticity.py``
CAL_HILL, CAL_SY, CAL_KHARD = (1.3, 0.85, 1., 1., 1., 1.), 180., 800.


def phase_train(device, card):
    """14a: ``ml_train.train_svc`` on the card in float32 at the JAX
    backend's 4000 iterations on the ~15,000 points of ``TRAIN``: its
    seconds (the projected-gradient steps read the N x N matrix Q once
    each), its training accuracy (at least 97 %), and its decision values
    on the probe set against the JAX trainer's (within 1e-2 of their
    scale, 99 % of the signs equal)."""
    import torch
    from pylabfea_tpu_torch import ml_train
    from pylabfea_tpu_torch.ops import constitutive as con
    z = np.load(TRAIN)
    X, y = z['X'], z['y'].astype(np.float32)
    n, iters = len(y), int(z['iters'])
    sync(device)
    t0 = time.perf_counter()
    mat, score, params = ml_train.train_svc(
        X, y, float(z['sy']), C=float(z['C']), gamma=float(z['gamma']),
        iters=iters, dtype=torch.float32, device=device)
    sync(device)
    dt = time.perf_counter() - t0
    f = con.svc_decision(mat, torch.as_tensor(
        z['probe'], dtype=torch.float32, device=device)).double().cpu()
    fj = torch.as_tensor(z['f_probe_jax'])
    err = float((f - fj).abs().max() / fj.abs().max())
    same = float((torch.sign(f) == torch.sign(fj)).double().mean())
    q_bytes = 4. * n * n * iters
    ok = score >= 97. and err <= 1e-2 and same >= 0.99
    log(f'[14a train] ml_train.train_svc on {n} points (Hill rv '
        f'{[float(v) for v in z["rv"]]}, sy {float(z["sy"]):g}; C {float(z["C"]):g}, gamma '
        f'{float(z["gamma"]):g}, {iters} iterations, f32): {dt:.3f} s '
        f'(Q read {iters} times, {q_bytes / 1e12:.2f} TB: HBM bound '
        f'{q_bytes / HBM_BPS:.3f} s); training accuracy {score:.2f} % (JAX '
        f'{float(z["acc_jax"]):.2f} %), {params["sv"].shape[0]} SVs (JAX '
        f'{int(z["nsv_jax"])}); decision values on {len(fj)} probe points '
        f'vs the JAX trainer: max rel err {err:.3e} (bound 1e-2), same sign '
        f'{100 * same:.2f} % {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('the SVC trained on the card misses its accuracy or the JAX '
             "trainer's decision values")
    return dict(mat=mat, params=params, seconds=dt, score=score,
                CV=z['CV'], X=X, hill=z['hill'])


def phase_serve_trained(device, trained, NB, card):
    """14b: the SVC of 14a through kernels G, A, D and B: ``ml_yf_dist``
    on 256 training directions against the analytic Hill locus of its
    reference (at least 95 % of them within 0.05, the half gap between
    the training bands at 0.95 and 1.05 of the locus, and the median
    within 0.01: the fit misclassifies 0.08 % of its points, the JAX
    trainer's too, so a few directions lie further out), ``response_fast``
    on 2^20 states (64 lanes against the CPU under phase 4's rule) and
    one warm NB x NB step of phase 5's protocol with sigma_yy in (0.5 sy,
    2 sy).  Every count is set to 0 before these and read after.  Then
    G, A and D against their plain versions at those shapes (phase 3's
    rules), with their times and bounds."""
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import constitutive as con
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    from pylabfea_tpu_torch.ops import jtensors as jt
    f32 = torch.float32
    mat, X = trained['mat'], trained['X']
    sy = mat.sy
    CV = torch.as_tensor(trained['CV'], dtype=f32, device=device)
    rows = np.random.default_rng(8).choice(len(X), 256, replace=False)
    u = torch.as_tensor(X[rows], dtype=torch.float64)
    u = u / jt.seq_j2_voigt(u)[:, None]
    hill = convert.material_from_params(
        dict(hill=trained['hill'], sy=sy, khard=0., drucker=0.),
        is_svc=False, dtype=torch.float64, device='cpu')
    s_hill = sy / con.seq_hill(hill, u)
    N = 2 ** 20
    sig_np, deps_np = return_map_states(N, sy=sy)
    sig = torch.as_tensor(sig_np, dtype=f32, device=device)
    deps = torch.as_tensor(deps_np, dtype=f32, device=device)
    md = fek.rect_mesh(NB, NB, LX=1., LY=1., uniax='y', eps_tot=0.002,
                       dtype=f32, device=device)
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    dist = con.ml_yf_dist(mat, (u * sy).to(device=device, dtype=f32),
                          torch.zeros(len(rows), dtype=f32, device=device))
    sync(device)
    t1 = time.perf_counter()
    out = con.response_fast(mat, (sig, torch.zeros_like(sig)), deps, CV, 12)
    sync(device)
    t2 = time.perf_counter()
    st, d, times, iters, widths, _ = layout_steps(md, mat, CV, f32, 1,
                                                  device)
    launches = {c.__name__: c.launches for c in counters()}
    s_ml = sy - dist.double().cpu()
    lerr = (s_ml - s_hill).abs() / s_hill
    mc = convert.material_from_params(
        dict(hill=np.ones(6), sy=sy, khard=0., drucker=0., scale_seq=sy,
             **trained['params']), is_svc=True, dtype=f32, device='cpu')
    pick = np.random.default_rng(5).choice(N, 64, replace=False)
    ref = con.response_fast(mc, (torch.as_tensor(sig_np[pick], dtype=f32),
                                 torch.zeros(64, 6)),
                            torch.as_tensor(deps_np[pick], dtype=f32),
                            CV.cpu(), 12)
    na, ea = lanes_vs_cpu(out, ref, pick)
    nbad = sum(int((~torch.isfinite(o.reshape(N, -1))).any(-1).sum())
               for o in out)
    gsig = d['glob_sig'].double().cpu().numpy()
    fin = finite(st.u, st.sig, st.epl, st.elstiff, dist)
    within = float((lerr <= 0.05).double().mean())
    ok = (fin and within >= 0.95 and float(lerr.median()) <= 0.01
          and na >= 48
          and nbad <= 1e-3 * N and 0.5 * sy < gsig[1] < 2. * sy
          and all(launches[k] > 0 for k in ('svc_yf_root', 'svc_f_grad',
                                            'svc_decision', 'k_apply')))
    log(f'[14b serve trained] ml_yf_dist on {len(rows)} training directions '
        f'{(t1 - t0) * 1e3:.2f} ms: locus vs the analytic Hill locus rel '
        f'err median {float(lerr.median()):.3e} (bound 1e-2), within 0.05 '
        f'{100 * within:.1f} % (bound 95 %), max {float(lerr.max()):.3e}; '
        f'response_fast N={N} {(t2 - t1) * 1e3:.2f} ms, plastic '
        f'lanes {int((out[2].abs().sum(-1) > 0).sum())}, non-finite lanes '
        f'{nbad}, vs the CPU on 64 lanes {na} agree (max rel err of f, sig, '
        f'depl, tangent {", ".join(f"{e:.2e}" for e in ea)}); {NB}x{NB} '
        f'load_step_split(0.25, n_inner=2) warm step {times[0]:.4f} s, '
        f'cg_iters_hist {iters}, glob_sig '
        f'{np.array2string(gsig, precision=4, max_line_width=200)}; '
        f'launches {launches} {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('the trained SVC: locus off the Hill reference, CPU '
             'disagreement, non-finite fields, axial stress out of range or '
             'kernels A/B/D/G not launched')
    # kernels A, D and G against their plain versions at the shapes this
    # path gave them: G on the same 256 stresses (float32 under phase 4's
    # rule, float64 within 1e-6), A and D at 2^20 points x the trained SVs
    # (float32 against the plain float64 version on the first 2^16 points)
    pfix = {k: trained['params'][k] for k in ('sv', 'dc', 'gamma', 'rho')}

    def mat_of(dtype):
        return convert.material_from_params(
            dict(hill=np.ones(6), sy=sy, khard=0., drucker=0., scale_seq=sy,
                 **trained['params']), is_svc=True, dtype=dtype,
            device=device)

    checks = dict(
        svc_f_grad=[check_svc(device, N, pfix, 10, card, n_ref=2 ** 16,
                              plain_rows=2 ** 17)],
        svc_decision=[check_svc_mm(device, N, pfix, 10, card, 'D',
                                   n_ref=2 ** 16, plain_rows=2 ** 17)],
        svc_yf_root=[check_yf_root(device, len(rows), mat_of, 20, card,
                                   'card-trained',
                                   sig_np=(u * sy).numpy())])
    return dict(launches=launches, step_s=times[0], locus_err=float(
        lerr.max()), checks=checks)


def cal_paths(npaths, nsteps, seed=0):
    """Strain paths (npaths, nsteps, 6): random unit directions, five
    small steps through the yield onset, then 1.6e-3 steps (the JAX
    package's Voce round trip)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(npaths, 6))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    steps = np.full(nsteps, 1.6e-3)
    steps[:5] = 2.5e-4
    return dirs[:, None, :] * steps[None, :, None]


def cal_theta(dtype, device):
    import torch
    t = dict(log_sy=np.log(CAL_SY), log_hill=np.log(CAL_HILL),
             raw_dsy=CAL_KHARD)          # softplus(800) is 800 in float64
    return {k: torch.as_tensor(np.asarray(v, float), dtype=dtype,
                               device=device) for k, v in t.items()}


def replays():
    """Replays so far of each CUDA-graphed function (``graphs.Graphed``):
    the fixed-trip return map and the implicit projection's Newton solve
    and tangents."""
    from pylabfea_tpu_torch.ops import graphs
    return {g.fn.__name__: g.replays for g in graphs.INSTANCES}


def check_graphs(card):
    """Fail if any CUDA-graph capture failed (its calls then ran
    eagerly)."""
    from pylabfea_tpu_torch.ops import graphs
    failed = {g.fn.__name__: list(g.failed.values())
              for g in graphs.INSTANCES if g.failed}
    log(f'[14 graphs] graphs kept '
        f'{ {g.fn.__name__: len(g.graphs) for g in graphs.INSTANCES} }, '
        f'replays {replays()}, failed captures {failed or "none"}  [{card}]')
    if failed:
        fail(f'CUDA-graph captures failed: {failed}')


def phase_calibrate(device, card, npaths=1024, nsteps=30):
    """14c: ``calibrate.fit_plasticity`` round trip on the card: paths of
    the hidden material of ``examples/calibrate_plasticity.py``
    simulated by the port's ``simulate_paths`` (npaths x nsteps), then
    fitted from the paths alone, under the tolerances of the JAX
    package's round-trip test (cost < 1e-6; sy within 5e-3, khard 2e-2,
    hill 1e-2 in the uniax_x gauge; simulated paths within 1e-2 rms): in
    float64 and in float32 with the unrolled integrator, and in float64
    with the implicit one (its data simulated by it too)."""
    import torch
    from pylabfea_tpu_torch.ops import calibrate as cal
    CVn = elastic_cv()
    ct = 0.5 * (CAL_HILL[0] + CAL_HILL[2])
    rct = np.sqrt(ct)
    out = {}
    for name, dtype, integ in (('f64', torch.float64, 'unrolled'),
                               ('f32', torch.float32, 'unrolled'),
                               ('f64 implicit', torch.float64, 'implicit')):
        deps = torch.as_tensor(cal_paths(npaths, nsteps), dtype=dtype,
                               device=device)
        CV = torch.as_tensor(CVn, dtype=dtype, device=device)
        sync(device)
        t0 = time.perf_counter()
        with torch.no_grad():
            sig = cal.simulate_paths(cal_theta(dtype, device), CV, deps, 40,
                                     integrator=integ)
        sync(device)
        t1 = time.perf_counter()
        r0 = replays()
        params, info = cal.fit_plasticity(deps, sig, CV, integrator=integ)
        sync(device)
        t2 = time.perf_counter()
        e_sy = abs(params['sy'] - CAL_SY / rct) / (CAL_SY / rct)
        e_kh = abs(params['khard'] - CAL_KHARD / rct) / (CAL_KHARD / rct)
        e_hill = float(np.max(np.abs(params['hill'] - np.array(CAL_HILL) / ct)
                              / (np.array(CAL_HILL) / ct)))
        sig_np = sig.double().cpu().numpy()
        rms = float(np.sqrt(np.mean((info['sim'] - sig_np) ** 2))
                    / np.sqrt(np.mean(sig_np ** 2)))
        ok = (info['loss'][-1] < 1e-6 and e_sy < 5e-3 and e_kh < 2e-2
              and e_hill < 1e-2 and rms < 1e-2)
        steps = len(info['step_s'])
        log(f'[14c calibrate {name}] {npaths} paths x {nsteps} steps '
            f'({integ}, maxiter 40): data {t1 - t0:.3f} s; fit_plasticity '
            f'{t2 - t1:.3f} s, {steps} LM steps, '
            f'{np.mean(info["step_s"]):.3f} s a step (each a forward-mode '
            f'Jacobian of {len(params["hill"]) + 2} columns); cost '
            f'{info["loss"][0]:.3e} -> {info["loss"][-1]:.3e} (bound 1e-6); '
            f'rel err sy {e_sy:.2e} (5e-3), khard {e_kh:.2e} (2e-2), hill '
            f'{e_hill:.2e} (1e-2); paths rms {rms:.2e} (1e-2); calls '
            f'replayed from CUDA graphs '
            f'{ {k: v - r0[k] for k, v in replays().items()} } '
            f'{"ok" if ok else "FAIL"}  [{card}]')
        if not ok:
            fail(f'calibrate round trip ({name}) misses its tolerances')
        out[name] = dict(seconds=t2 - t1, steps=steps,
                         step_s=float(np.mean(info['step_s'])))
    return out


def femu_specimen(N, dtype, device):
    """The two-material inclusion of the JAX package's FEMU test at N x N:
    a Hill matrix (hill[0] 1.25, sy 150, khard 300) around a centred
    elastic inclusion (E 60 GPa) of half the width, uniaxial y to 0.4 %
    strain.  Returns (mesh, builder theta -> materials, CVs, truth)."""
    import dataclasses
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    mm = np.zeros((N, N), dtype=int)
    mm[N // 4:3 * N // 4, N // 4:3 * N // 4] = 1
    md = fek.rect_mesh(N, N, LX=1., LY=1., uniax='y', eps_tot=0.004,
                       mat_map=mm, dtype=dtype, device=device)
    base = convert.material_from_params(
        dict(hill=[1.25, 0.9, 1., 1., 1., 1.], sy=150., khard=300.,
             drucker=0.), is_svc=False, dtype=dtype, device=device)
    incl = convert.elastic_material(dtype=dtype, device=device)

    def build(theta):
        sy = torch.exp(theta['log_sy'])
        hill = torch.cat([torch.exp(theta['log_h0']).reshape(1),
                          base.hill[1:]])
        return (dataclasses.replace(base, hill=hill, sy=sy, scale_seq=sy),
                incl)
    truth = {k: torch.tensor(np.log(v), dtype=dtype, device=device)
             for k, v in (('log_sy', 150.), ('log_h0', 1.25))}
    return md, build, (elastic_cv(), elastic_cv(60.e3)), truth


def phase_femu(device, card, N=16):
    """14d: ``femu.fit_field`` on the card: the inclusion's displacement
    field at N x N (two half steps, the JAX defaults: 40 fixed trips, 14
    secant-Picard rounds), then sy and hill[0] back from (130, 1.0) to the
    JAX test's tolerance (cost < 1e-16, both within 1e-6)."""
    import torch
    from pylabfea_tpu_torch.ops import femu
    f64 = torch.float64
    md, build, CVs, truth = femu_specimen(N, f64, device)
    sync(device)
    t0 = time.perf_counter()
    u_meas, _, epl, _ = femu.simulate(md, build(truth), CVs, [0.5, 0.5])
    sync(device)
    t1 = time.perf_counter()
    theta0 = {'log_sy': torch.tensor(np.log(130.), dtype=f64, device=device),
              'log_h0': torch.tensor(0., dtype=f64, device=device)}
    # 7 LM steps: the cost falls below its 1e-16 bound in the sixth (to
    # 1.7e-18) and stalls at ~4e-24 from the ninth (NVIDIA H100 80GB HBM3,
    # 700 W), where 10 steps spent 31 s
    theta, info = femu.fit_field(md, build, theta0, CVs, [0.5, 0.5], u_meas,
                                 steps=7)
    sync(device)
    t2 = time.perf_counter()
    sy = float(torch.exp(theta['log_sy']))
    h0 = float(torch.exp(theta['log_h0']))
    ok = (info['loss'][-1] < 1e-16 and abs(sy - 150.) < 1.5e-4
          and abs(h0 - 1.25) < 1.25e-6)
    log(f'[14d femu] fit_field on the {N}x{N} inclusion (float64): field '
        f'{t1 - t0:.3f} s (max plastic strain {float(epl.abs().max()):.3e}); '
        f'fit {t2 - t1:.3f} s, {len(info["step_s"])} LM steps, '
        f'{np.mean(info["step_s"]):.3f} s a step; cost '
        f'{" ".join(f"{c:.1e}" for c in info["loss"])} (bound 1e-16); sy {sy:.9f} (150), h0 '
        f'{h0:.9f} (1.25), rel bound 1e-6 {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('femu round trip misses its tolerances')
    return dict(seconds=t2 - t1, field_s=t1 - t0,
                step_s=float(np.mean(info['step_s'])))


def phase_train_card_vs_cpu(device, card):
    """14e: float64 card against CPU at small size, each within 1e-9
    relative: ``simulate_paths`` (8 paths x 8 steps, both integrators),
    one ``step_implicit`` on the 4 x 4 inclusion with one forward-mode
    column (d/d log sy), and the dual variables of ``fit_svc`` on the
    480-point training set (500 iterations)."""
    import torch
    from pylabfea_tpu_torch import ml_train
    from pylabfea_tpu_torch.ops import calibrate as cal
    from pylabfea_tpu_torch.ops import dual, femu
    f64, cpu = torch.float64, torch.device('cpu')
    res = {}
    for dev in (device, cpu):
        r = {}
        deps = torch.as_tensor(cal_paths(8, 8, seed=3), dtype=f64,
                               device=dev)
        CV = torch.as_tensor(elastic_cv(), dtype=f64, device=dev)
        for integ in ('unrolled', 'implicit'):
            r[integ] = cal.simulate_paths(cal_theta(f64, dev), CV, deps, 40,
                                          integrator=integ).cpu()
        md, build, CVs, truth = femu_specimen(4, f64, dev)
        mdf = femu.flatten_mesh(md)
        th = dict(truth, log_sy=dual.Dual(truth['log_sy'], torch.ones(
            1, dtype=f64, device=dev)))
        sig0 = torch.zeros((md.nel, 6), dtype=f64, device=dev)
        du, _, _ = femu.step_implicit(mdf, build(th), CVs, sig0, sig0,
                                      mdf.fixed_val * 0.5)
        r['du'], r['jvp'] = du.v.cpu(), du.t[0].cpu()
        z = np.load(os.path.join(DATA, 'train_small.npz'))
        _, r['dual'] = ml_train.fit_svc(z['X'], z['y'].astype(float),
                                        C=float(z['C']),
                                        gamma=float(z['gamma']), iters=500,
                                        dtype=f64, device=dev)
        r['dual'] = torch.as_tensor(r['dual'])
        res[dev.type] = r
    errs = {k: float((res[device.type][k] - res['cpu'][k]).abs().max()
                     / res['cpu'][k].abs().max()) for k in res['cpu']}
    ok = all(e <= 1e-9 for e in errs.values())
    log(f'[14e card vs cpu] float64, rel err card vs CPU: '
        + ', '.join(f'{k} {e:.2e}' for k, e in errs.items())
        + f' (bound 1e-9) {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('card and CPU disagree on the training or identification paths')
    return errs


def check_svc_mm_forms(device, params, card):
    """Kernel E at one N in each of its launch forms (a group of GT = 8,
    16 and 32 threads a point; P = 1, 2 and 4 points a thread) in float32,
    against the plain float64 version under kernel A's bounds, and the
    first 1024 points of each launch against a launch on those 1024 points
    alone (GT = 32): the same bits, whatever form the whole launch took."""
    import torch
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    fill = torch.cuda.get_device_properties(device).multi_processor_count \
        * 1024
    sv64 = torch.as_tensor(params['sv'], dtype=torch.float64, device=device)
    dc64 = torch.as_tensor(params['dc'], dtype=torch.float64, device=device)
    sv, dc = sv64.float(), dc64.float()
    gamma, rho = float(params['gamma']), float(params['rho'])
    ftol = 2e-5 * max(1., float(dc64.abs().sum()))
    errs = []
    for form, N in (('GT=8', fill // 16), ('GT=16', fill // 64),
                    ('GT=32', 1024), ('P=1', fill), ('P=2', 2 * fill + 5),
                    ('P=4', 4 * fill + 5)):
        rng = np.random.default_rng(7)
        u = rng.normal(size=(N, 6))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        x64 = torch.as_tensor(u * rng.uniform(0.3, 1.3, (N, 1)),
                              dtype=torch.float64, device=device)
        x = x64.float()
        f, g = sk.svc_f_grad_mm(x, sv, dc, gamma, rho)
        fs, gs = sk.svc_f_grad_mm(x[:1024].contiguous(), sv, dc, gamma, rho)
        fr, gr = sk.svc_f_grad_plain(x64, sv64, dc64, gamma, rho)
        sync(device)
        gtol = ftol * 2. * gamma * (float(x64.abs().max())
                                    + float(sv64.abs().max()))
        ef = float((f.double() - fr).abs().max())
        eg = float((g.double() - gr).abs().max())
        same = torch.equal(fs, f[:1024]) and torch.equal(gs, g[:1024])
        ok = ef <= ftol and eg <= gtol and same
        log(f'[3 kernel E] svc_f_grad_mm {form} N={N} nsv={sv.shape[0]} f32 '
            f'vs plain f64: max|err| f {ef:.3e} (bound {ftol:.3e}), g '
            f'{eg:.3e} (bound {gtol:.3e}); first 1024 bitwise those of a '
            f'1024-point launch: {same} {"ok" if ok else "FAIL"}  [{card}]')
        if not ok:
            fail(f'svc_f_grad_mm {form} disagrees with its plain version or '
                 'with its 1024-point launch')
        errs.append(max(ef, eg))
    return max(errs), None, None, None


# -----------------------------------------------------------------
# the host-model bridge (phase 15)
# -----------------------------------------------------------------
#: the bridge's committed records (``tools/make_torch_bridge_fixtures.py``)
BRIDGE_FIXTURES = ('bcnode', 'ml_shear', 'bar_sf1', 'bar_sf2', 'resume')
#: records not solved again on the CPU in 15e (the ML shear record's
#: faithful solve took 20-30 s on the host CPU of an NVIDIA H100 80GB HBM3
#: machine): the card is held against the JAX device solver's committed
#: fields alone
NO_CPU = ('ml_shear',)


def elastic_of(CV):
    """(E, nu) of an isotropic stiffness (6, 6)."""
    nu = CV[0, 1] / (CV[0, 0] + CV[0, 1])
    return 2. * CV[3, 3] * (1. + nu), nu


def locus_dirs(trained):
    """14b's 256 training directions (unit J2 stress) and the analytic
    Hill locus stress along each."""
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import constitutive as con
    from pylabfea_tpu_torch.ops import jtensors as jt
    X = trained['X']
    rows = np.random.default_rng(8).choice(len(X), 256, replace=False)
    u = torch.as_tensor(X[rows], dtype=torch.float64)
    u = u / jt.seq_j2_voigt(u)[:, None]
    hill = convert.material_from_params(
        dict(hill=trained['hill'], sy=trained['mat'].sy, khard=0.,
             drucker=0.), is_svc=False, dtype=torch.float64, device='cpu')
    return u, trained['mat'].sy / con.seq_hill(hill, u), hill


def locus_rule(lerr):
    """14b's rule: at least 95 % within 0.05, the median within 0.01."""
    within = float((lerr <= 0.05).double().mean())
    return within >= 0.95 and float(lerr.median()) <= 0.01, within


def phase_compress(device, trained, card):
    """15a: ``reduce_svc`` of 14a's SVC at 'auto' (abs_tol = 0.1
    yf_tolerance, the doubling from 16 centers): k, the relative RKHS
    error and the seconds; max |f - f~| on 2^16 probe stresses within
    abs_tol (plus the float64 rounding of the sums); the compressed locus
    against the analytic Hill locus by 14b's rule; then A and D at 2^20
    points x k against their plain versions (phase 3's rules).  Returns
    (compressed material record, checks)."""
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.config import yf_tolerance
    from pylabfea_tpu_torch.ops import constitutive as con
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    p = trained['params']
    E, nu = elastic_of(trained['CV'])
    sy = trained['mat'].sy
    mrec = convert.material_record_from(E, nu, sy=sy, svc=p)
    sync(device)
    t0 = time.perf_counter()
    red = convert.compress_record(mrec, 'auto', device)
    sync(device)
    dt = time.perf_counter() - t0
    m, k, rel = p['sv'].shape[0], red['sv_red'].shape[0], red['compress_rel']
    abs_tol = 0.1 * yf_tolerance
    f64 = dict(dtype=torch.float64, device=device)
    sv, dc = (torch.as_tensor(p[n], **f64) for n in ('sv', 'dc'))
    svr, dcr = (torch.as_tensor(red[n], **f64) for n in ('sv_red',
                                                          'dc_red'))
    wnorm = float(torch.sqrt(dc @ (torch.exp(-p['gamma'] * sk.rbf_d2(
        sv, sv)) @ dc)))
    rng = np.random.default_rng(11)
    u = rng.normal(size=(2 ** 16, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    x = torch.as_tensor(u * rng.uniform(0.3, 2.0, (2 ** 16, 1)), **f64)
    err = 0.
    for i in range(0, x.shape[0], 2 ** 13):
        f = sk.svc_f_grad_plain(x[i:i + 2 ** 13], sv, dc, p['gamma'],
                                p['rho'], with_grad=False)[0]
        fr = sk.svc_f_grad_plain(x[i:i + 2 ** 13], svr, dcr, p['gamma'],
                                 p['rho'], with_grad=False)[0]
        err = max(err, float((f - fr).abs().max()))
    rnd = 1e-12 * (float(dc.abs().sum()) + float(dcr.abs().sum()))
    ok_err = err <= abs_tol + rnd and rel * wnorm <= abs_tol * (1. + 1e-9)
    mat = convert.material_from_record(red, dtype=torch.float32,
                                       device=device)
    u_dir, s_hill, _ = locus_dirs(trained)
    dist = con.ml_yf_dist(mat, (u_dir * sy).to(device=device,
                                               dtype=torch.float32),
                          torch.zeros(256, dtype=torch.float32,
                                      device=device))
    lerr = ((sy - dist.double().cpu()) - s_hill).abs() / s_hill
    ok_loc, within = locus_rule(lerr)
    ok = ok_err and ok_loc and k <= m
    log(f'[15a compress] reduce_svc of the card-trained SVC ({m} SVs) at '
        f"'auto' (abs_tol {abs_tol:.1e}): k {k} centers, relative RKHS error "
        f'{rel:.3e} (|w|_H {wnorm:.4g}, absolute {rel * wnorm:.3e}), '
        f'{dt:.3f} s; max|f - f~| on 2^16 probes {err:.3e} (bound '
        f'{abs_tol:.1e} + {rnd:.1e}); compressed locus vs Hill: median '
        f'{float(lerr.median()):.3e}, within 0.05 {100 * within:.1f} %, max '
        f'{float(lerr.max()):.3e} {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('the compression breaks its RKHS bound or moves the locus off '
             'the Hill reference')
    pred = dict(sv=red['sv_red'], dc=red['dc_red'], gamma=p['gamma'],
                rho=p['rho'])
    checks = dict(
        svc_f_grad=[check_svc(device, 2 ** 20, pred, 10, card, n_ref=2 ** 16,
                              plain_rows=2 ** 17)],
        svc_decision=[check_svc_mm(device, 2 ** 20, pred, 10, card, 'D',
                                   n_ref=2 ** 16, plain_rows=2 ** 17)])
    log(f'[15a compress] A at 2^20 x {k}: {checks["svc_f_grad"][0][1]:.4f} '
        f'ms, D {checks["svc_decision"][0][1]:.4f} ms (14b at x {m}: A '
        f'{trained["served_ms"][0]:.4f}, D {trained["served_ms"][1]:.4f} '
        f'ms)  [{card}]')
    return dict(mrec=mrec, red=red, k=k, rel=rel, seconds=dt), checks


def launches_now():
    return {c.__name__: c.launches for c in counters()}


#: bound of 15b's |glob_sig auto - raw| / |sigma_yy|: the f32 solve's own
#: noise floor is about 1e-2 (``python -m pylabfea_tpu_torch.bridge_study``
#: on an NVIDIA H100 80GB HBM3 at 700 W: one float32 ulp on the raw SVC's
#: dual coefficients moves glob_sig by 8.5e-3 of sigma_yy at 1024^2, auto
#: against raw 2.4e-2 in that run)
SOLVE_NOISE = 5e-2
#: 15b's load steps: the final strain in 20 steps.  The step is n_inner 2
#: rounds with no gate, so its result depends on the step size: in 10
#: steps sigma_yy came out 92.25 against 77.28 in 20 (the raw SVC, both
#: bitwise reproducible), and the compressed SVC's solve, whose centers
#: differ run to run in their last bits (``reduce_svc`` sums clusters with
#: ``index_add`` on the card), landed 2.6e-2 to 1.06e-1 of sigma_yy from
#: the raw one, past SOLVE_NOISE in 2 of 4 runs; in 20 steps 4.0e-3 to
#: 7.4e-3 over 3 runs (NVIDIA H100 80GB HBM3, 700 W)
NSTEPS_15B = 20


def phase_bridge_solve(device, comp, trained, card, N=1024, eps=0.002):
    """15b: ``solve_record`` (the body of ``solve_on_device``) at N x N
    from a record built from arrays: phase 5's geometry (1 x 1, plane
    strain, left / bottom supports, top displaced by eps), the compressed
    card-trained SVC, compress='auto', f32, nsteps=20, n_inner=2; A, B and
    D must launch, sigma_yy in (0.5 sy, 2 sy); then the same solve with
    the raw SVC (compress=None): max |glob_sig auto - raw| / |sigma_yy|
    within ``SOLVE_NOISE``."""
    from pylabfea_tpu_torch import bridge
    sy = trained['mat'].sy
    out = {}
    for name, mrec, compress in (('auto', comp['red'], 'auto'),
                                 ('raw', comp['mrec'], None)):
        rec = bridge.grid_record(N, N, [mrec], [trained['CV']],
                                 bct=(0., eps), ubctop=(False, True))
        sync(device)
        reset_counts()
        t0 = time.perf_counter()
        res = bridge.solve_record(rec, nsteps=NSTEPS_15B, n_inner=2,
                                  compress=compress, device=device)
        sync(device)
        out[name] = (res, time.perf_counter() - t0, launches_now())
    res, dt, launches = out['auto']
    gsig = res['sgl'][-1]
    diff = np.abs(gsig - out['raw'][0]['sgl'][-1]).max() / abs(gsig[1])
    ok = (np.isfinite(res['u']).all() and np.isfinite(res['sig']).all()
          and 0.5 * sy < gsig[1] < 2. * sy and diff <= SOLVE_NOISE
          and all(launches[k] > 0 for k in ('svc_f_grad', 'k_apply',
                                            'svc_decision')))
    log(f'[15b solve_on_device] {N}x{N} record from arrays, SVC k '
        f"{comp['k']}, compress='auto', f32, {NSTEPS_15B} steps x (n_inner "
        f'2): {dt:.3f} s ({dt / NSTEPS_15B:.4f} s a step); raw '
        f'{comp["red"]["sv"].shape[0]} SVs {out["raw"][1]:.3f} s '
        f'({out["raw"][1] / NSTEPS_15B:.4f} s a step); '
        f'glob_sig {np.array2string(gsig, precision=4, max_line_width=200)},'
        f' sigma_yy {gsig[1]:.4f} in ({0.5 * sy:g}, {2 * sy:g}); |glob_sig '
        f'auto - raw| / |sigma_yy| {diff:.3e} (bound {SOLVE_NOISE:g}); '
        f'launches {launches} '
        f'{"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('solve_on_device: non-finite fields, axial stress out of range, '
             'auto and raw apart beyond the noise floor or kernels A/B/D not '
             'launched')
    return dict(launches=launches, seconds=dt, diff=diff)


def phase_bridge_adaptive(device, comp, trained, card, N=1024, NS=32,
                          eps_svc=0.0005):
    """15c: ``solve_record_adaptive`` (the body of
    ``solve_on_device_adaptive``) at N x N on ``tests/test_bridge.py``'s
    ``_model`` (J2 sy 150, khard 1000, 4 x 4, top 0.002 LY, right edge
    force-free) from arrays, f64, fast=True; B must launch.  Then the
    compressed card-trained SVC at NS x NS, top eps_svc (twice its yield
    strain), f64, fast=False: D, E and G must launch, G also in the
    fixed-direction root find of the load-step scaling (``HostLaw.
    ml_full_yf``)."""
    import torch
    from pylabfea_tpu_torch import bridge, convert
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    f64 = torch.float64
    j2 = convert.material_record_from(200.e3, 0.3, sy=150., khard=1000.)
    rec = bridge.grid_record(N, N, [j2], [convert.elastic_cv(200.e3, 0.3)],
                             LX=4., LY=4., bct=(0., 0.008),
                             ubctop=(False, True))
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    res = bridge.solve_record_adaptive(rec, dtype=f64, fast=True,
                                       device=device)
    sync(device)
    dt = time.perf_counter() - t0
    la = launches_now()
    gsig = res['sgl'][-1]
    ok = (np.isfinite(res['u']).all() and la['k_apply'] > 0
          and 150. < gsig[1] < 300.)
    log(f'[15c adaptive] J2 {N}x{N} f64 fast: {res["nsteps"]} increments, '
        f'niter {res["niter"]}, {dt:.3f} s; sigma_yy {gsig[1]:.4f}; '
        f'launches {la} {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('solve_on_device_adaptive (J2, 1024^2): non-finite, sigma_yy '
             'off or kernel B not launched')
    rec = bridge.grid_record(NS, NS, [comp['red']], [trained['CV']],
                             bct=(0., eps_svc), ubctop=(False, True))
    fixed = []
    orig = bridge.HostLaw.ml_full_yf

    def counted(self, *a, **kw):
        n0 = sk.svc_yf_root.launches
        out = orig(self, *a, **kw)
        fixed.append(sk.svc_yf_root.launches - n0)
        return out

    bridge.HostLaw.ml_full_yf = counted
    try:
        sync(device)
        reset_counts()
        t0 = time.perf_counter()
        res2 = bridge.solve_record_adaptive(rec, dtype=f64, fast=False,
                                            device=device)
        sync(device)
    finally:
        bridge.HostLaw.ml_full_yf = orig
    dt2 = time.perf_counter() - t0
    lb = launches_now()
    gsig2 = res2['sgl'][-1]
    sy = trained['mat'].sy
    ok = (np.isfinite(res2['u']).all() and sum(fixed) > 0
          and 0.5 * sy < gsig2[1] < 2. * sy
          and all(lb[k] > 0 for k in ('svc_decision', 'svc_f_grad_mm',
                                      'svc_yf_root')))
    log(f'[15c adaptive] compressed SVC (k {comp["k"]}) {NS}x{NS} f64 '
        f'faithful: {res2["nsteps"]} increments, niter {res2["niter"]}, '
        f'{dt2:.3f} s; sigma_yy {gsig2[1]:.4f}; G in the fixed-direction '
        f'root find {sum(fixed)} launches ({len(fixed)} calls); launches '
        f'{lb} {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('solve_on_device_adaptive (SVC, faithful): non-finite, '
             'sigma_yy off, kernels D/E/G not launched or G not in the '
             'fixed-direction root find')
    return dict(launches={k: la[k] + lb[k] for k in la}, seconds=(dt, dt2),
                res2=res2, rec2=rec)


def hill_j2(hill, d):
    """J2 stress at the Hill locus along the stress direction d (6,)."""
    import torch
    from pylabfea_tpu_torch.ops import constitutive as con
    from pylabfea_tpu_torch.ops import jtensors as jt
    d = torch.as_tensor(np.asarray(d, float))[None]
    return float(hill.sy * jt.seq_j2_voigt(d) / con.seq_hill(hill, d))


def onset_direction(sel, CVps):
    """The elastic stress direction of a ``calc_properties`` load case:
    uniaxial stress for 'stx' / 'sty' (one edge displaced, the other
    free), CVps (eps_x, eps_y) where both edges are displaced."""
    from pylabfea_tpu_torch import bridge
    uniax, fx, fy = bridge.LOAD_CASES[sel]
    if uniax == 'x':
        return np.eye(6)[0]
    if uniax == 'y':
        return np.eye(6)[1]
    return CVps @ np.array([fx, fy, 0., 0., 0., 0.])


def phase_bridge_props(device, comp, trained, card, Nel=256, eps=0.001,
                       nsteps=10):
    """15d: ``properties_record`` (the body of
    ``calc_properties_on_device``) of the compressed SVC at Nel x Nel,
    f32, total strain ``eps`` in the touch step and ``nsteps`` more (4
    yield strains in 10 steps: a step's trial stress then overshoots the
    locus by about a quarter of sy; at the default 0.005 in 20 steps it
    overshoots by sy, and on fine meshes the 'sty' path's last stress
    leaves the locus, JAX's too: ``data/bridge_props.npz``), the
    four load cases: A, B and G must launch; prop and propJ2 yield
    strengths beside the analytic Hill values of the training material
    (rv [1.2, 1, 0.8, 1, 1, 1], sy 50), each within 5 %: propJ2 against
    the locus along the elastic stress direction of the load case (the
    onset), prop against the locus along the last stress."""
    import torch
    from pylabfea_tpu_torch import bridge, convert
    E, nu = elastic_of(trained['CV'])
    CVps = convert.elastic_cv(E, nu, planestress=True)
    _, _, hill = locus_dirs(trained)
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    props = bridge.properties_record(comp['red'], Nel=Nel, eps=eps,
                                     nsteps=nsteps, dtype=torch.float32,
                                     device=device)
    sync(device)
    dt = time.perf_counter() - t0
    la = launches_now()
    rows, ok = [], True
    for sel in bridge.LOAD_CASES:
        r = props[sel]
        on = hill_j2(hill, onset_direction(sel, CVps))
        fin = hill_j2(hill, r['sigeps']['sig'][-1])
        e1 = abs(r['propJ2']['ys'] - on) / on
        e2 = abs(r['prop']['ys'] - fin) / fin
        ok &= e1 <= 0.05 and e2 <= 0.05
        rows.append(f'{sel} propJ2 ys {r["propJ2"]["ys"]:.4f} (Hill onset '
                    f'{on:.4f}, {e1:.2%}), prop ys {r["prop"]["ys"]:.4f} '
                    f'(Hill at the last stress {fin:.4f}, {e2:.2%}), touch '
                    f'scale {r["scale"]:.4f}')
    ok &= all(la[k] > 0 for k in ('svc_f_grad', 'k_apply', 'svc_yf_root'))
    log(f'[15d calc_properties] compressed SVC {Nel}x{Nel} f32, eps {eps:g},'
        f' 4 cases x {nsteps + 1} steps: {dt:.3f} s; ' + '; '.join(rows)
        + f'; launches {la} '
        f'{"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('calc_properties_on_device: yield strengths off the Hill '
             'reference or kernels A/B/G not launched')
    return dict(launches=la, seconds=dt)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def phase_bridge_card_vs_cpu(device, comp, card):
    """15e: the committed records (``pylabfea_tpu_torch/data/bridge_*.npz``)
    solved in f64 on the card and on the CPU: the reference's golden values
    of ``ACCURACY.md`` (bcnode, ML-Hill-6D shear) or the host solver's
    results (the bars) within 1e-6, the resume case within 1e-6 of the JAX
    device solver's fields and within ``tests/test_bridge.py``'s
    tolerances of the host solver's; the card against the JAX device
    solver's committed fields and against the port on the CPU within 1e-9
    (u, sig, the history), the ML shear record against JAX's fields alone
    (``NO_CPU``).  Then ``hessian``, ``epl_dot`` and ``c_tan`` of the
    compressed SVC on the card against the CPU, 1e-12."""
    import torch
    from pylabfea_tpu_torch import bridge, convert
    from pylabfea_tpu_torch.ops import constitutive as con
    f64 = torch.float64
    for name in BRIDGE_FIXTURES:
        rec = bridge.load_record(os.path.join(DATA, f'bridge_{name}.npz'))
        t0 = time.perf_counter()
        card_res = bridge.run_record(rec, dtype=f64, device=device)
        t1 = time.perf_counter()
        cpu_res = None if name in NO_CPU else bridge.run_record(
            rec, dtype=f64, device='cpu')
        t2 = time.perf_counter()
        gold = []
        if 'gold.ref' in rec:
            for f, i, c, ref in zip(rec['gold.field'], rec['gold.index'],
                                    rec['gold.comp'], rec['gold.ref']):
                v = card_res[str(f)]
                v = v if i < 0 else v[i]
                v = v if c < 0 else v[c]
                gold.append(abs(v - ref) / abs(ref))
        elif name == 'resume':
            gold = [_rel(card_res[k], rec[f'jax.{k}'])
                    for k in ('u', 'sig', 'sgl')]
        else:
            gold = [_rel(card_res[k], rec[f'host.{k}'])
                    for k in ('u', 'sig', 'sgl')]
        host_ok = True
        if name == 'resume':
            host_ok = (np.abs(card_res['u'] - rec['host.u']).max() < 1e-7
                       and np.abs(card_res['sig']
                                  - rec['host.sig']).max() < 1e-3)
        fields = ('u', 'sig', 'sgl')
        cj = max(_rel(card_res[k], rec[f'jax.{k}']) for k in fields)
        cc = cj if cpu_res is None else max(_rel(card_res[k], cpu_res[k])
                                            for k in fields)
        ok = max(gold) <= 1e-6 and max(cc, cj) <= 1e-9 and host_ok
        cpu = 'not run' if cpu_res is None else f'{cc:.3e}'
        log(f'[15e records] {name} ({rec["solver"]}): golden max rel '
            f'{max(gold):.3e} (bound 1e-6), card vs JAX fields {cj:.3e}, '
            f'card vs CPU {cpu} (bound 1e-9); card {t1 - t0:.3f} s, CPU '
            f'{t2 - t1:.3f} s {"ok" if ok else "FAIL"}  [{card}]')
        if not ok:
            fail(f'bridge record {name}: golden values or card vs CPU off')
    mat = convert.material_from_record(comp['red'], dtype=f64, device=device)
    matc = convert.material_from_record(comp['red'], dtype=f64,
                                        device='cpu')
    sig_np, deps_np = return_map_states(256, seed=12, sy=mat.sy)
    CV = np.asarray(comp['CV'])
    errs = {}
    for dev, m in ((device, mat), ('cpu', matc)):
        t = dict(dtype=f64, device=dev)
        s, d = torch.as_tensor(sig_np, **t), torch.as_tensor(deps_np, **t)
        C = torch.as_tensor(CV, **t)
        peeq = torch.zeros(256, **t)
        errs[str(dev)] = [con.hessian(m, s).cpu(),
                          con.epl_dot(m, s, peeq, C, d).cpu(),
                          con.c_tan(m, s, C).cpu()]
    e = [_rel(a, b) for a, b in zip(errs[str(device)], errs['cpu'])]
    ok = max(e) <= 1e-12
    log(f'[15e records] hessian, epl_dot, c_tan of the compressed SVC on '
        f'256 stresses, f64 card vs CPU: {", ".join(f"{x:.2e}" for x in e)}'
        f' (bound 1e-12) {"ok" if ok else "FAIL"}')
    if not ok:
        fail('hessian / epl_dot / c_tan: card and CPU disagree')


def phase_bridge(device, trained, card):
    """Phase 15: the host-model bridge on records (15a-15e); the kernel
    checks at the compressed width, E on the faithful solve's shape and G
    on the fixed-direction root find's.  Returns launches by kernel and
    the checks."""
    import torch
    from pylabfea_tpu_torch import bridge, convert
    marks = [('start', time.perf_counter())]
    comp, checks = phase_compress(device, trained, card)
    marks.append(('15a', time.perf_counter()))
    comp['CV'] = trained['CV']
    b = phase_bridge_solve(device, comp, trained, card)
    marks.append(('15b', time.perf_counter()))
    c = phase_bridge_adaptive(device, comp, trained, card)
    marks.append(('15c', time.perf_counter()))
    d = phase_bridge_props(device, comp, trained, card)
    marks.append(('15d', time.perf_counter()))
    launches = {k: b['launches'][k] + c['launches'][k] + d['launches'][k]
                for k in b['launches']}
    pred = dict(sv=comp['red']['sv_red'], dc=comp['red']['dc_red'],
                gamma=trained['params']['gamma'],
                rho=trained['params']['rho'])
    NS = c['rec2']['NX']
    checks['svc_f_grad_mm'] = [check_svc_mm(device, NS * NS, pred, 20, card,
                                            'E')]
    # G on the fixed-direction root find of 15c's first increment: every
    # element's (zero) stress along the load direction, 2000 marching steps
    rec = c['rec2']
    mats = [convert.material_from_record(rec['materials'][0], dtype=dt,
                                         device=device)
            for dt in (torch.float32, torch.float64)]

    def law_of(dtype):
        return bridge.HostLaw.of(rec['materials'][0],
                                 mats[dtype == torch.float64])

    checks['svc_yf_root'] = [check_fixed_root(device, law_of, NS * NS,
                                              bridge._load_direction(rec),
                                              card)]
    marks.append(('E, G checks', time.perf_counter()))
    phase_bridge_card_vs_cpu(device, comp, card)
    marks.append(('15e', time.perf_counter()))
    total = marks[-1][1] - marks[0][1]
    split = ', '.join(f'{n} {t - marks[i][1]:.1f}'
                      for i, (n, t) in enumerate(marks[1:]))
    log(f'[15 bridge] launches (15b-15d) {launches}; phase 15 {total:.1f} s '
        f'({split} s)  [{card}]')
    return dict(launches=launches, checks=checks, seconds=total)


def check_fixed_root(device, law_of, N, ld, card):
    """Kernel G in the fixed-direction root find (``HostLaw.ml_full_yf``,
    2000 marching steps) against its plain version on the card, on N
    stresses at 0.3-2 sy (the elastic trial states of an increment):
    float64 distances within 1e-6 of their scale, float32 at least 48 of
    64 sampled lanes within 1e-3; then kernel and plain float32 times and
    the bound from the evaluations the kernel counted."""
    import torch
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    rng = np.random.default_rng(13)
    law32 = law_of(torch.float32)
    sy = law32.host.sy
    u = rng.normal(size=(N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig_np = u * sy * rng.uniform(0.3, 2.0, (N, 1))
    pick = np.random.default_rng(5).choice(N, 64, replace=False)
    seen, errs = {}, []

    def kernel(*a, **kw):
        seen['call'] = a, kw
        return sk.svc_yf_root(*a, **kw)

    for dtype in (torch.float32, torch.float64):
        law = law_of(dtype)
        sig = torch.as_tensor(sig_np, dtype=dtype, device=device)
        epl = torch.zeros_like(sig)
        d = law.ml_full_yf(sig, epl, ld, root=kernel)
        dp = law.ml_full_yf(sig, epl, ld, root=sk.svc_yf_root_plain)
        sync(device)
        scale = float(dp.abs().max())
        diff = (d - dp).abs().double().cpu().numpy()
        if dtype == torch.float64:
            err = float(diff.max())
            ok = err <= 1e-6 * scale
        else:
            agree = diff[pick] <= 1e-3 * scale
            err = float(diff[pick][agree].max()) if agree.any() else np.inf
            ok = int(agree.sum()) >= 48
        log(f'[15 kernel G] fixed-direction root find N={N} '
            f'nsv={law.dm.sv.shape[0]} {dtype} vs plain: max|err| {err:.3e} '
            f'(scale {scale:.1f}) {"ok" if ok else "FAIL"}')
        if not ok:
            fail('svc_yf_root in the fixed-direction root find disagrees '
                 'with its plain version')
        errs.append(err)
        if dtype == torch.float32:
            a, kw = seen['call']
            evals = torch.zeros(N, dtype=torch.int32, device=device)
            sk.svc_yf_root(*a, **kw, evals=evals)
            nev = int(evals.sum())
            ms = timed_ms(lambda: sk.svc_yf_root(*a, **kw), 10)
            pms = timed_ms(lambda: sk.svc_yf_root_plain(*a, **kw), 1)
            nsv, F = law.dm.sv.shape
            bnd = bound_ms((a[0].numel() + 3 * N + (F + 1) * nsv) * 4 + N,
                           nev * nsv * (2 * F + 7))
    log(f'[15 kernel G] fixed-direction root find N={N} nsv={nsv} f32: '
        f'kernel {ms:.4f} ms ({nev} evaluations, {nev / N:.1f} per lane), '
        f'plain {pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, '
        f'{bnd[0] / ms:.0%} of it)  [{card}]')
    return max(errs), ms, pms, bnd


# -----------------------------------------------------------------
# the 2048^2 row (phase 16) and the domain decomposition (phase 17)
# -----------------------------------------------------------------
def phase_2048(device, card, N=2048):
    """16: ``bench.py``'s ``step_s_2048`` row (``bench.py:328-359``): one
    cold and one warm 0.25 ``load_step_split`` (n_inner 2) at N x N,
    uniaxial y, the 135-SV SVC of ``REF_SOLVE_svc.npz``, float32.
    ``bench.py`` serves that SVC through ``compress='auto'``, which keeps
    every SV of it (the count is printed): the raw SVC is the same
    configuration.  Kernels A, B and D must launch; then B, A and D
    against their plain versions at the row's shapes.  Returns launches
    and checks."""
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe_kernels as fek, svc
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    from pylabfea_tpu_torch.ops import stencil
    t_phase = time.perf_counter()
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=torch.float32,
                                             device=device)
    red, rel = convert.resolve_compress(svc.SVCParams(
        mat.sv.double().cpu().numpy(), mat.dc.double().cpu().numpy(),
        mat.rho, mat.gamma), 'auto', device)
    md = fek.rect_mesh(N, N, LX=1., LY=1., uniax='y', eps_tot=eps,
                       dtype=torch.float32, device=device)
    reset_counts()
    st = fek.init_state(md, CV, dtype=torch.float32)
    secs, iters = [], []
    d = {}
    for warm in (False, True):
        kw = dict(du0=d['du'], kes0=d['kes'], dst0=d['dstiff']) \
            if warm else {}
        sync(device)
        t0 = time.perf_counter()
        st, d = fek.load_step_split(md, st, mat, CV, 0.25, n_inner=2, **kw)
        sync(device)
        secs.append(time.perf_counter() - t0)
        iters.append(list(d['cg_iters_hist']))
    launches = dict(k_apply=stencil.k_apply.launches,
                    svc_f_grad=sk.svc_f_grad.launches,
                    svc_decision=sk.svc_decision.launches)
    gsig = d['glob_sig'].double().cpu().numpy()
    fin = finite(st.u, st.sig, st.epl, st.elstiff)
    ok = fin and 0.5 * SY < gsig[1] < 2. * SY and min(launches.values()) > 0
    log(f'[16 2048^2] {N}x{N} load_step_split(0.25, n_inner=2), SVC nsv='
        f'{mat.sv.shape[0]} (compress="auto" keeps '
        f'{red.support_vectors.shape[0]} of them, relative RKHS error '
        f'{rel:.3e}), f32: cold step '
        f'{secs[0]:.4f} s, step_s_2048 (warm) {secs[1]:.4f} s; '
        f'cg_iters_hist {iters}; glob_sig '
        f'{np.array2string(gsig, precision=4)}; finite {fin}; launches '
        f'{launches} {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('2048^2 row: non-finite fields, sigma_yy outside (0.5 sy, 2 '
             'sy) or kernel A, B or D not launched')
    trained = dict(np.load(NPZ))
    params = dict(sv=trained['support_vectors'], dc=trained['dual_coef'],
                  gamma=float(trained['gamma']),
                  rho=float(trained['intercept']))
    checks = dict(
        k_apply=[check_kapply(device, N, N, 10, card)],
        svc_f_grad=[check_svc(device, N * N, params, 5, card,
                              n_ref=2 ** 20, plain_rows=2 ** 20)],
        svc_decision=[check_svc_mm(device, N * N, params, 5, card, 'D',
                                   n_ref=2 ** 20, plain_rows=2 ** 20)])
    log(f'[16 2048^2] phase 16 {time.perf_counter() - t_phase:.1f} s  '
        f'[{card}]')
    return dict(launches=launches, checks=checks)


#: 17c's bounds against world size 1, relative to the scale: f64 on
#: glob_sig, the increment (the slab's displacement) and the stresses, max
#: norm; f32 on glob_sig, the increment in the max norm and the stresses
#: in the 2-norm.  The f32 field bounds are set from their readings
#: (PERF.md section 6): the increment 2.46e-4 (the inclusion, 2 ranks of
#: one card) and 7.08e-5 (4 cards), CG's 1e-6 times the inclusion's 200:1
#: contrast between two preconditioners; the stresses 1.1e-3 (the
#: inclusion on 2 and 4 CPU ranks), where two of 65536 elements sit at
#: the yield threshold and return plastically on one side only (7.7e-2 of
#: max|sig| there, printed as 'sig' beside the gated 'sig_l2')
DD_BOUNDS = {'float64': dict(glob_sig=1e-9, du=1e-9, u=1e-9, sig=1e-9),
             'float32': dict(glob_sig=1e-4, du=1e-3, u=1e-3, sig_l2=5e-3)}


def _rel_max(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def phase_strip(device, card, N=1024):
    """17a: ``strip_load_step`` on phase 5's geometry (N x N, uniaxial y,
    one 0.25 step of the SVC's eps, float32, two-level Schwarz, CG to the
    float32 default 1e-6 of the unsharded step) at world size 1, against
    the port's unsharded ``load_step_split`` from the same state: glob_sig
    within 5e-3 (``tests/test_sharded_strip.py``'s rule).  Kernels A and B
    must launch in the strip step."""
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    from pylabfea_tpu_torch.ops import stencil
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    from pylabfea_tpu_torch.parallel import distributed as pd
    from pylabfea_tpu_torch.parallel import sharded as sh
    f32 = torch.float32
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=f32, device=device)
    md = fek.rect_mesh(N, N, uniax='y', eps_tot=eps, dtype=f32,
                       device=device)
    sync(device)
    t0 = time.perf_counter()
    _, d1 = fek.load_step_split(md, fek.init_state(md, CV, dtype=f32), mat,
                                CV, 0.25, n_inner=2)
    sync(device)
    t_one = time.perf_counter() - t0
    sm = sh.StripMesh(N, N, eps_tot=eps, mesh=pd.RankMesh(), dtype=f32,
                      device=device)
    el = sm.shard_elements(torch.as_tensor(CV, dtype=f32, device=device)
                           .expand(N * N, 6, 6))
    z = torch.zeros((N * N, 6), dtype=f32, device=device)
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    sig, epl, du, d2 = sh.strip_load_step(sm, el, z, z, mat, 0.25, n_inner=2,
                                          cg_tol=1e-6, schwarz=2)
    sync(device)
    t_strip = time.perf_counter() - t0
    launches = dict(k_apply=stencil.k_apply.launches,
                    svc_f_grad=sk.svc_f_grad.launches)
    g1 = d1['glob_sig'].double().cpu().numpy()
    g2 = d2['glob_sig'].double().cpu().numpy()
    rel = abs(g2[1] - g1[1]) / abs(g1[1])
    ok = finite(sig, epl, *du) and rel <= 5e-3 \
        and min(launches.values()) > 0
    log(f'[17a strip] {N}x{N} strip_load_step(0.25, n_inner=2, schwarz=2, '
        f'cg_tol=1e-6) at world size 1, f32: {t_strip:.4f} s (the unsharded '
        f'load_step_split from the same state {t_one:.4f} s: the '
        f'decomposition costs {t_strip / t_one:.2f}x); CG iterations of '
        f'every solve {d2["cg_iters_hist"]}, last res {d2["cg_res"]:.2e} '
        f'(unsharded cg_iters_hist {d1["cg_iters_hist"]}); glob_sig[1] '
        f'{g2[1]:.4f} vs '
        f'{g1[1]:.4f} (rel {rel:.2e}, bound 5e-3); launches {launches} '
        f'{"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('strip step at world size 1: non-finite, off the unsharded '
             'step or kernel A or B not launched')
    return dict(launches=launches, seconds=t_strip, unsharded=t_one)


def phase_slab(device, card, N=64):
    """17b: ``solve_uniaxial3_slab`` on ``bench.py``'s N^3 box (J2 + linear
    hardening, uniaxial z to 0.002, float32, two steps, n_inner 1) at world
    size 1 against ``fe3d.solve_uniaxial3``: the last glob_sig within 1e-4
    of its scale (``__graft_entry__.py``'s gate); kernel C must launch."""
    import torch
    from pylabfea_tpu_torch.ops import fe3d, volume
    from pylabfea_tpu_torch.parallel import distributed as pd
    from pylabfea_tpu_torch.parallel import sharded3 as sh3
    f32 = torch.float32
    mat, CV = j2_material(f32, device), elastic_cv()
    md = fe3d.box_mesh(N, N, N, uniax='z', eps_tot=0.002, dtype=f32,
                       device=device)
    sync(device)
    t0 = time.perf_counter()
    _, h1 = fe3d.solve_uniaxial3(md, mat, CV, nsteps=2, n_inner=1)
    sync(device)
    t_one = time.perf_counter() - t0
    sm = sh3.SlabMesh3(N, N, N, uniax='z', eps_tot=0.002, mesh=pd.RankMesh(),
                       dtype=f32, device=device)
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    sig, epl, u, h2 = sh3.solve_uniaxial3_slab(sm, mat, CV, nsteps=2,
                                               n_inner=1)
    sync(device)
    t_slab = time.perf_counter() - t0
    n3 = volume.k_apply3.launches
    g1 = h1[-1][0].double().cpu().numpy()
    g2 = h2[-1][0].double().cpu().numpy()
    dev = float(np.abs(g2 - g1).max()) / max(1., float(np.abs(g1).max()))
    ok = finite(sig, epl, *u) and dev < 1e-4 and n3 > 0
    log(f'[17b slab] {N}^3 solve_uniaxial3_slab(nsteps=2, n_inner=1) at '
        f'world size 1, J2 + hardening, f32: {t_slab:.4f} s '
        f'(fe3d.solve_uniaxial3 {t_one:.4f} s); CG iterations '
        f'{[h[2] for h in h2]} (unsharded {[h[2] for h in h1]}); '
        f'glob_sig[2] {g2[2]:.4f} vs {g1[2]:.4f} (max dev {dev:.2e}, bound '
        f'1e-4); k_apply3 launches {n3} {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('slab solve at world size 1: non-finite, off solve_uniaxial3 '
             'or kernel C not launched')
    return dict(launches=dict(k_apply3=n3), seconds=t_slab, unsharded=t_one)


def dd_cases():
    """17c's cases: the strip at 256^2 (one 0.25 step of the SVC's eps,
    f32 to CG 1e-6 and f64 to 1e-13), the grouped three-material
    inclusion strip at 256^2 (f32) and the slab at 32^3 (J2 + hardening,
    two steps, f32)."""
    strip = dict(kind='strip_step', NX=256, NY=256, eps=0.002, mats='svc',
                 load_frac=0.25, n_inner=2)
    return [dict(strip, dtype='float32', cg_tol=1e-6),
            dict(strip, dtype='float64', cg_tol=1e-13),
            dict(kind='strip_step', NX=256, NY=256, LX=4., LY=4.,
                 mats='inclusion', load_frac=0.25, n_inner=2,
                 dtype='float32', cg_tol=1e-6),
            dict(kind='slab', NX=32, NY=32, NZ=32, eps=0.002, mats='j2',
                 dtype='float32', nsteps=2, n_inner=1)]


def phase_dd_ranks(device, card):
    """17c: the strip and slab cases of ``dd_cases`` on W ranks against
    world size 1, W = min(4, cards) where there are two cards or more,
    else 2, placed by ``launch.spawn``'s default: one card a rank under
    NCCL, or both ranks on the one card under Gloo (NCCL refuses two
    ranks on one GPU).  Each case within ``DD_BOUNDS`` of world size 1
    (f64 1e-9; f32 glob_sig 1e-4, ``__graft_entry__.py``'s gate, and the
    fields at bounds set from their readings), the duplicated columns and
    planes bitwise equal on both ranks, glob_sig alike on every rank.
    Every rank's error fails the phase.  Returns the ranks' kernel
    launches."""
    import torch
    from pylabfea_tpu_torch.parallel import distributed as pd
    from pylabfea_tpu_torch.parallel import launch, runs
    cases = dd_cases()
    ncard = torch.cuda.device_count()
    W = min(4, ncard) if ncard >= 2 else 2
    devs, backend = launch.placement(W)
    t0 = time.perf_counter()
    one = runs.suite(pd.RankMesh(), device, cases)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = launch.spawn(runs.suite, W, args=(cases,), timeout=600.)
    t_ranks = time.perf_counter() - t0
    launches = {}
    for i, c in enumerate(cases):
        res = [r[i] for r in ranks]
        bounds = DD_BOUNDS[c['dtype']]
        key = 'u' if c['kind'] == 'slab' else 'du'
        # the increment / displacement blocks with the duplicated layer of
        # every rank but the last dropped, in strip order
        glob = np.concatenate([x[key][:, :-1] for x in res[:-1]]
                              + [res[-1][key]], 1)
        errs = {'glob_sig': _rel_max(res[0]['glob_sig'], one[i]['glob_sig']),
                key: _rel_max(glob, one[i][key])}
        sig = np.concatenate([x['sig'] for x in res])
        errs['sig'] = _rel_max(sig, one[i]['sig'])
        if c['dtype'] == 'float32':
            errs['sig_l2'] = float(np.linalg.norm(sig - one[i]['sig'])
                                   / np.linalg.norm(one[i]['sig']))
        dup = all(np.array_equal(res[r][key][:, -1], res[r + 1][key][:, 0])
                  for r in range(W - 1))
        same = all(np.array_equal(x['glob_sig'], res[0]['glob_sig'])
                   for x in res)
        need = ('k_apply3',) if c['kind'] == 'slab' else (
            ('k_apply', 'svc_f_grad') if c['mats'] == 'svc'
            else ('k_apply',))
        for x in res:
            for k, n in x['launches'].items():
                launches[k] = launches.get(k, 0) + n
        ran = all(x['launches'][k] > 0 for x in res for k in need)
        gated = {k: v for k, v in errs.items() if k in bounds}
        ok = all(v <= bounds[k] for k, v in gated.items()) and dup \
            and same and ran
        iters = ('cg_iters', 'cg_iters_hist')[c['kind'] == 'strip_step']
        tag = f'{c["kind"]} {c["NX"]}^{3 if c["kind"] == "slab" else 2} ' \
            f'{c["mats"]} {c["dtype"]}'
        log(f'[17c ranks] {tag} on {W} ranks ({backend}): '
            f'{max(x["seconds"] for x in res):.3f} s (world size 1 '
            f'{one[i]["seconds"]:.3f} s); CG iterations of every '
            f'{"solve" if iters == "cg_iters_hist" else "step"} '
            f'{res[0][iters]} (world size 1 {one[i][iters]}); '
            f'errors vs world size 1 '
            f'{ {k: f"{v:.2e}" for k, v in errs.items()} } (bounds '
            f'{ {k: bounds[k] for k in gated} }); duplicated layers bitwise '
            f'{dup}; '
            f'glob_sig alike on every '
            f'rank {same}; launches of rank 0 {res[0]["launches"]} '
            f'{"ok" if ok else "FAIL"}  [{card}]')
        if not ok:
            fail(f'17c {tag}: the ranks disagree with world size 1, their '
                 'duplicated layers differ or a kernel was not launched')
    log(f'[17c ranks] W={W} {backend} on {devs}: the ranks {t_ranks:.1f} s '
        f'(spawn included), world size 1 {t_one:.1f} s  [{card}]')
    return dict(W=W, backend=backend, devs=devs, launches=launches)


def phase_dd(device, card):
    """Phase 17: the domain decomposition (17a strip, 17b slab, 17c
    ranks), then kernel C at the slabs' block shapes against its plain
    version."""
    import torch
    t0 = time.perf_counter()
    a = phase_strip(device, card)
    b = phase_slab(device, card)
    c = phase_dd_ranks(device, card)
    ec = [check_kapply3(device, (64, 64, 64), torch.float32, 3e-6, 20,
                        card),
          check_kapply3(device, (32 // c['W'], 32, 32), torch.float32, 3e-6,
                        0, card)]
    log(f'[17 domain decomposition] phase 17 {time.perf_counter() - t0:.1f}'
        f' s  [{card}]')
    return dict(strip=a, slab=b, ranks=c, check_slab=ec)


# -----------------------------------------------------------------
# element-axis sharding and the path-sharded fit (phase 18)
# -----------------------------------------------------------------
#: the scale demo's solver settings of the element-sharded 2-D step
#: (``examples/tpu_scale_demo.py``): n_inner 2, Jacobi-CG to 500 iterations
ELEM_STEP = dict(n_inner=2, cg_maxiter=500)


def elem_steps(md, state, mat, CV, fracs, step_kw):
    """``load_step_split`` at each load fraction, each later step
    warm-started from the last increment: (state, diags, seconds of each
    step)."""
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    diags, secs, du0 = [], [], None
    for frac in fracs:
        sync(md.device)
        t0 = time.perf_counter()
        state, d = fek.load_step_split(md, state, mat, CV, frac, du0=du0,
                                       **step_kw)
        sync(md.device)
        secs.append(time.perf_counter() - t0)
        du0 = d['du']
        diags.append(d)
    return state, diags, secs


def phase_elem2d(device, card, main_run, N=1024):
    """18a: the element-sharded 2-D step (``parallel.mesh``) on phase 5's
    N x N geometry with its SVC, float32, the scale demo's settings, a
    cold and a warm 0.25 step at world size 1 (no process group), against
    the unsharded flat ``load_step_split`` on the same mesh: equal CG
    histories, glob_sig within 1e-6 of its scale.  The flat scatter-add
    (``index_add``) sums in the order of the card's atomics, which differs
    from run to run, and float32 Jacobi-CG that runs to its 500
    iterations carries that rounding to about 5e-5 of glob_sig; so both
    are compared under ``torch.use_deterministic_algorithms``.  The timed
    steps run without it, and kernel A must launch in them; their seconds
    stand beside phase 5's multigrid step."""
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    from pylabfea_tpu_torch.ops.femu import flatten_mesh
    from pylabfea_tpu_torch.parallel import mesh as em
    f32 = torch.float32
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=f32, device=device)
    md = fek.rect_mesh(N, N, uniax='y', eps_tot=eps, dtype=f32,
                       device=device)
    flat = flatten_mesh(md)
    ranks = em.make_mesh(device=device)
    md_s = em.shard_mesh_data(md, ranks, device)

    def sharded():
        return elem_steps(md_s, em.shard_state(
            fek.init_state(flat, CV, dtype=f32), ranks), mat, CV,
            (0.25, 0.25), ELEM_STEP)

    reset_counts()
    st, d2, t2 = sharded()
    n_a = sk.svc_f_grad.launches
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _, e1, t1 = elem_steps(flat, fek.init_state(flat, CV, dtype=f32),
                               mat, CV, (0.25, 0.25), ELEM_STEP)
        _, e2, _ = sharded()
    finally:
        torch.use_deterministic_algorithms(was)

    def hist(ds):
        return [d['cg_iters_hist'] for d in ds]

    def gsig(ds):
        return torch.stack([d['glob_sig'] for d in ds]).cpu()

    rel = _rel_max(gsig(e2), gsig(e1))
    rel_timed = _rel_max(gsig(d2), gsig(e1))
    ok = finite(st.sig, st.epl, st.u) and hist(e1) == hist(e2) \
        and rel <= 1e-6 and n_a > 0
    log(f'[18a elem2d] {N}x{N} element-sharded load_step_split (flat '
        f'Jacobi-CG, n_inner 2, cg_maxiter 500) at world size '
        f'{ranks.size}, f32: cold {t2[0]:.4f} s, warm {t2[1]:.4f} s '
        f'(phase 5\'s multigrid step {main_run["step_s"]:.4f} s); CG '
        f'iterations of every solve {hist(d2)}; under deterministic '
        f'algorithms {hist(e2)}, the unsharded flat step {hist(e1)} '
        f'({t1[0]:.4f} s, {t1[1]:.4f} s), glob_sig rel {rel:.2e} (bound '
        f'1e-6; the timed steps {rel_timed:.2e}); svc_f_grad launches in '
        f'the timed steps {n_a} {"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('18a: the element-sharded 2-D step is non-finite, off the '
             'unsharded flat step or kernel A was not launched')
    return dict(launches=dict(svc_f_grad=n_a), seconds=t2)


def phase_elem3d(device, card, N=64):
    """18b: the element-sharded 3-D step (``parallel.mesh3d``) on
    ``bench.py``'s N^3 row (J2 + linear hardening, an untimed 0.4 step,
    then a warm 0.3 step) at world size 1, against ``load_step3``: equal
    CG histories, glob_sig within 1e-6.  Kernel C must launch."""
    import torch
    from pylabfea_tpu_torch.ops import fe3d, volume
    from pylabfea_tpu_torch.parallel import mesh3d as em3
    f32 = torch.float32
    mat, CV = j2_material(f32, device), elastic_cv()
    md = fe3d.box_mesh(N, N, N, uniax='z', eps_tot=0.002, dtype=f32,
                       device=device)
    ranks = em3.make_mesh3(device=device)
    md_s = em3.shard_mesh_data3(md, ranks, device)
    out = {}
    for name, mesh, st in (
            ('unsharded', md, fe3d.init_state3(md, CV, dtype=f32)),
            ('sharded', md_s, em3.shard_state3(fe3d.init_state3(
                md, CV, dtype=f32), ranks))):
        st, d = fe3d.load_step3(mesh, st, mat, CV, 0.4, n_inner=2,
                                du0=torch.zeros_like(st.u))
        reset_counts()
        sync(device)
        t0 = time.perf_counter()
        st, d = fe3d.load_step3(mesh, st, mat, CV, 0.3, n_inner=2,
                                du0=d['du'])
        sync(device)
        out[name] = dict(seconds=time.perf_counter() - t0, state=st, diag=d,
                         launches=volume.k_apply3.launches)
    a, b = out['unsharded'], out['sharded']
    h1, h2 = a['diag']['cg_iters_hist'], b['diag']['cg_iters_hist']
    rel = _rel_max(b['diag']['glob_sig'].cpu(), a['diag']['glob_sig'].cpu())
    # the element fields as volumes: their Voigt means are glob_sig
    vols = fe3d.field_volumes(md_s, b['state'])
    vmean = torch.stack([vols[f'sig_{k}'].mean() for k in range(6)]).cpu()
    vrel = _rel_max(vmean, b['diag']['glob_sig'].cpu())
    ok = finite(b['state'].sig, b['state'].u, *vols.values()) and h1 == h2 \
        and rel <= 1e-6 and b['launches'] > 0 and vrel <= 1e-5 \
        and all(v.shape == (N, N, N) for v in vols.values())
    log(f'[18b elem3d] {N}^3 element-sharded load_step3 (warm 0.3 step, J2 '
        f'+ hardening, f32) at world size {ranks.size}: {b["seconds"]:.4f} '
        f's (load_step3 {a["seconds"]:.4f} s); CG iterations {h2} '
        f'(unsharded {h1}); glob_sig rel {rel:.2e} (bound 1e-6); '
        f'field_volumes: {len(vols)} volumes of {tuple(vols["seq"].shape)}, '
        f'their stress means off glob_sig by {vrel:.2e} (bound 1e-5); '
        f'k_apply3 launches {b["launches"]} {"ok" if ok else "FAIL"}  '
        f'[{card}]')
    if not ok:
        fail('18b: the element-sharded 3-D step is non-finite, off '
             'load_step3, its field volumes are off or kernel C was not '
             'launched')
    return dict(launches=dict(k_apply3=b['launches']),
                seconds=b['seconds'], unsharded=a['seconds'])


#: 18c's bounds against world size 1: float64 on glob_sig, the
#: displacement and the fit's parameters (khard 1e-8, as the JAX
#: package's sharded-fit test has it), float32 on glob_sig
ELEM_BOUNDS = {'float64': dict(glob_sig=1e-9, du=1e-9, u=1e-9, sy=1e-9,
                               hill=1e-9, khard=1e-8),
               'float32': dict(glob_sig=1e-4)}


def elem_cases(device):
    """18c's cases: the 2-D sharded step at 256^2 (the SVC, f32, a cold
    and a warm 0.25 step) and at 64^2 (f64, CG to 1e-13), the 3-D sharded
    step at 32^3 (J2 + hardening, 0.4 then 0.3, f32 and f64), the
    path-sharded fit on 256 of phase 14c's paths x 30 steps (f64, 10 LM
    steps; the data simulated on the card)."""
    import torch
    from pylabfea_tpu_torch.ops import calibrate as cal
    f64 = torch.float64
    deps = cal_paths(256, 30)
    with torch.no_grad():
        sig = cal.simulate_paths(cal_theta(f64, device),
                                 torch.as_tensor(elastic_cv(), dtype=f64,
                                                 device=device),
                                 torch.as_tensor(deps, dtype=f64,
                                                 device=device), 40)
    e2 = dict(kind='elem2d', eps=0.002, mats='svc', fracs=[0.25, 0.25],
              n_inner=2)
    e3 = dict(kind='elem3d', NX=32, NY=32, NZ=32, eps=0.002, mats='j2',
              fracs=[0.4, 0.3], n_inner=2)
    return [dict(e2, NX=256, NY=256, dtype='float32', cg_maxiter=500),
            dict(e2, NX=64, NY=64, dtype='float64', cg_tol=1e-13,
                 cg_maxiter=2000),
            dict(e3, dtype='float32'), dict(e3, dtype='float64'),
            dict(kind='fit', deps=deps, sig=sig.cpu().numpy(),
                 CV=elastic_cv(), steps=10, dtype='float64')]


def phase_elem_ranks(device, card):
    """18c: the cases of ``elem_cases`` on W ranks against world size 1,
    placed as 17c's (NCCL with one card a rank where at least two cards
    are visible, else 2 Gloo ranks on card 0): within ``ELEM_BOUNDS``, the
    same values on every rank, and every rank launching kernel A (2-D) or
    C (3-D).  Returns the ranks' kernel launches."""
    import torch
    from pylabfea_tpu_torch.parallel import distributed as pd
    from pylabfea_tpu_torch.parallel import launch, runs
    cases = elem_cases(device)
    ncard = torch.cuda.device_count()
    W = min(4, ncard) if ncard >= 2 else 2
    devs, backend = launch.placement(W)
    t0 = time.perf_counter()
    one = runs.suite(pd.RankMesh(), device, cases)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = launch.spawn(runs.suite, W, args=(cases,), timeout=600.)
    t_ranks = time.perf_counter() - t0
    launches = {}
    for i, c in enumerate(cases):
        res = [r[i] for r in ranks]
        keys = {'elem2d': ('glob_sig', 'du'), 'elem3d': ('glob_sig', 'u'),
                'fit': ('sy', 'hill', 'khard')}[c['kind']]
        errs = {k: _rel_max(res[0][k], one[i][k]) for k in keys}
        bounds = ELEM_BOUNDS[c['dtype']]
        gated = {k: v for k, v in errs.items() if k in bounds}
        same = all(np.array_equal(x[k], res[0][k]) for x in res
                   for k in keys)
        need = {'elem2d': ('svc_f_grad',), 'elem3d': ('k_apply3',),
                'fit': ()}[c['kind']]
        if c['kind'] != 'fit':
            for x in res:
                for k, n in x['launches'].items():
                    launches[k] = launches.get(k, 0) + n
        ran = all(x['launches'][k] > 0 for x in res for k in need)
        ok = all(v <= bounds[k] for k, v in gated.items()) and same and ran
        if c['kind'] == 'fit':
            tag = f'fit {len(c["deps"])} paths x {c["deps"].shape[1]} ' \
                f'steps {c["steps"]} LM steps'
            detail = f'sy {res[0]["sy"]:.6f}, loss {res[0]["loss"][-1]:.3e}'
        else:
            dim = 2 if c['kind'] == 'elem2d' else 3
            tag = f'{c["kind"]} {c["NX"]}^{dim} {c["mats"]}'
            detail = f'CG iterations {res[0]["cg_iters_hist"]} (world size ' \
                f'1 {one[i]["cg_iters_hist"]}); launches of rank 0 ' \
                f'{res[0]["launches"]}'
        log(f'[18c ranks] {tag} {c["dtype"]} on {W} ranks ({backend}): '
            f'{max(x["seconds"] for x in res):.3f} s (world size 1 '
            f'{one[i]["seconds"]:.3f} s); errors vs world size 1 '
            f'{ {k: f"{v:.2e}" for k, v in errs.items()} } (bounds '
            f'{ {k: bounds[k] for k in gated} }); alike on every rank '
            f'{same}; {detail} {"ok" if ok else "FAIL"}  [{card}]')
        if not ok:
            fail(f'18c {tag}: the ranks disagree with world size 1 or with '
                 'each other, or a kernel was not launched')
    log(f'[18c ranks] W={W} {backend} on {devs}: the ranks {t_ranks:.1f} s '
        f'(spawn included), world size 1 {t_one:.1f} s  [{card}]')
    return dict(W=W, backend=backend, devs=devs, launches=launches)


def phase_elem(device, card, main_run):
    """Phase 18: element-axis sharding (18a 2-D, 18b 3-D with
    ``fe3d.field_volumes`` of its state, both at world size 1; 18c W ranks
    with the path-sharded fit)."""
    t0 = time.perf_counter()
    a = phase_elem2d(device, card, main_run)
    b = phase_elem3d(device, card)
    c = phase_elem_ranks(device, card)
    log(f'[18 element sharding] phase 18 {time.perf_counter() - t0:.1f} s '
        f'(budget 60 s)  [{card}]')
    return dict(elem2d=a, elem3d=b, ranks=c)


# -----------------------------------------------------------------
# the host profile (phase 19)
# -----------------------------------------------------------------
#: 19c's grid: the example's three 2 x 2 sections at 256 columns a section
NX_19C, NY_19C = 768, 256
#: 19c's load steps: 2 of ``solve_on_device``'s default 20, the cut that
#: brings the run toward its 900 s line (20 steps took 46.0 s, 2.30 s a
#: step, on an NVIDIA H100 80GB HBM3 at 700 W; phase 19 180.9 s)
NSTEPS_19C = 2


def host_model(FE, mats, NX, NY):
    """``examples/train_hill.py``'s model (``:29-37``): three 2 x 2
    sections with ``mats``, left and bottom supports, the right edge
    force-free, the top displaced by 0.002 LY, meshed NX x NY."""
    fem = FE.Model(dim=2, planestress=False)
    fem.geom([2., 2., 2.], LY=2.)
    fem.assign(mats)
    fem.bcleft(0.)
    fem.bcbot(0.)
    fem.bcright(0., 'force')
    fem.bctop(0.002 * fem.leny, 'disp')
    fem.mesh(NX=NX, NY=NY)
    return fem


def phase_host_train(FE, card):
    """19a: ``examples/train_hill.py``'s training (``:15-24``) through the
    port's ``Material``: the Hill reference (E 200e3, nu 0.3, sy 50, rv
    [1.2, 1, 0.8, 1, 1, 1]) and ``train_SVC(C=4, gamma=1.5, Nlc=300,
    Nseq=25, Fe=0.3, Ce=0.95, backend='jax')``: the training data on the
    host, the fit on the card (f32, ``ml_train.fit_svc``). The score must
    reach 95 %."""
    from pylabfea_tpu_torch import ml_train
    mat_h = FE.Material(name='Hill-reference')
    mat_h.elasticity(E=200.e3, nu=0.3)
    mat_h.plasticity(sy=50., rv=[1.2, 1., 0.8, 1., 1., 1.], sdim=6)
    mat_ml = FE.Material(name='Hill-ML')
    fits = []
    orig = ml_train.fit_svc

    def timed_fit(X, *a, **kw):
        t0 = time.perf_counter()
        out = orig(X, *a, **kw)
        fits.append((np.shape(X)[0], time.perf_counter() - t0))
        return out

    ml_train.fit_svc = timed_fit
    try:
        t0 = time.perf_counter()
        score, _ = mat_ml.train_SVC(C=4, gamma=1.5, mat_ref=mat_h, Nlc=300,
                                    Nseq=25, Fe=0.3, Ce=0.95, backend='jax')
        dt = time.perf_counter() - t0
    finally:
        ml_train.fit_svc = orig
    mat_ml.dev_only = False
    nsv = mat_ml._svc.support_vectors.shape[0]
    ok = score >= 95. and len(fits) == 1 and 0 < nsv
    log(f'[19a train_SVC] backend=jax on the card: {fits[0][0]} training '
        f'points, {nsv} SVs, score {score:.2f} % (gate 95 %), {dt:.3f} s '
        f'(the fit {fits[0][1]:.3f} s, the rest the host\'s training data) '
        f'{"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('train_SVC(backend=jax): score below 95 % or no card fit')
    mat_el = FE.Material(name='elastic inclusion')
    mat_el.elasticity(E=3. * 200.e3, nu=0.3)
    return mat_h, mat_ml, mat_el, dt


def host_states(N, sy, seed):
    """N stresses at 0.3-2 sy along random directions and small plastic
    strains."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return (u * sy * rng.uniform(0.3, 2.0, (N, 1)),
            rng.normal(0., 1e-3, (N, 6)))


def phase_host_vs_card(FE, device, mats, card):
    """19b: (i) the example's model with the Hill reference in place of
    the ML section solved by the port's host ``Model.solve()`` (f64)
    against ``bridge.solve_on_device_adaptive(fast=False, float64)`` on a
    copy, within ``tests/test_bridge.py:283-288``'s bounds (B must
    launch); (ii) the ML law's host rows (numpy) against ``HostLaw`` on
    the card in f64 with 19a's SVC: ``calc_seq``, ``_yf_rows`` (kernel D),
    ``_sflow_rows`` on 1024 states within 1e-12 relative, and
    ``_ml_full_yf_rows`` on 256 of them along two load directions
    (kernel G, 2000 marching steps) within 1e-4 MPa."""
    import torch
    from pylabfea_tpu_torch import bridge, convert
    mat_h, mat_ml, mat_el = mats
    f64 = torch.float64
    t0 = time.perf_counter()
    host = host_model(FE, [mat_h, mat_el, mat_h], 12, 4)
    host.solve()
    host.calc_global()
    t1 = time.perf_counter()
    dev = host_model(FE, [mat_h, mat_el, mat_h], 12, 4)
    sync(device)
    reset_counts()
    bridge.solve_on_device_adaptive(dev, dtype=f64, fast=False)
    sync(device)
    t2 = time.perf_counter()
    la = launches_now()
    epl = lambda m: np.array([e.epl for e in m.element])  # noqa: E731
    du = float(np.abs(dev.u - host.u).max())
    dg = np.abs(dev.glob['sig'] - host.glob['sig']) \
        - 1e-6 * np.abs(host.glob['sig'])
    ds = np.abs(dev.sgl - host.sgl) - 1e-5 * np.abs(host.sgl)
    de = float(np.abs(epl(dev) - epl(host)).max())
    ok = (dev.sgl.shape == host.sgl.shape and du <= 1e-7
          and dg.max() <= 1e-4 and ds.max() <= 1e-3 and de <= 1e-7
          and la['k_apply'] > 0 and host.glob['epl'][1] > 0.)
    log(f'[19b host vs card] 12x4 laminate [Hill, elastic, Hill]: host '
        f'Model.solve {t1 - t0:.3f} s ({len(host.sgl)} increments), card '
        f'solve_on_device_adaptive(fast=False, f64) {t2 - t1:.3f} s; '
        f'max|du| {du:.3e} (1e-7), glob sig excess over rtol 1e-6 '
        f'{dg.max():.3e} (atol 1e-4), sgl excess over rtol 1e-5 '
        f'{ds.max():.3e} (atol 1e-3), max|depl| {de:.3e} (1e-7); '
        f'sigma_yy {host.glob["sig"][1]:.4f}, peeq_yy '
        f'{host.glob["epl"][1]:.3e}; launches {la} '
        f'{"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('host Model.solve and the card adaptive solve disagree, or B '
             'was not launched')
    mrec = convert.material_record(mat_ml)
    law = bridge.HostLaw.of(mrec, convert.material_from_record(
        mrec, dtype=f64, device=device))
    sig, epl_np = host_states(1024, mat_ml.sy, 19)
    t = lambda a: torch.as_tensor(a, dtype=f64, device=device)  # noqa
    reset_counts()
    t0 = time.perf_counter()
    rows = dict(seq=(law.seq(t(sig)), mat_ml.calc_seq(sig)),
                yf=(law.yf(t(sig), t(epl_np)), mat_ml._yf_rows(sig, epl_np)),
                sflow=(law.sflow(t(epl_np)), mat_ml._sflow_rows(epl_np)))
    rel = {k: _rel(a.cpu().numpy(), b) for k, (a, b) in rows.items()}
    lds = (np.eye(6)[5], np.eye(6)[0])
    dist = []
    for ld in lds:
        d = law.ml_full_yf(t(sig[:256]), t(epl_np[:256]), ld).cpu().numpy()
        dh = mat_ml._ml_full_yf_rows(sig[:256], epl_np[:256], ld=ld)
        dist.append(float(np.abs(d - dh).max()))
    sync(device)
    lb = launches_now()
    ok = (max(rel.values()) <= 1e-12 and max(dist) <= 1e-4
          and lb['svc_decision'] > 0 and lb['svc_yf_root'] > 0)
    log(f'[19b host vs card] the ML law ({mat_ml._svc.dual_coef.size} SVs),'
        f' host numpy rows against HostLaw on the card, f64: relative '
        + ', '.join(f'{k} {v:.3e}' for k, v in rel.items())
        + f' (bound 1e-12) on 1024 states; ml_full_yf along e6 and e1 on '
        f'256: max|diff| {dist[0]:.3e}, {dist[1]:.3e} MPa (bound 1e-4); '
        f'{time.perf_counter() - t0:.3f} s; launches {lb} '
        f'{"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('the host ML rows and HostLaw on the card disagree, or D / G '
             'were not launched')
    counts = {k: la[k] + lb[k] for k in la}
    return host, dict(launches=counts, mrec=mrec, ld=lds[0])


def phase_host_read(FE, device, mats, card):
    """19c: the example's model with the ML section (``dev_only`` False)
    meshed ``NX_19C`` x ``NY_19C`` on the host; ``bridge.read_model``
    (without compression) against the record ``grid_record`` builds from
    the same material records, ids and BCs, array for array; then
    ``solve_on_device(nsteps=NSTEPS_19C, n_inner=2, float32,
    compress='auto')`` timed (the compression through the ``Material``'s
    cache): A, B and D must launch, the fields finite."""
    import torch
    from pylabfea_tpu_torch import bridge, convert
    mat_h, mat_ml, mat_el = mats
    t0 = time.perf_counter()
    fem = host_model(FE, [mat_h, mat_el, mat_ml], NX_19C, NY_19C)
    t1 = time.perf_counter()
    rec = bridge.read_model(fem)
    t2 = time.perf_counter()
    ids = np.repeat(np.arange(3), NX_19C // 3 * NY_19C)
    ref = bridge.grid_record(
        NX_19C, NY_19C, [convert.material_record(m) for m in
                         (mat_h, mat_el, mat_ml)],
        [m.CV for m in (mat_h, mat_el, mat_ml)], LX=6., LY=2., ids=ids,
        bct=(0., 0.004), ubctop=(False, True))

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(map(same, a, b))
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype \
            and bool(np.array_equal(a, b, equal_nan=a.dtype.kind == 'f'))

    diff = sorted(k for k in set(rec) | set(ref)
                  if k not in rec or k not in ref or not same(rec[k], ref[k]))
    log(f'[19c read_model] {NX_19C}x{NY_19C} ({fem.Nel} elements): '
        f'Model.mesh {t1 - t0:.3f} s, read_model {t2 - t1:.3f} s; record '
        f'against grid_record: {len(rec)} keys, differing {diff} '
        f'{"ok" if not diff else "FAIL"}  [{card}]')
    if diff:
        fail(f'read_model of the host Model differs from grid_record: {diff}')
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    bridge.solve_on_device(fem, nsteps=NSTEPS_19C, n_inner=2,
                           dtype=torch.float32, compress='auto')
    sync(device)
    dt = time.perf_counter() - t0
    la = launches_now()
    fin = bool(np.isfinite(fem.u).all() and np.isfinite(fem.sgl).all()
               and all(np.isfinite(e.sig).all() for e in fem.element))
    k = mat_ml._svc_reduced[1].support_vectors.shape[0]
    ok = fin and all(la[n] > 0 for n in ('svc_f_grad', 'k_apply',
                                         'svc_decision'))
    log(f'[19c solve_on_device] {NX_19C}x{NY_19C} [Hill, elastic, ML], '
        f"compress='auto' ({mat_ml._svc.dual_coef.size} -> {k} centers, "
        f'relative RKHS error {mat_ml.svc_compress_rel:.3e}), f32, '
        f'{NSTEPS_19C} steps x (n_inner 2): {dt:.3f} s ({dt / NSTEPS_19C:.4f}'
        f' s a step); sigma_yy {fem.glob["sig"][1]:.4f} (no gate: n_inner 2 '
        f'is not converged by design); finite {fin}; launches {la} '
        f'{"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('solve_on_device of the host Model: non-finite fields or '
             'kernels A/B/D not launched')
    return dict(launches=la, seconds=dt, k=k,
                red=mat_ml._svc_reduced[1])


#: 19d's grid: ``calc_properties_on_device``'s default 16^2.  A specimen is
#: one homogeneous material, so the grid barely moves a strength (15d runs
#: 256^2); at 64^2 19d took 42.3-44.6 s, host-bound in MG-CG (1788 launches
#: of B a step), on an NVIDIA H100 80GB HBM3 at 700 W
NEL_19D = 16


def phase_host_props(FE, device, mats, card, Nel=NEL_19D):
    """19d: ``bridge.calc_properties_on_device(mat_ml, Nel, eps=0.001,
    nsteps=10)`` (15d's protocol, the SVC uncompressed) into the port's
    ``Material``: every strength within 5 % of the Hill reference's locus
    (propJ2 along the elastic stress direction of the load case, prop
    along the last stress, 15d's rule); A, B and G must launch."""
    from pylabfea_tpu_torch import bridge, convert
    mat_h, mat_ml, _ = mats
    CVps = convert.elastic_cv(200.e3, 0.3, planestress=True)

    def hill_at(d):
        d = np.asarray(d, float)
        return mat_h.sy * FE.sig_eq_j2(d) / mat_h.calc_seq(d)

    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    bridge.calc_properties_on_device(mat_ml, Nel=Nel, eps=0.001, nsteps=10)
    sync(device)
    dt = time.perf_counter() - t0
    la = launches_now()
    rows, ok = [], True
    for sel in bridge.LOAD_CASES:
        on = hill_at(onset_direction(sel, CVps))
        fin = hill_at(mat_ml.sigeps[sel]['sig'][-1])
        e1 = abs(mat_ml.propJ2[sel]['ys'] - on) / on
        e2 = abs(mat_ml.prop[sel]['ys'] - fin) / fin
        ok &= e1 <= 0.05 and e2 <= 0.05
        rows.append(f'{sel} propJ2 ys {mat_ml.propJ2[sel]["ys"]:.4f} (Hill '
                    f'{on:.4f}, {e1:.2%}), prop ys '
                    f'{mat_ml.prop[sel]["ys"]:.4f} (Hill {fin:.4f}, '
                    f'{e2:.2%})')
    ok &= all(la[k] > 0 for k in ('svc_f_grad', 'k_apply', 'svc_yf_root'))
    log(f'[19d calc_properties] Material of 19a ({mat_ml._svc.dual_coef.size}'
        f' SVs, uncompressed) {Nel}x{Nel} f32, eps 0.001, 4 cases x 11 '
        f'steps: {dt:.3f} s; ' + '; '.join(rows) + f'; launches {la} '
        f'{"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('calc_properties_on_device of the host Material: strengths off '
             'the Hill locus or kernels A/B/G not launched')
    return dict(launches=la, seconds=dt)


def phase_host_round_trips(FE, device, mats, host, card):
    """19e: ``export_MLparam`` / ``from_MLparam`` of 19a's SVC (decision
    values bitwise equal on the host); ``save_model`` / ``load_model`` of
    19b's host model (every field bitwise equal); last, since it replaces
    the SVC, ``Material.compress_svc(tol=1e-3)`` on the card: the
    relative RKHS error it returns at most ``tol`` and max |f - f~| on
    15a's 2^16 probes at most rel |w|_H (1 + 1e-6)."""
    import tempfile
    import torch
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    from pylabfea_tpu_torch.utils import checkpoint
    mat_h, mat_ml, mat_el = mats
    sig, epl_np = host_states(512, mat_ml.sy, 23)
    with tempfile.TemporaryDirectory() as tmp:
        mat_ml.export_MLparam('chip_smoke', file='hill_ml', path=tmp)
        mat_in = FE.Material(name='imported')
        mat_in.from_MLparam('hill_ml', path=tmp)
        ok_ml = bool(np.array_equal(mat_in.calc_yf(sig, epl_np),
                                    mat_ml.calc_yf(sig, epl_np)))
        checkpoint.save_model(os.path.join(tmp, 'host.npz'), host,
                              meta={'phase': '19e'})
        back = host_model(FE, [mat_h, mat_el, mat_h], 12, 4)
        meta = checkpoint.load_model(os.path.join(tmp, 'host.npz'), back)
    fields = ('u', 'f', 'sgl', 'egl', 'epgl', 'bct_mem', 'bcr_mem')
    ok_mod = meta == {'phase': '19e'} and all(
        np.array_equal(getattr(back, k), getattr(host, k)) for k in fields) \
        and all(np.array_equal(getattr(a, k), getattr(b, k))
                for a, b in zip(back.element, host.element)
                for k in ('sig', 'eps', 'epl', 'elstiff'))
    full = mat_ml._svc
    t0 = time.perf_counter()
    rel = mat_ml.compress_svc(tol=1e-3)
    sync(device)
    dt = time.perf_counter() - t0
    red = mat_ml._svc
    f64 = dict(dtype=torch.float64, device=device)
    sv, dc = (torch.as_tensor(a, **f64) for a in (full.support_vectors,
                                                  full.dual_coef))
    svr, dcr = (torch.as_tensor(a, **f64) for a in (red.support_vectors,
                                                    red.dual_coef))
    g = float(full.gamma)
    wnorm = float(torch.sqrt(dc @ (torch.exp(-g * sk.rbf_d2(sv, sv)) @ dc)))
    rng = np.random.default_rng(11)
    u = rng.normal(size=(2 ** 16, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    x = torch.as_tensor(u * rng.uniform(0.3, 2.0, (2 ** 16, 1)), **f64)
    err = 0.
    for i in range(0, x.shape[0], 2 ** 13):
        f = sk.svc_f_grad_plain(x[i:i + 2 ** 13], sv, dc, g,
                                float(full.intercept), with_grad=False)[0]
        fr = sk.svc_f_grad_plain(x[i:i + 2 ** 13], svr, dcr, g,
                                 float(red.intercept), with_grad=False)[0]
        err = max(err, float((f - fr).abs().max()))
    ok_c = rel <= 1e-3 and err <= rel * wnorm * (1. + 1e-6) \
        and mat_ml.svm_yf is None
    ok = ok_ml and ok_mod and ok_c
    log(f'[19e round trips] export_MLparam / from_MLparam: decision values '
        f'on 512 states bitwise equal {ok_ml}; save_model / load_model of '
        f'19b\'s model: every field bitwise equal {ok_mod}; '
        f'compress_svc(tol=1e-3) on the card: {full.dual_coef.size} -> '
        f'{red.dual_coef.size} centers, relative RKHS error {rel:.3e} '
        f'(bound 1e-3), {dt:.3f} s; max|f - f~| on 2^16 probes {err:.3e} '
        f'(bound rel |w|_H = {rel * wnorm:.3e}) '
        f'{"ok" if ok else "FAIL"}  [{card}]')
    if not ok:
        fail('a host-profile round trip is not exact, or compress_svc '
             'breaks its RKHS bound')


def phase_host(device, card):
    """Phase 19: the port's host profile (``import pylabfea_tpu_torch as
    FE``) driving ``examples/train_hill.py``'s workflow (19a-19e), then
    the check that no JAX, scikit-learn or JAX-package module was
    imported.  Returns launches by kernel (19b-19d) and 19c's compressed
    SVC."""
    import pylabfea_tpu_torch as FE
    t0 = time.perf_counter()
    mat_h, mat_ml, mat_el, _ = phase_host_train(FE, card)
    mats = (mat_h, mat_ml, mat_el)
    host, b = phase_host_vs_card(FE, device, mats, card)
    c = phase_host_read(FE, device, mats, card)
    d = phase_host_props(FE, device, mats, card)
    phase_host_round_trips(FE, device, mats, host, card)
    bad = sorted(m for m in sys.modules
                 if m.split('.')[0] in ('jax', 'jaxlib', 'sklearn',
                                        'pylabfea_tpu'))
    log(f'[19 host profile] phase 19 {time.perf_counter() - t0:.1f} s '
        f'(budget 90 s); jax / sklearn / pylabfea_tpu modules imported: '
        f'{bad or "none"}  [{card}]')
    if bad:
        fail(f'the host profile imported {bad}')
    launches = {k: b['launches'][k] + c['launches'][k] + d['launches'][k]
                for k in b['launches']}
    return dict(launches=launches, red=c['red'], mrec=b['mrec'], ld=b['ld'],
                seconds=time.perf_counter() - t0)


def host_checks(device, run, card):
    """Phase 19's kernels at its shapes against their plain versions: B at
    19c's grid, A and D at 19c's ML section (NX_19C / 3 x NY_19C points)
    on its compressed SVC, G in 19b's fixed-direction root find (256
    states, 19a's SVC uncompressed, 2000 marching steps)."""
    import torch
    from pylabfea_tpu_torch import bridge, convert
    red, mrec = run['red'], run['mrec']
    pred = dict(sv=red.support_vectors, dc=red.dual_coef, gamma=red.gamma,
                rho=red.intercept)
    n = NX_19C // 3 * NY_19C
    mats = {dt: convert.material_from_record(mrec, dtype=dt, device=device)
            for dt in (torch.float32, torch.float64)}
    return dict(
        k_apply=[check_kapply(device, NX_19C, NY_19C, 20, card)],
        svc_f_grad=[check_svc(device, n, pred, 10, card)],
        svc_decision=[check_svc_mm(device, n, pred, 10, card, 'D')],
        svc_yf_root=[check_fixed_root(
            device, lambda dt: bridge.HostLaw.of(mrec, mats[dt]), 256,
            run['ld'], card)])


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is visible; this smoke run needs '
              'an NVIDIA card', file=sys.stderr)
        return 1
    from pylabfea_tpu_torch import convert
    device = torch.device('cuda', 0)
    card = phase_device()
    phase_build()
    eb = [check_kapply(device, 1024, 1024, 20, card),
          check_kapply(device, 130, 67, 20, card)]
    # 128^3 (the 3-D path's fine level), grids that no 7 x 31 node tile of
    # kernel C divides, and float64
    ec = [check_kapply3(device, (128, 128, 128), torch.float32, 3e-6, 20,
                        card),
          check_kapply3(device, (40, 24, 72), torch.float32, 3e-6, 0, card),
          check_kapply3(device, (67, 29, 93), torch.float32, 3e-6, 0, card),
          check_kapply3(device, (16, 16, 16), torch.float64, 1e-12, 0, card),
          check_kapply3(device, (17, 9, 33), torch.float64, 1e-12, 0, card)]
    trained = dict(np.load(NPZ))
    trained = dict(sv=trained['support_vectors'], dc=trained['dual_coef'],
                   gamma=float(trained['gamma']),
                   rho=float(trained['intercept']))
    # A and E also at 1024 points x 135 SVs: the shape of their launches
    # in the REF_SOLVE 32^2 solve (the fast phase's Newton trips, the
    # faithful flow rule)
    ea = [check_svc(device, 2 ** 20 + 17, trained, 20, card),
          check_svc(device, 2 ** 20 + 17, synthetic_svc(), 10, card),
          check_svc(device, 1024, trained, 200, card)]
    ed = [check_svc_mm(device, 2 ** 20 + 17, p, 20, card, 'D')
          for p in (trained, synthetic_svc())]
    ee = [check_svc_mm(device, 2 ** 20 + 17, p, 20, card, 'E')
          for p in (trained, synthetic_svc())]
    ee.append(check_svc_mm(device, 1024, trained, 200, card, 'E'))
    ee.append(check_svc_mm_forms(device, trained, card))
    ef = [check_brent_step(device, FAITHFUL_N, 20, card)]

    def trained_mat(dtype):
        return convert.material_from_npz(NPZ, dtype=dtype, device=device)[0]

    def synthetic_mat(dtype):
        return convert.material_from_params(synthetic_svc(), is_svc=True,
                                            dtype=dtype, device=device)

    eg = [check_yf_root(device, 1024, trained_mat, 20, card, 'trained'),
          check_yf_root(device, FAITHFUL_N, synthetic_mat, 5, card,
                        'synthetic')]
    # the other feature layouts, each at the shapes its phase-13 path
    # gives the kernels first (the trained fixtures; A and D at 2^20
    # points, E at the 16^2 solve's 256, G at its 256 lanes and the
    # texture distances' 2^16), then A, D and E at F = 2, 9 and 15 on
    # 2^20+17 points x 512 synthetic SVs
    wide = {}
    for F, name, ne, ng in ((2, 'svc_cyl', 256, 256),
                            (9, 'svc_tex_gsh3', None, 2 ** 16),
                            (15, 'svc_wh', None, 1024)):
        z = np.load(os.path.join(DATA, name + '.npz'))
        fix = dict(sv=z['sv'], dc=z['dc'], gamma=float(z['gamma']),
                   rho=float(z['rho']))
        syn = synthetic_svc(nfeat=F)
        wide[F] = dict(
            A=[check_svc(device, 2 ** 20, fix, 10, card, n_ref=2 ** 18),
               check_svc(device, 2 ** 20 + 17, syn, 10, card)],
            D=[check_svc_mm(device, 2 ** 20, fix, 10, card, 'D',
                            n_ref=2 ** 18),
               check_svc_mm(device, 2 ** 20 + 17, syn, 10, card, 'D')],
            E=([check_svc_mm(device, ne, fix, 200, card, 'E')]
               if ne else [])
            + [check_svc_mm(device, 2 ** 20 + 17, syn, 10, card, 'E')],
            G=[check_yf_root(device, ng,
                             lambda dt, n=name: fixture(n, dt, device)[0],
                             20, card, name)])
    phase_return_map(device, 2 ** 20, 3, card)
    phase_faithful_map(device, FAITHFUL_N, torch.float64, card)
    phase_faithful_map(device, 2 ** 20, torch.float32, card)
    main_run = phase_main_path(device, 1024, card)
    phase_accuracy_step(device, main_run, card)
    phase_card_vs_cpu(device, 32, card)
    launches3 = phase_3d_path(device, 128, card)
    phase_3d_path(device, 64, card)
    phase_3d_card_vs_cpu(device, 8, card)
    f32, f64 = torch.float32, torch.float64
    ref = phase_ref_solve(device, [(8, f32, 1e-3), (16, f32, 1e-3),
                                   (32, f32, 1e-3), (8, f64, 1e-4)], card)
    phase_ref_card_vs_cpu(ref[(8, f64)][2], 8, f64)
    ref32 = ref[(32, f32)][1]
    phase_inclusion(device, 1024, card)
    phase_laminate(device, 1024, 1024, card)
    phase_box_inclusion(device, 64, card)
    phase_faithful3(device, 8, card)
    phase_new_card_vs_cpu(device, card)
    wh = phase_layout_path(device, 'svc_wh', 1024, card, '13a work hardening')
    cyl = phase_layout_path(device, 'svc_cyl', 1024, card, '13b cylindrical')
    cylf = phase_cyl_faithful(device, 16, card)
    tex = phase_texture(device, 2 ** 20, 2 ** 16, card)
    phase_layouts_card_vs_cpu(device, card)
    trained = phase_train(device, card)
    served = phase_serve_trained(device, trained, 1024, card)
    phase_calibrate(device, card)
    phase_femu(device, card)
    phase_train_card_vs_cpu(device, card)
    check_graphs(card)
    trained['served_ms'] = (served['checks']['svc_f_grad'][0][1],
                            served['checks']['svc_decision'][0][1])
    bridged = phase_bridge(device, trained, card)
    t16 = time.perf_counter()
    row = phase_2048(device, card)
    dd = phase_dd(device, card)
    log(f'[16-17] phases 16 and 17 {time.perf_counter() - t16:.1f} s '
        f'(their budget 150 s)  [{card}]')
    elem = phase_elem(device, card, main_run)
    hostp = phase_host(device, card)
    hostp['checks'] = host_checks(device, hostp, card)

    def entry(name, src, replaces, launches, checks):
        # no single PyTorch call computes any of these functions
        err = max(c[0] for c in checks)
        ms, pms, (bms, by) = checks[0][1:]
        return dict(name=name, route='cuda',
                    source=f'pylabfea_tpu_torch/csrc/{src}',
                    replaces=f'pylabfea_tpu/ops/{replaces}',
                    launches=launches, max_abs_err=err, ms=ms, plain_ms=pms,
                    bound_ms=bms, bound_by=by, library_ms=None)

    kernels = [
        entry('svc_f_grad', 'svc_fgrad.cu', 'pallas_kernels.py:231',
              main_run['launches'][1], ea),
        entry('k_apply', 'kapply2d.cu', 'stencil_pallas.py:138',
              main_run['launches'][0], eb),
        entry('k_apply3', 'kapply3d.cu', 'volume_pallas.py:175',
              launches3, ec),
        entry('svc_decision', 'svc_decision.cu', 'pallas_kernels.py:72',
              ref32['svc_decision'], ed),
        entry('svc_f_grad_mm', 'svc_fgrad_mm.cu', 'pallas_kernels.py:170',
              ref32['svc_f_grad_mm'], ee),
        # no Pallas kernel: the while-loop body of brent_jax, which XLA
        # fuses on the TPU; the faithful path runs its Brent in G
        entry('brent_step', 'brent_step.cu', 'rootfind.py:139',
              ref32['brent_step'], ef),
        # the decision function inside the marching while_loops and
        # brent_jax of the JAX ml_yf_dist
        entry('svc_yf_root', 'yf_root.cu',
              'pallas_kernels.py:72 + pylabfea_tpu/ops/rootfind.py:139',
              ref32['svc_yf_root'], eg),
    ]
    # the other feature layouts, each width where a path launched it: A
    # and D in the work-hardening (F = 15) and cylindrical (F = 2) 1024^2
    # steps and the texture return map (F = 9), E and G in the cylindrical
    # faithful solve (F = 2), G in the texture distances (F = 9)
    sources = dict(svc_f_grad=('A', 'svc_fgrad.cu', 'pallas_kernels.py:231'),
                   svc_decision=('D', 'svc_decision.cu',
                                 'pallas_kernels.py:72'),
                   svc_f_grad_mm=('E', 'svc_fgrad_mm.cu',
                                  'pallas_kernels.py:170'),
                   svc_yf_root=('G', 'yf_root.cu', 'pallas_kernels.py:72 + '
                                'pylabfea_tpu/ops/rootfind.py:139'))
    listed = set()
    for run in (wh, cyl, tex, cylf):
        for name, widths in run['launches'].items():
            for F, n in sorted(widths.items()):
                letter, src, repl = sources[name]
                if (name, F) in listed or F == 6 or not n \
                        or letter not in wide.get(F, {}):
                    continue
                listed.add((name, F))
                kernels.append(entry(f'{name}[F={F}]', src, repl, n,
                                     wide[F][letter]))
    # A, D and G at the trained SVC's support vectors, as 14b launched them
    for name, chk in served['checks'].items():
        letter, src, repl = sources[name]
        kernels.append(entry(f'{name}[card-trained]', src, repl,
                             served['launches'][name], chk))
    # the bridge's path (phase 15): B at phase 3's 1024^2 shape, A and D
    # at the compressed width, E on the faithful solve's shape, G in the
    # fixed-direction root find
    for name, chk in (('k_apply', eb),) + tuple(bridged['checks'].items()):
        letter, src, repl = sources.get(
            name, ('B', 'kapply2d.cu', 'stencil_pallas.py:138'))
        kernels.append(entry(f'{name}[bridge]', src, repl,
                             bridged['launches'][name], chk))
    # the 2048^2 row (phase 16) at its shapes; the domain decomposition
    # (phase 17): B and A on 17a's strip (its block is phase 3's 1024^2
    # grid), C on 17b's slab and at 17c's slab block
    for name, chk in row['checks'].items():
        letter, src, repl = sources.get(
            name, ('B', 'kapply2d.cu', 'stencil_pallas.py:138'))
        kernels.append(entry(f'{name}[2048]', src, repl,
                             row['launches'][name], chk))
    kernels += [
        entry('k_apply[strip]', 'kapply2d.cu', 'stencil_pallas.py:138',
              dd['strip']['launches']['k_apply'], eb),
        entry('svc_f_grad[strip]', 'svc_fgrad.cu', 'pallas_kernels.py:231',
              dd['strip']['launches']['svc_f_grad'], ea),
        entry('k_apply3[slab]', 'kapply3d.cu', 'volume_pallas.py:175',
              dd['slab']['launches']['k_apply3'], dd['check_slab']),
        # element-axis sharding (phase 18): A on 18a's 1024^2 share (phase
        # 3's shapes), C on 18b's 64^3 block (phase 17's 64^3 check)
        entry('svc_f_grad[elem]', 'svc_fgrad.cu', 'pallas_kernels.py:231',
              elem['elem2d']['launches']['svc_f_grad'], ea),
        entry('k_apply3[elem]', 'kapply3d.cu', 'volume_pallas.py:175',
              elem['elem3d']['launches']['k_apply3'], dd['check_slab'])]
    # the host profile's path (phase 19): B, A, D and G at its shapes
    for name, chk in hostp['checks'].items():
        letter, src, repl = sources.get(
            name, ('B', 'kapply2d.cu', 'stencil_pallas.py:138'))
        kernels.append(entry(f'{name}[host]', src, repl,
                             hostp['launches'][name], chk))
    top = sorted(CLOCK['phases'].items(), key=lambda kv: -kv[1])
    log(f'[clock] chip_smoke {time.perf_counter() - CLOCK["start"]:.1f} s '
        f'(limit 1200 s); by phase, longest first: '
        + ', '.join(f'{k} {v:.1f}' for k, v in top))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
