#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pylabfea_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for sm_90a), nvcc
under $CUDA_HOME or /usr/local/cuda, and PyTorch with CUDA; JAX is not
used.  Phases, each of which must pass:

1. device: card name and power limit (nvidia-smi), torch/CUDA versions,
   TF32 off;
2. build: nvcc builds the three kernels from ``pylabfea_tpu_torch/csrc``
   (one compiler per source, in parallel);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with times;
4. the SVC return map on 2^20 states (512-SV synthetic SVC);
5. the 2-D path: a 1024 x 1024 Hill-ML load step (the trained SVC of
   ``REF_SOLVE_svc.npz``), one untimed step then two timed warm-started
   steps, which must launch kernels A and B;
6. the same steps at 64 x 64 on the card and on the CPU (plain versions),
   in float32 and float64, which must agree;
7. the 3-D path: a 128^3 hex8 box (2,097,152 elements) with J2 + linear
   hardening, the ``bench.py`` protocol (an untimed 0.4 step, a timed
   warm-started 0.3 step), which must launch kernel C and meet the uniaxial
   closed form; then the same at 64^3;
8. three 3-D steps at 16^3 on the card and on the CPU, float64 and float32,
   which must agree.

Every launch count of a path is set to 0 just before that path runs and
read just after.  The last two lines are a JSON object with every kernel's
launches, error, times and bound, and ``{"ok": true, "device": {...}}``.
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
SY = 150.
#: J2 + linear hardening of the 3-D path (bench.py fe3d_fields), MPa
E3, KHARD3 = 200.e3, 500.
#: H100 SXM data sheet: HBM3 bytes/s and float32 FLOP/s outside the tensor
#: cores, at the full 700 W power limit
HBM_BPS, F32_FLOPS = 3.35e12, 67.e12


def fail(msg):
    raise RuntimeError(f'chip_smoke: {msg}')


def log(msg):
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


def elastic_cv():
    """Isotropic elastic stiffness E = 200 GPa, nu = 0.3 (MPa)."""
    E, nu = 200.e3, 0.3
    hh = E / ((1. + nu) * (1. - 2. * nu))
    CV = np.zeros((6, 6))
    CV[:3, :3] = nu * hh
    np.fill_diagonal(CV[:3, :3], (1. - nu) * hh)
    CV[3, 3] = CV[4, 4] = CV[5, 5] = (0.5 - nu) * hh
    return CV


def synthetic_svc(nsv=512):
    """The 512-SV synthetic SVC of ``bench.py`` (``flagship``): unit
    directions at radii 0.9 / 1.1 with dual coefficients -/+0.5."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(nsv, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    lab = np.where(np.arange(nsv) % 2 == 0, 0.9, 1.1)
    return dict(hill=np.ones(6), sy=SY, khard=0., drucker=0.,
                sv=u * lab[:, None], dc=np.where(lab > 1., 1., -1.) * 0.5,
                rho=0.05, gamma=2.5, scale_seq=SY)


def return_map_states(N, seed=1):
    """Stress states near the yield locus and strain increments that drive
    plastic flow (``bench.py`` return-map workload)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(N, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * SY * rng.uniform(0.55, 0.95, (N, 1))
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


def phase_build():
    from pylabfea_tpu_torch.kernels import build
    t0 = time.perf_counter()
    built = build.load()
    wall = time.perf_counter() - t0
    ptx = [ln.strip() for ln in built.log.splitlines()
           if 'registers' in ln or 'spill' in ln or 'entry function' in ln
           or ln.startswith('---')]
    log(f'[2 build] {", ".join(p.name for p in built.paths)}: nvcc '
        f'{built.seconds:.2f} s (parallel), load {wall:.2f} s')
    for ln in ptx:
        log(f'    ptxas: {ln}')


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
    ref = volume.k_apply3_plain(Cp, *u, lx, ly, lz)
    sync(device)
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    scale = max(float(r.abs().max()) for r in ref)
    ok = err <= rtol * scale
    name = 'x'.join(map(str, shape))
    log(f'[3 kernel C] k_apply3 {name} {dtype}: max|err| {err:.3e} (bound '
        f'{rtol:g}*{scale:.3e} = {rtol * scale:.3e}) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'k_apply3 {name} {dtype} disagrees with its plain version')
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


def check_svc(device, N, params, reps, card):
    import torch
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    rng = np.random.default_rng(2)
    u = rng.normal(size=(N, 6))
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
    for with_grad in (True, False):
        f, g = sk.svc_f_grad(x, sv, dc, gamma, rho, with_grad)
        fr, gr = sk.svc_f_grad_plain(x64, sv64, dc64, gamma, rho, with_grad)
        sync(device)
        ef = float((f.double() - fr).abs().max())
        eg = float((g.double() - gr).abs().max()) if with_grad else 0.
        ok = ef <= ftol and eg <= gtol
        log(f'[3 kernel A] svc_f_grad N={N} nsv={sv.shape[0]} '
            f'with_grad={with_grad} f32 vs plain f64: max|err| f {ef:.3e} '
            f'(bound {ftol:.3e}), g {eg:.3e} (bound {gtol:.3e}) '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'svc_f_grad nsv={sv.shape[0]} disagrees with its plain '
                 'version')
        errs.append(max(ef, eg))
    ms = timed_ms(lambda: sk.svc_f_grad(x, sv, dc, gamma, rho), reps)
    pms = timed_ms(lambda: sk.svc_f_grad_plain(x, sv, dc, gamma, rho),
                   max(reps // 4, 1))
    nsv, F = sv.shape
    gexp = N * nsv / (ms * 1e-3) / 1e9
    # x, sv, dc read, f and g written once; 5F + 4 flops per point-SV pair
    # (F subtracts and F multiply-adds of the distance, the gamma product,
    # the exp, the dc product, the f sum and F multiply-adds of g)
    bnd = bound_ms((2 * N * F + N + nsv * (F + 1)) * 4,
                   N * nsv * (5 * F + 4))
    log(f'[3 kernel A] svc_f_grad N={N} nsv={nsv} f32 with_grad: '
        f'kernel {ms:.4f} ms ({gexp:.1f} G point-SV pairs/s), plain '
        f'{pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})  [{card}]')
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
    """Every kernel wrapper's launch counter: kernels A, B, C."""
    from pylabfea_tpu_torch.ops import stencil, svc_kernels, volume
    return (svc_kernels.svc_f_grad, stencil.k_apply, volume.k_apply3)


def reset_counts():
    for c in counters():
        c.launches = 0


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
        f'{launches[0]}, svc_f_grad {launches[1]}')
    if not fin:
        fail('main path produced non-finite fields')
    if min(timed) == 0:
        fail('a kernel of the main path was not launched in the timed '
             'steps')
    if not 0.5 * SY < gsig[1] < 2. * SY:
        fail(f'axial stress {gsig[1]} outside the plausible range after '
             'three plastic load steps')
    return dict(step_s=times[0], step_s_rep=times[1], cg_iters_hist=iters,
                launches=launches)


def phase_card_vs_cpu(device, NB, card):
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    cpu = torch.device('cpu')
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


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is visible; this smoke run needs '
              'an NVIDIA card', file=sys.stderr)
        return 1
    device = torch.device('cuda', 0)
    card = phase_device()
    phase_build()
    eb = [check_kapply(device, 1024, 1024, 20, card),
          check_kapply(device, 130, 67, 20, card)]
    ec = [check_kapply3(device, (128, 128, 128), torch.float32, 3e-6, 20,
                        card),
          check_kapply3(device, (40, 24, 72), torch.float32, 3e-6, 0, card),
          check_kapply3(device, (16, 16, 16), torch.float64, 1e-12, 0, card)]
    trained = dict(np.load(NPZ))
    trained = dict(sv=trained['support_vectors'], dc=trained['dual_coef'],
                   gamma=float(trained['gamma']),
                   rho=float(trained['intercept']))
    ea = [check_svc(device, 2 ** 20 + 17, trained, 20, card),
          check_svc(device, 2 ** 20 + 17, synthetic_svc(), 10, card)]
    phase_return_map(device, 2 ** 20, 3, card)
    main_run = phase_main_path(device, 1024, card)
    phase_card_vs_cpu(device, 64, card)
    launches3 = phase_3d_path(device, 128, card)
    phase_3d_path(device, 64, card)
    phase_3d_card_vs_cpu(device, 16, card)

    def entry(name, src, replaces, launches, checks):
        # no single PyTorch call computes any of these functions
        err, ms, pms, (bms, by) = max(c[0] for c in checks), *checks[0][1:]
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
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
