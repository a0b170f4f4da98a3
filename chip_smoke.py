#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pylabfea_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for sm_90a), nvcc
under $CUDA_HOME or /usr/local/cuda, and PyTorch with CUDA; JAX is not
used.  Phases, each of which must pass:

1. device: card name and power limit (nvidia-smi), torch/CUDA versions,
   TF32 off;
2. build: nvcc builds both kernels from ``pylabfea_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with times;
4. the SVC return map on 2^20 states (512-SV synthetic SVC);
5. the main path: a 1024 x 1024 Hill-ML load step (the trained SVC of
   ``REF_SOLVE_svc.npz``), one untimed step then two timed warm-started
   steps, which must launch both kernels;
6. the same steps at 64 x 64 on the card and on the CPU (plain versions),
   in float32 and float64, which must agree.

The last two lines are a JSON object with every kernel's launches, error
and times, and ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero without those lines.
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
           if 'registers' in ln or 'spill' in ln]
    log(f'[2 build] {built.path.name}: nvcc {built.seconds:.2f} s, load '
        f'{wall:.2f} s')
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
    return err, ms, pms


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
    gexp = N * sv.shape[0] / (ms * 1e-3) / 1e9
    log(f'[3 kernel A] svc_f_grad N={N} nsv={sv.shape[0]} f32 with_grad: '
        f'kernel {ms:.4f} ms ({gexp:.1f} G point-SV pairs/s), plain '
        f'{pms:.4f} ms  [{card}]')
    return max(errs), ms, pms


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


def phase_main_path(device, NB, card):
    import torch
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe_kernels as fek, stencil
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=torch.float32,
                                             device=device)
    md = fek.rect_mesh(NB, NB, LX=1., LY=1., uniax='y', eps_tot=eps,
                       dtype=torch.float32, device=device)
    counters = (stencil.k_apply, sk.svc_f_grad)
    for c in counters:
        c.launches = 0
    st, d, times, iters, before = run_steps(md, mat, CV, torch.float32, 2,
                                            device, counters)
    launches = [c.launches for c in counters]
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
    trained = dict(np.load(NPZ))
    trained = dict(sv=trained['support_vectors'], dc=trained['dual_coef'],
                   gamma=float(trained['gamma']),
                   rho=float(trained['intercept']))
    ea = [check_svc(device, 2 ** 20 + 17, trained, 20, card),
          check_svc(device, 2 ** 20 + 17, synthetic_svc(), 10, card)]
    phase_return_map(device, 2 ** 20, 3, card)
    main_run = phase_main_path(device, 1024, card)
    phase_card_vs_cpu(device, 64, card)
    kernels = [
        dict(name='svc_f_grad', route='cuda',
             source='pylabfea_tpu_torch/csrc/svc_fgrad.cu',
             replaces='pylabfea_tpu/ops/pallas_kernels.py:231',
             launches=main_run['launches'][1],
             max_abs_err=max(e[0] for e in ea), ms=ea[0][1],
             plain_ms=ea[0][2]),
        dict(name='k_apply', route='cuda',
             source='pylabfea_tpu_torch/csrc/kapply2d.cu',
             replaces='pylabfea_tpu/ops/stencil_pallas.py:138',
             launches=main_run['launches'][0],
             max_abs_err=max(e[0] for e in eb), ms=eb[0][1],
             plain_ms=eb[0][2]),
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
