"""PyTorch port: the CUDA kernels on the card (marker ``cuda``).

These skip without an NVIDIA card.  On the card (where JAX is absent, so
the suite's conftest cannot load) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from pylabfea_tpu_torch import convert, workloads
from pylabfea_tpu_torch.ops import constitutive as con
from pylabfea_tpu_torch.ops import fe_kernels as fek
from pylabfea_tpu_torch.ops import jtensors as jt
from pylabfea_tpu_torch.ops import rootfind
from pylabfea_tpu_torch.ops import stencil
from pylabfea_tpu_torch.ops import svc_kernels as sk
from pylabfea_tpu_torch.ops import volume

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card with CUDA')
    return torch.device('cuda', 0)


def _kp(NX, NY, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    md = fek.rect_mesh(NX, NY, LX=1., LY=1.5, dtype=dtype, device=device)
    els = torch.as_tensor(rng.uniform(0.5, 2., (36, NX, NY)) * 1e5,
                          dtype=dtype, device=device)
    u = [torch.as_tensor(rng.normal(size=(NX + 1, NY + 1)), dtype=dtype,
                         device=device) for _ in range(2)]
    return fek.element_stiffness_planes(md, els), u[0], u[1]


@pytest.mark.parametrize('dtype,rtol', [(torch.float32, 2e-6),
                                        (torch.float64, 1e-14)])
@pytest.mark.parametrize('NX,NY', [(33, 17), (1, 1), (64, 128)])
def test_k_apply_kernel_matches_plain(cuda, NX, NY, dtype, rtol):
    Kp, u0, u1 = _kp(NX, NY, dtype, cuda)
    n0 = stencil.k_apply.launches
    out = stencil.k_apply(Kp, u0, u1)
    torch.cuda.synchronize()
    assert stencil.k_apply.launches == n0 + 1
    for o, r in zip(out, stencil.k_apply_plain(Kp, u0, u1)):
        assert float((o - r).abs().max()) <= rtol * float(r.abs().max())


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('n,nsv', [(1, 3), (1000, 300)])
def test_svc_kernel_matches_plain(cuda, n, nsv, dtype, tol):
    rng = np.random.default_rng(1)
    x, sv = (torch.as_tensor(rng.normal(size=s) * 0.7, dtype=dtype,
                             device=cuda) for s in ((n, 6), (nsv, 6)))
    dc = torch.as_tensor(rng.uniform(-1., 1., nsv), dtype=dtype, device=cuda)
    m0 = sk.svc_f_grad.launches
    f, g = sk.svc_f_grad(x, sv, dc, 2.5, 0.3)
    f0, g0 = sk.svc_f_grad(x, sv, dc, 2.5, 0.3, with_grad=False)
    torch.cuda.synchronize()
    assert sk.svc_f_grad.launches == m0 + 2 and g0 is None
    fr, gr = sk.svc_f_grad_plain(x.double(), sv.double(), dc.double(), 2.5,
                                 0.3)
    bound = tol * max(1., float(dc.abs().sum()))
    assert float((f.double() - fr).abs().max()) <= bound
    assert float((f0.double() - fr).abs().max()) <= bound
    gbound = bound * 2. * 2.5 * float(x.abs().max() + sv.abs().max())
    assert float((g.double() - gr).abs().max()) <= gbound


#: kernel A's points at its launch boundaries: one thread a point up to 2
#: x 1024 a SM, two up to 4 x, four beyond; (multiple of sm_count() * 1024,
#: offset), resolved on the card
A_POINTS = [(0, 1), (0, 255), (0, 257), (1, -1), (1, 1), (2, -1), (2, 1),
            (4, -1), (4, 1)]


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('nsv', [135, 600])
@pytest.mark.parametrize('fill,off', A_POINTS)
def test_svc_kernel_points_per_thread_match_plain(cuda, fill, off, nsv,
                                                  dtype, tol):
    """Kernel A at N on both sides of its 1, 2 and 4 points-a-thread
    launches and with more SVs than one staged chunk (512), with and
    without the gradient; two launches give the same bits."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = fill * sms * 1024 + off
    rng = np.random.default_rng(3)
    x, sv = (torch.as_tensor(rng.normal(size=s) * 0.7, dtype=dtype,
                             device=cuda) for s in ((n, 6), (nsv, 6)))
    dc = torch.as_tensor(rng.uniform(-1., 1., nsv), dtype=dtype, device=cuda)
    f, g = sk.svc_f_grad(x, sv, dc, 2.5, 0.3)
    f2, g2 = sk.svc_f_grad(x, sv, dc, 2.5, 0.3)
    f0, g0 = sk.svc_f_grad(x, sv, dc, 2.5, 0.3, with_grad=False)
    torch.cuda.synchronize()
    assert g0 is None and torch.equal(f, f2) and torch.equal(g, g2)
    fr, gr = sk.svc_f_grad_plain(x.double(), sv.double(), dc.double(), 2.5,
                                 0.3)
    bound = tol * max(1., float(dc.abs().sum()))
    assert float((f.double() - fr).abs().max()) <= bound
    assert float((f0.double() - fr).abs().max()) <= bound
    gbound = bound * 2. * 2.5 * float(x.abs().max() + sv.abs().max())
    assert float((g.double() - gr).abs().max()) <= gbound


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('n,nsv', [(1, 3), (1000, 300), (4099, 600),
                                   (300_017, 135), (600_017, 600)])
def test_svc_mm_kernels_match_plain(cuda, n, nsv, dtype, tol):
    """Kernels D and E: N off the 256-thread block, nsv beyond one
    shared-memory chunk (512 records in D), D's 2 and 4 points a thread
    (N of 2 and 4 x 1024 per SM and more); two launches give the same
    bits."""
    rng = np.random.default_rng(2)
    x, sv = (torch.as_tensor(rng.normal(size=s) * 0.7, dtype=dtype,
                             device=cuda) for s in ((n, 6), (nsv, 6)))
    dc = torch.as_tensor(rng.uniform(-1., 1., nsv), dtype=dtype, device=cuda)
    d0, e0 = sk.svc_decision.launches, sk.svc_f_grad_mm.launches
    fd = sk.svc_decision(x, sv, dc, 2.5, 0.3)
    fd2 = sk.svc_decision(x, sv, dc, 2.5, 0.3)
    fe, ge = sk.svc_f_grad_mm(x, sv, dc, 2.5, 0.3)
    fe2, ge2 = sk.svc_f_grad_mm(x, sv, dc, 2.5, 0.3)
    torch.cuda.synchronize()
    assert (sk.svc_decision.launches, sk.svc_f_grad_mm.launches) \
        == (d0 + 2, e0 + 2)
    assert torch.equal(fd, fd2) and torch.equal(fe, fe2) \
        and torch.equal(ge, ge2)
    fr, gr = sk.svc_f_grad_plain(x.double(), sv.double(), dc.double(), 2.5,
                                 0.3)
    bound = tol * max(1., float(dc.abs().sum()))
    assert float((fd.double() - fr).abs().max()) <= bound
    assert float((fe.double() - fr).abs().max()) <= bound
    gbound = bound * 2. * 2.5 * float(x.abs().max() + sv.abs().max())
    assert float((ge.double() - gr).abs().max()) <= gbound


#: kernel E's points at its launch switches, N = sm_count() * 1024 * num //
#: den + off, resolved on the card: a group of GT = 32, 16, 8 threads a
#: point up to 8, 16, 64 points an SM (the switches at den = 128, 64, 16),
#: then one, two and four points a thread (at num = 2 and 4); and N off
#: the 256-thread block
E_POINTS = [(0, 1, 1), (0, 1, 255), (0, 1, 257)] \
    + [(1, d, o) for d in (128, 64, 16) for o in (0, 1)] \
    + [(m, 1, o) for m in (2, 4) for o in (-1, 0)]


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('nsv', [1, 3, 135, 600])
@pytest.mark.parametrize('num,den,off', E_POINTS)
def test_svc_mm_grad_launch_forms_match_plain(cuda, num, den, off, nsv,
                                              dtype, tol):
    """Kernel E in every launch form (grouped lanes, P points a thread) and
    with more SVs than one staged chunk (512) against the plain float64
    version; two launches give the same bits, and a 1024-point slice
    (grouped lanes, GT = 32) gives the bits of the whole launch, whatever
    form that took."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = sms * 1024 * num // den + off
    rng = np.random.default_rng(6)
    x, sv = (torch.as_tensor(rng.normal(size=s) * 0.7, dtype=dtype,
                             device=cuda) for s in ((n, 6), (nsv, 6)))
    dc = torch.as_tensor(rng.uniform(-1., 1., nsv), dtype=dtype, device=cuda)
    e0 = sk.svc_f_grad_mm.launches
    f, g = sk.svc_f_grad_mm(x, sv, dc, 2.5, 0.3)
    f2, g2 = sk.svc_f_grad_mm(x, sv, dc, 2.5, 0.3)
    torch.cuda.synchronize()
    assert sk.svc_f_grad_mm.launches == e0 + 2
    assert torch.equal(f, f2) and torch.equal(g, g2)
    for a in {0, max(n - 1024, 0), n // 2}:
        fs, gs = sk.svc_f_grad_mm(x[a:a + 1024].contiguous(), sv, dc, 2.5,
                                  0.3)
        assert torch.equal(fs, f[a:a + 1024]) and \
            torch.equal(gs, g[a:a + 1024]), a
    fr, gr = sk.svc_f_grad_plain(x.double(), sv.double(), dc.double(), 2.5,
                                 0.3)
    bound = tol * max(1., float(dc.abs().sum()))
    assert float((f.double() - fr).abs().max()) <= bound
    gbound = bound * 2. * 2.5 * float(x.abs().max() + sv.abs().max())
    assert float((g.double() - gr).abs().max()) <= gbound


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_brent_kernel_root_find_matches_cpu(cuda, dtype):
    """Kernel F: a whole root find on the card takes the CPU's iterates
    (the function itself is plain torch), N off the 256-thread block."""
    rng = np.random.default_rng(42)
    n = 1001
    a = rng.uniform(-3., 1., n)
    b = a + rng.uniform(0.5, 6., n)
    k = rng.uniform(0.3, 4., n)
    lo, hi = np.tanh(k * a), np.tanh(k * b)
    s = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo))
    b[::7] = a[::7] - 1.                      # no sign change: unconverged
    out = {}
    for dev in (cuda, torch.device('cpu')):
        kt, st = (torch.as_tensor(v, dtype=dtype, device=dev) for v in (k, s))
        n0 = rootfind.brent_step.launches
        out[dev.type] = rootfind.brent(
            lambda x: torch.tanh(kt * x) - st,
            torch.as_tensor(a, dtype=dtype, device=dev),
            torch.as_tensor(b, dtype=dtype, device=dev))
        launched = rootfind.brent_step.launches - n0
        assert (launched > 0) == (dev.type == 'cuda')
    root, ok = out['cuda']
    assert torch.equal(ok.cpu(), out['cpu'][1])
    assert bool(ok[1::7].all()) and not bool(ok[::7].any())
    # tanh on the card and on the CPU may differ in the last bit
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    assert float((root.cpu() - out['cpu'][0]).abs().max()) <= tol


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _yf_case(kind, n, dtype, device, dev_only=False):
    """(material, stresses at 20-400 MPa with two zero rows, peeq 0): the
    trained SVC or the 600-SV synthetic one (beyond one staged chunk)."""
    if kind == 'trained':
        mat = convert.material_from_npz(os.path.join(
            ROOT, 'REF_SOLVE_svc.npz'), dtype=dtype, device=device)[0]
    else:
        mat = convert.material_from_params(chip_smoke.synthetic_svc(600),
                                           is_svc=True,
                                           dev_only=dev_only, dtype=dtype,
                                           device=device)
    rng = np.random.default_rng(4)
    u = rng.normal(size=(n, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sig = u * rng.uniform(20., 400., (n, 1))
    sig[:2] = 0.
    return (mat, torch.as_tensor(sig, dtype=dtype, device=device),
            torch.zeros(n, dtype=dtype, device=device))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('kind,dev_only', [('trained', False),
                                           ('synthetic', True)])
@pytest.mark.parametrize('n', [64, 1024, 2 ** 16])
def test_yf_root_kernel_matches_plain(cuda, n, kind, dev_only, dtype):
    """Kernel G through ``ml_yf_dist`` against its plain version: float64
    distances within 1e-6 of their scale; in float32 every lane agrees
    within 1e-3 or parts on the Brent-or-fallback branch (rounding decides
    it), and at least 3/4 agree.  Two launches give the same bits; each
    lane's evaluation count lies within the marching and Brent limits."""
    mat, sig, peeq = _yf_case(kind, n, dtype, cuda, dev_only)
    g0 = sk.svc_yf_root.launches
    d = con.ml_yf_dist(mat, sig, peeq)
    again = con.ml_yf_dist(mat, sig, peeq)
    ref = con.ml_yf_dist(mat, sig, peeq, root=sk.svc_yf_root_plain)
    torch.cuda.synchronize()
    assert sk.svc_yf_root.launches == g0 + 2
    assert torch.equal(d, again)
    tol = (1e-6 if dtype == torch.float64 else 1e-3) * float(ref.abs().max())
    agree = (d - ref).abs() <= tol
    if dtype == torch.float64:
        assert bool(agree.all())
    else:
        fallback = jt.seq_j2_voigt(sig) - 0.85 * mat.sy
        parts = ((d - fallback).abs() <= tol) | ((ref - fallback).abs() <= tol)
        assert bool((agree | parts).all())
        assert int(agree.sum()) >= 0.75 * n
    su = torch.nn.functional.normalize(sig[2:], dim=-1)
    start = torch.full((n - 2,), mat.sy, dtype=dtype, device=cuda)
    evals = torch.zeros(n - 2, dtype=torch.int32, device=cuda)
    sk.svc_yf_root(su, start, 5. * start, mat.sv, mat.dc, mat.gamma,
                   mat.rho, sk.FeatureMap(mat.scale_seq,
                                          dev_only=mat.dev_only),
                   evals=evals)
    assert int(evals.min()) >= 1
    assert int(evals.max()) <= 1 + 2 * sk.MAXMARCH + sk.MAXITER


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_yf_root_kernel_is_bitwise_the_eager_composition(cuda, dtype):
    """Kernel G gives the bits of the eager composition it replaces: the
    marching loops and ``rootfind.brent`` (kernel F) over kernel D on the
    features PyTorch forms on the card.  In float32 the last bit of f
    decides per lane between Brent's root and the fallback, so the same
    bits keep the faithful solves where the composition had them."""
    mat, sig, _ = _yf_case('trained', 1024, dtype, cuda)
    su = sig[2:] / jt.seq_j2_voigt(sig[2:])[:, None]
    start = torch.full((1022,), mat.sy, dtype=dtype, device=cuda)
    start[::3] *= 0.5
    args = (su, start, 5. * start, mat.sv, mat.dc, mat.gamma, mat.rho,
            sk.FeatureMap(mat.scale_seq, dev_only=mat.dev_only))

    def f_of(x):
        return sk.svc_decision((x[:, None] * su) / mat.scale_seq, mat.sv,
                               mat.dc, mat.gamma, mat.rho)

    x0 = sk._march(f_of, start, 0.98, lambda x, f: (f >= 0.) & (x > 0.01))
    x1 = sk._march(f_of, start, 1.02, lambda x, f: (f < 0.) & (x < 5. * start))
    ref, ref_ok = rootfind.brent(f_of, x0, x1, maxiter=sk.MAXITER)
    xs, ok = sk.svc_yf_root(*args)
    assert torch.equal(ok, ref_ok) and torch.equal(xs, ref)


def test_ml_yf_dist_is_one_launch_of_kernel_g(cuda):
    """One ``ml_yf_dist`` call is one launch of G and none of D or F (its
    marching and Brent run inside G), with no host read of the device."""
    mat, sig, peeq = _yf_case('trained', 1024, torch.float32, cuda)
    counts = [c.launches for c in (sk.svc_yf_root, sk.svc_decision,
                                   rootfind.brent_step)]
    con.ml_yf_dist(mat, sig, peeq)              # builds, if not yet built
    torch.cuda.synchronize()
    counts[0] += 1
    torch.cuda.set_sync_debug_mode('error')
    try:
        con.ml_yf_dist(mat, sig, peeq)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert [c.launches for c in (sk.svc_yf_root, sk.svc_decision,
                                 rootfind.brent_step)] \
        == [counts[0] + 1, counts[1], counts[2]]


def _k3(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    C6 = rng.normal(size=(6, 6) + shape)
    C6 = 0.5 * (C6 + C6.transpose(1, 0, 2, 3, 4)) \
        + 6. * np.eye(6)[:, :, None, None, None]
    u = [rng.normal(size=tuple(n + 1 for n in shape)) for _ in range(3)]
    return (torch.as_tensor(C6.reshape((36,) + shape), dtype=dtype,
                            device=device),
            *(torch.as_tensor(x, dtype=dtype, device=device) for x in u))


@pytest.mark.parametrize('dtype,rtol', [(torch.float32, 3e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize('shape', [(1, 1, 1), (40, 24, 72), (17, 9, 33),
                                   (129, 3, 5)])
def test_k_apply3_kernel_matches_plain(cuda, shape, dtype, rtol):
    args = (*_k3(shape, dtype, cuda), 0.5, 0.25, 0.125)
    n0 = volume.k_apply3.launches
    out = volume.k_apply3(*args)
    again = volume.k_apply3(*args)
    torch.cuda.synchronize()
    assert volume.k_apply3.launches == n0 + 2
    for o, a, r in zip(out, again, volume.k_apply3_plain(*args)):
        assert torch.equal(o, a)        # fixed summation order
        assert float((o - r).abs().max()) <= rtol * float(r.abs().max())


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('shape', [(17, 9, 33), (40, 24, 72)])
def test_k_apply3_bits_do_not_depend_on_the_x_chunk(cuda, shape, dtype):
    """Kernel C sums every node in corner order from rounded element
    forces, whichever block computes them: any number of node layers a
    block marches over gives the bits of the launch's own choice."""
    from pylabfea_tpu_torch.kernels import build
    Cp, u0, u1, u2 = _k3(shape, dtype, cuda)
    ref = volume.k_apply3(Cp, u0, u1, u2, 0.5, 0.25, 0.125)
    lib = build.load().lib
    fn = lib.pylabfea_kapply3d_f32 if dtype == torch.float32 \
        else lib.pylabfea_kapply3d_f64
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for x_chunk in (1, 2, 7, shape[0] + 1):
        out = [torch.full_like(u0, float('nan')) for _ in range(3)]
        build.check(fn(Cp.data_ptr(), u0.data_ptr(), u1.data_ptr(),
                       u2.data_ptr(), *(o.data_ptr() for o in out),
                       *shape, 0.5, 0.25, 0.125, x_chunk, stream), 'x_chunk')
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            assert torch.equal(o, r), x_chunk


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    Kp, u0, u1 = _kp(8, 6, torch.float32, cuda)
    with pytest.raises(ValueError):
        stencil.k_apply(Kp, u0.T.contiguous().T, u1)     # not contiguous
    with pytest.raises(TypeError):
        stencil.k_apply(Kp, u0.double(), u1)
    with pytest.raises(ValueError):
        stencil.k_apply(Kp, u0[:-1].contiguous(), u1)
    x = torch.zeros(4, 5, device=cuda)
    with pytest.raises(ValueError):                      # F of x != F of sv
        sk.svc_f_grad(x, torch.zeros(3, 6, device=cuda),
                      torch.zeros(3, device=cuda), 1., 0.)
    with pytest.raises(TypeError):
        sk.svc_f_grad(torch.zeros(4, 6, device=cuda),
                      torch.zeros(3, 6, device=cuda, dtype=torch.float64),
                      torch.zeros(3, device=cuda), 1., 0.)
    st = {k: torch.zeros(5, device=cuda) for k in rootfind.STATE}
    with pytest.raises(TypeError):                       # done not bool
        rootfind.brent_step(st, 1e-5, 1e-15)
    st.update(done=torch.zeros(5, dtype=torch.bool, device=cuda),
              ok=torch.zeros(5, dtype=torch.bool, device=cuda))
    st['xcur'] = torch.zeros(10, device=cuda)[::2]
    with pytest.raises(ValueError):                      # not contiguous
        rootfind.brent_step(st, 1e-5, 1e-15)
    su = torch.zeros(4, 6, device=cuda)
    svs = (torch.zeros(3, 6, device=cuda), torch.zeros(3, device=cuda))
    with pytest.raises(ValueError):                      # start not (N,)
        sk.svc_yf_root(su, torch.zeros(5, device=cuda),
                       torch.zeros(4, device=cuda), *svs, 1., 0.,
                       sk.FeatureMap(1.))
    with pytest.raises(TypeError):                       # top float64
        sk.svc_yf_root(su, torch.zeros(4, device=cuda),
                       torch.zeros(4, device=cuda, dtype=torch.float64),
                       *svs, 1., 0., sk.FeatureMap(1.))
    with pytest.raises(ValueError):                      # evals not int32
        sk.svc_yf_root(su, torch.zeros(4, device=cuda),
                       torch.zeros(4, device=cuda), *svs, 1., 0.,
                       sk.FeatureMap(1.), evals=torch.zeros(4, device=cuda))
    for fn in (sk.svc_decision, sk.svc_f_grad_mm):
        with pytest.raises(ValueError):
            fn(x, torch.zeros(3, 6, device=cuda), torch.zeros(3, device=cuda),
               1., 0.)
        with pytest.raises(TypeError):
            fn(torch.zeros(4, 6, device=cuda),
               torch.zeros(3, 6, device=cuda, dtype=torch.float64),
               torch.zeros(3, device=cuda), 1., 0.)
    Cp, u0, u1, u2 = _k3((4, 3, 5), torch.float32, cuda)
    h = (1., 1., 1.)
    with pytest.raises(ValueError):                      # not contiguous
        volume.k_apply3(Cp, u0.transpose(0, 2).contiguous().transpose(0, 2),
                        u1, u2, *h)
    with pytest.raises(ValueError):
        volume.k_apply3(Cp[:, :, :, 1:], u0, u1, u2, *h)  # not contiguous
    with pytest.raises(TypeError):
        volume.k_apply3(Cp, u0.double(), u1, u2, *h)
    with pytest.raises(TypeError):
        volume.k_apply3(Cp.half(), u0.half(), u1.half(), u2.half(), *h)
    with pytest.raises(ValueError):
        volume.k_apply3(Cp, u0[:-1].contiguous(), u1, u2, *h)
    with pytest.raises(ValueError):
        volume.k_apply3(Cp[:35].contiguous(), u0, u1, u2, *h)


def _inclusion_els(N, dtype, device):
    """The tangent planes of bench.py's 3-material inclusion: E = 200e3
    in the matrix groups, the 200 times softer E = 1e3 in the inclusion."""
    mat_map = workloads.inclusion_map(N)
    md = fek.rect_mesh(N, N, LX=4., LY=4., mat_map=mat_map, dtype=dtype,
                       device=device)
    CVs = (convert.elastic_cv(200.e3, 0.3),) * 2 \
        + (convert.elastic_cv(1.e3, 0.27),)
    return md, fek.init_state(md, CVs, dtype=dtype).elstiff


@pytest.mark.parametrize('dtype,rtol', [(torch.float32, 2e-6),
                                        (torch.float64, 1e-14)])
@pytest.mark.parametrize('N', [96, 130])
def test_k_apply_kernel_on_the_inclusion_contrast(cuda, N, dtype, rtol):
    """Kernel B over per-element stiffness planes with the inclusion's
    200x contrast, against its plain version; on the soft elements too,
    each node within rtol of its own scale."""
    md, els = _inclusion_els(N, dtype, cuda)
    Kp = fek.element_stiffness_planes(md, els).contiguous()
    rng = np.random.default_rng(3)
    u = [torch.as_tensor(rng.normal(size=(N + 1, N + 1)), dtype=dtype,
                         device=cuda) for _ in range(2)]
    n0 = stencil.k_apply.launches
    out = stencil.k_apply(Kp, *u)
    torch.cuda.synchronize()
    assert stencil.k_apply.launches == n0 + 1
    ref = stencil.k_apply_plain(Kp, *u)
    # the scale of each node: the sum of |K_ij u_j| over its elements
    Ka = Kp.abs()
    ua = [x.abs() for x in u]
    mag = stencil.k_apply_plain(Ka, *ua)
    for o, r, m in zip(out, ref, mag):
        assert bool(((o - r).abs() <= 4. * rtol * m + 1e-300).all())


#: odd group block sizes: the inclusion's three groups at 1024^2 and small
#: ones off the kernels' thread blocks
GROUP_BLOCKS = [1, 3, 4097, 116_281, 465_977, 466_318]


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('n', GROUP_BLOCKS)
def test_svc_kernels_on_odd_group_blocks(cuda, n, dtype, tol):
    """Kernels A and D on a block of n rows gathered by a material sort
    and sliced out of the sorted rows (the grouped return map's operand),
    with the trained SVC, against the plain float64 version."""
    mat, _, _ = convert.material_from_npz(chip_smoke.NPZ, dtype=dtype,
                                          device=cuda)
    rng = np.random.default_rng(n)
    total = n + 37
    u = rng.normal(size=(total, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    rows = torch.as_tensor(u * rng.uniform(0.3, 1.3, (total, 1)),
                           dtype=dtype, device=cuda)
    perm = torch.as_tensor(rng.permutation(total), device=cuda)
    x = rows[perm][17:17 + n]
    a0, d0 = sk.svc_f_grad.launches, sk.svc_decision.launches
    f, g = sk.svc_f_grad(x, mat.sv, mat.dc, mat.gamma, mat.rho)
    fd = sk.svc_decision(x, mat.sv, mat.dc, mat.gamma, mat.rho)
    torch.cuda.synchronize()
    assert (sk.svc_f_grad.launches, sk.svc_decision.launches) \
        == (a0 + 1, d0 + 1)
    fr, gr = sk.svc_f_grad_plain(x.double(), mat.sv.double(),
                                 mat.dc.double(), mat.gamma, mat.rho)
    bound = tol * max(1., float(mat.dc.abs().sum()))
    assert float((f.double() - fr).abs().max()) <= bound
    assert float((fd.double() - fr).abs().max()) <= bound
    gbound = bound * 2. * mat.gamma * float(x.abs().max()
                                            + mat.sv.abs().max())
    assert float((g.double() - gr).abs().max()) <= gbound


def test_inclusion_step_on_the_card_matches_the_cpu(cuda):
    """One float64 load step of the 3-material inclusion at 32^2 (Hill,
    sdim=3 J2, elastic) on the card and on the CPU: 1e-9 and the same CG
    history."""
    res = []
    for dev in (cuda, torch.device('cpu')):
        md, mats, CVs = workloads.inclusion_case(32, torch.float64, dev)
        st = fek.init_state(md, CVs, dtype=torch.float64)
        for _ in range(2):
            st, d = fek.load_step_split(md, st, mats, CVs, 0.5, n_inner=2)
        res.append((st.sig.cpu(), d['glob_sig'].cpu(), d['cg_iters_hist']))
    (sa, ga, ia), (sb, gb, ib) = res
    assert ia == ib
    assert float((sa - sb).abs().max()) <= 1e-9 * float(sb.abs().max())
    assert float((ga - gb).abs().max()) <= 1e-9 * float(gb.abs().max())
    assert float(sb.abs().max()) > 0


#: feature counts of the SVC kernels' forms: compiled for 2, 6 and 15,
#: F a launch argument up to 32 (registers) and beyond (local memory)
WIDTHS = (1, 2, 9, 15, 16, 33, 40, sk.MAX_NFEAT)


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('n', [1, 1000, 9000, 4 * 132 * 1024 + 5])
@pytest.mark.parametrize('F', WIDTHS)
def test_svc_kernels_match_plain_at_every_width(cuda, F, n, dtype, tol):
    """Kernels A, D and E at F features against the plain float64 version
    (each launch form: a group of threads a point for E at small n, one
    to four points a thread at large n), with the bounds of the 6-feature
    tests; each launch is counted under its width."""
    rng = np.random.default_rng(F)
    sv64 = torch.as_tensor(rng.normal(size=(300, F)) * 0.5,
                           dtype=torch.float64, device=cuda)
    dc64 = torch.as_tensor(rng.uniform(-1., 1., 300), dtype=torch.float64,
                           device=cuda)
    x64 = torch.as_tensor(rng.normal(size=(n, F)) * 0.5,
                          dtype=torch.float64, device=cuda)
    x, sv, dc = x64.to(dtype), sv64.to(dtype), dc64.to(dtype)
    before = [k.launches_by_nfeat[F] for k in
              (sk.svc_f_grad, sk.svc_decision, sk.svc_f_grad_mm)]
    fa, ga = sk.svc_f_grad(x, sv, dc, 0.7, 0.1)
    fd = sk.svc_decision(x, sv, dc, 0.7, 0.1)
    fe, ge = sk.svc_f_grad_mm(x, sv, dc, 0.7, 0.1)
    torch.cuda.synchronize()
    assert [k.launches_by_nfeat[F] for k in
            (sk.svc_f_grad, sk.svc_decision, sk.svc_f_grad_mm)] \
        == [b + 1 for b in before]
    fr, gr = sk.svc_f_grad_plain(x64, sv64, dc64, 0.7, 0.1)
    bound = tol * max(1., float(dc64.abs().sum()))
    gbound = bound * 2. * 0.7 * float(x64.abs().max() + sv64.abs().max())
    for f in (fa, fd, fe):
        assert float((f.double() - fr).abs().max()) <= bound
    for g in (ga, ge):
        assert float((g.double() - gr).abs().max()) <= gbound


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('name', ['svc_wh', 'svc_cyl', 'svc_tex_gsh3',
                                  'svc_tex_adv'])
def test_yf_root_kernel_matches_plain_on_every_layout(cuda, name, dtype):
    """Kernel G through ``ml_yf_dist`` on the trained fixtures (work
    hardening with a plastic strain, cylindrical, texture) against its
    plain version, under the rule of the 6-feature test."""
    mat = convert.material_from_npz(os.path.join(
        ROOT, 'pylabfea_tpu_torch', 'data', name + '.npz'), dtype=dtype,
        device=cuda)[0]
    rng = np.random.default_rng(4)
    n = 2048
    sig = torch.as_tensor(rng.normal(0., 90., (n, 6)), dtype=dtype,
                          device=cuda)
    epl = torch.as_tensor(rng.normal(0., 2e-3, (n, 6)), dtype=dtype,
                          device=cuda)
    peeq = torch.zeros(n, dtype=dtype, device=cuda)
    g0 = sk.svc_yf_root.launches_by_nfeat[mat.sv.shape[1]]
    d = con.ml_yf_dist(mat, sig, peeq, epl)
    ref = con.ml_yf_dist(mat, sig, peeq, epl, root=sk.svc_yf_root_plain)
    torch.cuda.synchronize()
    assert sk.svc_yf_root.launches_by_nfeat[mat.sv.shape[1]] == g0 + 1
    tol = (1e-6 if dtype == torch.float64 else 1e-3) * float(ref.abs().max())
    agree = (d - ref).abs() <= tol
    assert bool(torch.isfinite(d).all())
    if dtype == torch.float64:
        assert bool(agree.all())
    else:
        assert int(agree.sum()) >= 0.75 * n


def test_wrappers_reject_feature_counts_out_of_range(cuda):
    x = torch.zeros(4, sk.MAX_NFEAT + 1, device=cuda)
    sv = torch.zeros(3, sk.MAX_NFEAT + 1, device=cuda)
    for fn in (sk.svc_f_grad, sk.svc_decision, sk.svc_f_grad_mm):
        with pytest.raises(ValueError):
            fn(x, sv, torch.zeros(3, device=cuda), 1., 0.)
        with pytest.raises(ValueError):
            fn(x[:, :0].contiguous(), sv[:, :0].contiguous(),
               torch.zeros(3, device=cuda), 1., 0.)


# -----------------------------------------------------------------
# training and inverse identification on the card
# -----------------------------------------------------------------
def test_fit_svc_on_the_card_matches_the_cpu(cuda):
    from pylabfea_tpu_torch import ml_train
    z = np.load(os.path.join(chip_smoke.DATA, 'train_small.npz'))
    X, y = z['X'], z['y'].astype(float)
    kw = dict(C=float(z['C']), gamma=float(z['gamma']), iters=300,
              dtype=torch.float64)
    pa, aa = ml_train.fit_svc(X, y, device=cuda, **kw)
    pb, ab = ml_train.fit_svc(X, y, device='cpu', **kw)
    assert np.abs(aa - ab).max() <= 1e-9 * np.abs(ab).max()
    n0 = sk.svc_decision.launches
    mat, score, _ = ml_train.train_svc(X, y, float(z['sy']), device=cuda,
                                       **kw)
    assert sk.svc_decision.launches == n0 + 1 and score > 97.


@pytest.mark.parametrize('integ', ['unrolled', 'implicit'])
def test_simulate_paths_and_jacobian_on_the_card(cuda, integ):
    """Card against CPU in float64, and the CUDA-graph replays of the
    fixed-trip map against eager calls on the card."""
    from pylabfea_tpu_torch.ops import calibrate as cal
    from pylabfea_tpu_torch.ops import dual, graphs
    out = {}
    for dev, graphed in ((cuda, True), (cuda, False), ('cpu', False)):
        graphs.ENABLED = graphed
        try:
            deps = torch.as_tensor(chip_smoke.cal_paths(12, 8, seed=2),
                                   dtype=torch.float64, device=dev)
            CV = torch.as_tensor(chip_smoke.elastic_cv(), dtype=torch.float64,
                                 device=dev)
            x0, unravel = cal.ravel_theta(chip_smoke.cal_theta(torch.float64,
                                                               dev))

            def f(x):
                return cal.simulate_paths(unravel(x), CV, deps, 40,
                                          integrator=integ).reshape(-1)
            y, J = dual.jacfwd(f, x0)
            y2, J2 = dual.jacfwd(f, x0)       # a replay where graphed
            out[(str(dev), graphed)] = (y.cpu(), J.cpu(), y2.cpu(), J2.cpu())
        finally:
            graphs.ENABLED = True
    g, e, c = out[(str(cuda), True)], out[(str(cuda), False)], \
        out[('cpu', False)]
    for a, b in zip(g, e):
        assert torch.equal(a, b)
    for a, b in zip(e, c):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


def test_step_implicit_on_the_card_matches_the_cpu(cuda):
    from pylabfea_tpu_torch.ops import dual, femu
    res = {}
    for dev in (cuda, torch.device('cpu')):
        md, build, CVs, truth = chip_smoke.femu_specimen(4, torch.float64,
                                                         dev)
        mdf = femu.flatten_mesh(md)
        th = dict(truth, log_sy=dual.Dual(truth['log_sy'], torch.ones(
            1, dtype=torch.float64, device=dev)))
        z = torch.zeros((md.nel, 6), dtype=torch.float64, device=dev)
        du, sig, _ = femu.step_implicit(mdf, build(th), CVs, z, z,
                                        mdf.fixed_val * 0.5)
        res[dev.type] = (du.v.cpu(), du.t.cpu(), sig.v.cpu())
    for a, b in zip(res['cuda'], res['cpu']):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


def test_flat_cg_on_the_card_matches_the_cpu(cuda):
    from pylabfea_tpu_torch.ops import femu
    out = {}
    for dev in (cuda, torch.device('cpu')):
        md = femu.flatten_mesh(fek.rect_mesh(12, 9, LX=1., LY=1.5,
                                             dtype=torch.float64,
                                             device=dev))
        rng = np.random.default_rng(1)
        els = torch.as_tensor(np.asarray(chip_smoke.elastic_cv())[None]
                              * rng.uniform(0.5, 1.5, (md.nel, 1, 1)),
                              device=dev)
        out[dev.type] = fek.solve_linear(md, els, md.fixed_val, cg_tol=1e-10,
                                         cg_maxiter=600)
    (a, ra, ia), (b, rb, ib) = out['cuda'], out['cpu']
    assert ia == ib
    assert float((a.cpu() - b).abs().max()) <= 1e-10 * float(b.abs().max())


def test_svc_derivative_raises_on_the_card(cuda):
    mat, CV, _ = convert.material_from_npz(
        os.path.join(chip_smoke.ROOT, 'REF_SOLVE_svc.npz'),
        dtype=torch.float64, device=cuda)
    sig = torch.full((8, 6), 20., dtype=torch.float64, device=cuda)
    deps = torch.full((8, 6), 1e-4, dtype=torch.float64, device=cuda,
                      requires_grad=True)
    CV = torch.as_tensor(CV, device=cuda)
    with pytest.raises(NotImplementedError, match='hessian'):
        con.response_fast(mat, (sig, torch.zeros_like(sig)), deps, CV, 40,
                          fixed_trip=True)
    n0 = sk.svc_f_grad.launches
    out = con.response_fast(mat, (sig, torch.zeros_like(sig)),
                            deps.detach(), CV, 40, fixed_trip=True)
    assert sk.svc_f_grad.launches > n0 and bool(torch.isfinite(out[1]).all())


def test_fixed_trip_graphs_take_new_floats_and_stay_bounded(cuda):
    """The fixed-trip map's CUDA graphs: a material float of a new value
    replays the graph captured for the first (equal to an eager call), no
    capture fails, and at most ``graphs.MAX_GRAPHS`` graphs are kept."""
    from pylabfea_tpu_torch.ops import graphs
    f64 = torch.float64
    CV = torch.as_tensor(chip_smoke.elastic_cv(), dtype=f64, device=cuda)
    mat = convert.material_from_params(
        dict(hill=np.array([1.3, .85, 1., 1., 1., 1.]), sy=180.,
             khard=800., drucker=0.), is_svc=False, dtype=f64, device=cuda)
    rng = np.random.default_rng(3)

    def states(n):
        return [torch.as_tensor(rng.normal(0., s, (n, 6)), dtype=f64,
                                device=cuda) for s in (120., 1e-3, 2e-3)]

    ft = con._FIXED_TRIP
    ft.graphs.clear()
    sig, epl, deps = states(256)
    for sy in (180., 150., 210.):
        m = dataclasses.replace(mat, sy=sy)
        r0 = ft.replays
        out = con.response_fast(m, (sig, epl), deps, CV, 12, fixed_trip=True)
        assert not ft.failed, list(ft.failed.values())
        graphs.ENABLED = False
        try:
            ref = con.response_fast(m, (sig, epl), deps, CV, 12,
                                    fixed_trip=True)
        finally:
            graphs.ENABLED = True
        assert ft.replays == r0 + (sy != 180.)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert len(ft.graphs) == 1
    for n in range(1, graphs.MAX_GRAPHS + 3):
        sig, epl, deps = states(n)
        con.response_fast(mat, (sig, epl), deps, CV, 12, fixed_trip=True)
    assert len(ft.graphs) == graphs.MAX_GRAPHS and not ft.failed


@pytest.mark.parametrize('name', ['bcnode', 'resume', 'bar_sf2'])
def test_bridge_records_on_the_card_match_the_cpu(cuda, name):
    """The committed bridge records solved in f64 on the card (kernel B,
    the flat Jacobi-CG of the bars) and on the CPU agree within 1e-9."""
    from pylabfea_tpu_torch import bridge
    rec = bridge.load_record(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'pylabfea_tpu_torch', 'data', f'bridge_{name}.npz'))
    f64 = torch.float64
    card = bridge.run_record(rec, dtype=f64, device=cuda)
    cpu = bridge.run_record(rec, dtype=f64, device='cpu')
    for k in ('u', 'f', 'sig', 'sgl'):
        a, b = card[k], cpu[k]
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), k


def test_fixed_direction_root_find_kernel_matches_plain(cuda):
    """``HostLaw.ml_full_yf`` through kernel G (2000 marching steps, the
    load direction of every row) against G's plain version on the card:
    f64 distances within 1e-6 of their scale; G launched once."""
    from pylabfea_tpu_torch import bridge
    rec = bridge.load_record(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'pylabfea_tpu_torch', 'data', 'bridge_ml_shear.npz'))
    mrec = rec['materials'][0]
    f64 = torch.float64
    law = bridge.HostLaw.of(mrec, convert.material_from_record(
        mrec, dtype=f64, device=cuda))
    rng = np.random.default_rng(3)
    sig = torch.as_tensor(rng.normal(0., 40., (333, 6)), dtype=f64,
                          device=cuda)
    epl = torch.as_tensor(rng.normal(0., 1e-3, (333, 6)), dtype=f64,
                          device=cuda)
    for ld in (np.eye(6)[5], np.eye(6)[0] - np.eye(6)[1]):
        n0 = sk.svc_yf_root.launches
        d = law.ml_full_yf(sig, epl, ld)
        assert sk.svc_yf_root.launches == n0 + 1
        dp = law.ml_full_yf(sig, epl, ld, root=sk.svc_yf_root_plain)
        assert float((d - dp).abs().max()) <= 1e-6 * float(dp.abs().max())


def test_reduce_svc_on_the_card_matches_the_cpu(cuda):
    """``reduce_svc`` in f64 on the card: the CPU's center count and
    relative RKHS error, the reduced decision function within 1e-6."""
    from pylabfea_tpu_torch.ops import svc as tsvc
    z = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'REF_SOLVE_svc.npz'))
    p = tsvc.SVCParams(z['support_vectors'], z['dual_coef'],
                       float(z['intercept']), float(z['gamma']))
    rc, relc = tsvc.reduce_svc(p, n_out=32, device=cuda)
    rh, relh = tsvc.reduce_svc(p, n_out=32, device='cpu')
    assert rc.support_vectors.shape == rh.support_vectors.shape
    assert abs(relc - relh) <= 1e-6 * relh
    x = torch.as_tensor(np.random.default_rng(0).normal(0., 0.6, (512, 6)))
    fc = tsvc.decision_function(torch.as_tensor(rc.support_vectors),
                                torch.as_tensor(rc.dual_coef), p.intercept,
                                p.gamma, x)
    fh = tsvc.decision_function(torch.as_tensor(rh.support_vectors),
                                torch.as_tensor(rh.dual_coef), p.intercept,
                                p.gamma, x)
    assert float((fc - fh).abs().max()) <= 1e-6 * float(fh.abs().max())


def test_k_apply3_batch_launches_each_item(cuda):
    """Kernel C on a batch of displacement volumes (the slab coarse
    space's basis functions): one launch an item, each item the plain
    version's."""
    Cp, u = chip_smoke.kapply3_inputs((2, 9, 5), torch.float64, cuda)
    ub = tuple(torch.stack([x, 2. * x, -x]) for x in u)
    n0 = volume.k_apply3.launches
    out = volume.k_apply3(Cp, *ub, 0.5, 0.3, 0.7)
    torch.cuda.synchronize()
    assert volume.k_apply3.launches == n0 + 3
    ref = volume.k_apply3_plain(Cp, *ub, 0.5, 0.3, 0.7)
    for o, r in zip(out, ref):
        assert float((o - r).abs().max()) <= 1e-12 * float(r.abs().max())


@pytest.mark.parametrize('case', [
    dict(kind='strip_step', NX=32, NY=32, eps=0.002, mats='svc',
         load_frac=0.5, n_inner=2, dtype='float64', cg_tol=1e-13),
    dict(kind='strip_step', NX=32, NY=32, LX=4., LY=4., mats='inclusion',
         load_frac=0.25, n_inner=2, dtype='float64', cg_tol=1e-13),
    dict(kind='slab', NX=8, NY=8, NZ=8, eps=0.002, mats='j2', nsteps=2,
         n_inner=1, dtype='float64')])
def test_decomposition_on_the_card_matches_the_cpu(cuda, case):
    """The strip step and the slab solve at world size 1 on the card
    (kernels B, A and C) against the CPU's plain versions, float64 within
    1e-9; the card's run launches its kernels."""
    from pylabfea_tpu_torch.parallel import distributed, runs
    one = distributed.RankMesh()
    card, = runs.suite(one, cuda, [case])
    cpu, = runs.suite(one, torch.device('cpu'), [case])
    key = 'u' if case['kind'] == 'slab' else 'du'
    for k in ('glob_sig', 'sig', key):
        assert np.abs(card[k] - cpu[k]).max() \
            <= 1e-9 * np.abs(cpu[k]).max(), k
    need = 'k_apply3' if case['kind'] == 'slab' else 'k_apply'
    assert card['launches'][need] > 0 and cpu['launches'][need] == 0


@pytest.mark.parametrize('case', [
    dict(kind='elem2d', NX=32, NY=32, eps=0.002, mats='svc',
         fracs=[0.25, 0.25], n_inner=2, dtype='float64', cg_tol=1e-10,
         cg_maxiter=2000),
    dict(kind='elem3d', NX=8, NY=8, NZ=8, eps=0.002, mats='j2',
         fracs=[0.4, 0.3], n_inner=2, dtype='float64')])
def test_element_sharded_steps_on_the_card_match_the_cpu(cuda, case):
    """The element-sharded 2-D and 3-D steps at world size 1 on the card
    (kernels A and C) against the CPU's plain versions, float64 within
    1e-9, the same CG histories; the card's run launches its kernel."""
    from pylabfea_tpu_torch.parallel import distributed, runs
    one = distributed.RankMesh()
    card, = runs.suite(one, cuda, [case])
    cpu, = runs.suite(one, torch.device('cpu'), [case])
    for k in ('glob_sig', 'sig', 'u'):
        assert np.abs(card[k] - cpu[k]).max() \
            <= 1e-9 * np.abs(cpu[k]).max(), k
    assert card['cg_iters_hist'] == cpu['cg_iters_hist']
    need = 'svc_f_grad' if case['kind'] == 'elem2d' else 'k_apply3'
    assert card['launches'][need] > 0 and cpu['launches'][need] == 0


# -----------------------------------------------------------------
# the host profile feeding the card
# -----------------------------------------------------------------
def test_train_hill_workflow_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """``examples/train_hill.py``'s workflow at a tiny size through the
    port's ``Material`` / ``Model``: ``train_SVC(backend='jax')`` on the
    card and on the CPU (both float64: duals within 1e-9 of their scale,
    the same support vectors), the host ``Model.solve()``, then
    ``bridge.solve_on_device_adaptive`` (faithful, f64) of the 6 x 2
    laminate on the card (B, D, E and G launched) against the CPU within
    1e-9."""
    import functools
    import pylabfea_tpu_torch as FE
    from pylabfea_tpu_torch import bridge, ml_train
    monkeypatch.setattr(ml_train, 'train_svc_jax', functools.partial(
        ml_train.train_svc_jax, dtype=torch.float64))
    mat_h = FE.Material(name='Hill-reference')
    mat_h.elasticity(E=200.e3, nu=0.3)
    mat_h.plasticity(sy=50., rv=[1.2, 1., 0.8, 1., 1., 1.], sdim=6)
    trained = {}
    for dev in (cuda, 'cpu'):
        m = FE.Material(name='Hill-ML')
        m.train_SVC(C=4, gamma=1.5, mat_ref=mat_h, Nlc=12, Nseq=4, Fe=0.3,
                    Ce=0.95, backend='jax', device=dev)
        m.dev_only = False
        trained[str(dev)] = m
    mc, mh = trained[str(cuda)], trained['cpu']
    np.testing.assert_array_equal(mc._svc.support_vectors,
                                  mh._svc.support_vectors)
    assert np.abs(mc._svc.dual_coef - mh._svc.dual_coef).max() \
        <= 1e-9 * np.abs(mh._svc.dual_coef).max()
    mat_el = FE.Material(name='elastic inclusion')
    mat_el.elasticity(E=600.e3, nu=0.3)
    host = chip_smoke.host_model(FE, [mat_h, mat_el, mh], 6, 2)
    host.solve()
    out = {}
    for dev in (cuda, 'cpu'):
        fem = chip_smoke.host_model(FE, [mat_h, mat_el, mh], 6, 2)
        n0 = {c.__name__: c.launches for c in chip_smoke.counters()}
        bridge.solve_on_device_adaptive(fem, dtype=torch.float64,
                                        fast=False, device=dev)
        out[str(dev)] = (fem, {c.__name__: c.launches - n0[c.__name__]
                               for c in chip_smoke.counters()})
    (fc, lc), (fh, lh) = out[str(cuda)], out['cpu']
    for k in ('u', 'f', 'sgl'):
        a, b = getattr(fc, k), getattr(fh, k)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), k
    assert len(fh.sgl) == len(host.sgl)
    assert all(lc[k] > 0 for k in ('k_apply', 'svc_decision',
                                   'svc_f_grad_mm', 'svc_yf_root'))
    assert not any(lh.values())
