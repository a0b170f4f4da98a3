"""The plain reference against the program at tiny sizes on the CPU (the
test may import the program; the reference may not), and the work
functions of the rooflines against hand counts."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import roofline  # noqa: E402
from harness.manifest import Manifest  # noqa: E402
from reference import fe as rfe  # noqa: E402
from reference import judge  # noqa: E402
from reference import returnmap as rm  # noqa: E402

SVC = {'material': {'criterion': 'svc',
                    'svc_file': 'portbench/data/hill_ml_svc.npz'},
       'yf_tolerance': 5e-3}
J2 = {'material': {'criterion': 'j2', 'sy': 150., 'khard': 500.},
      'yf_tolerance': 5e-3}
CV = rm.elastic_stiffness(200.e3, 0.3)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_elastic_stiffness_is_the_program_s():
    from pylabfea_tpu_torch import convert
    assert np.allclose(CV, convert.elastic_cv(200.e3, 0.3), rtol=1e-14)
    with np.load(ROOT / SVC['material']['svc_file']) as z:
        assert np.allclose(CV, z['CV'], rtol=1e-12)


def stiffness(B, w, C):
    return sum(b.T @ C @ b for b in B) * w


def test_element_matrices_are_the_program_s():
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    from pylabfea_tpu_torch.ops import volume
    g2 = rfe.Grid((4, 3), (1., 0.6))
    Bp = fek._quad_B(*g2.h)
    assert np.allclose(g2.Bc.numpy(), Bp.sum(0), atol=1e-12)
    assert np.allclose(stiffness(g2.B.numpy(), g2.wgp, CV),
                       stiffness(Bp, g2.vel * 4., CV), rtol=1e-12)
    g3 = rfe.Grid((2, 3, 4), (1., 1.5, 0.7))
    Bh = volume.hex_B(*g3.h)
    assert np.allclose(g3.Bc.numpy(), Bh.mean(0), atol=1e-12)
    assert np.allclose(stiffness(g3.B.numpy(), g3.wgp, CV),
                       stiffness(Bh, g3.vel / 8., CV), rtol=1e-12)


def program_solve(n, cfg, dtype, rounds=None):
    """The program's load history; with a list ``rounds``, each round's
    (tangent, increment) of the 2-D path is appended to it."""
    from harness import instrument
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import fe3d
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    if len(n) == 2:
        mat = convert.material_from_npz(ROOT / cfg['material']['svc_file'],
                                        dtype=dtype, device='cpu')[0]
        md = fek.rect_mesh(*n, uniax='y', eps_tot=0.002, dtype=dtype,
                           device='cpu')
        patches = instrument.Patches()
        if rounds is not None:
            def keep(orig):
                def wrapper(md, state, mat, CV, du, *a, **k):
                    rounds.append((state.elstiff, du))
                    return orig(md, state, mat, CV, du, *a, **k)
                return wrapper
            patches.patch(Manifest(ROOT).config('hill_ml_2d')['last_round'],
                          keep)
        try:
            return fek.solve_uniaxial(md, mat, CV, nsteps=4, n_inner=2,
                                      dtype=dtype)
        finally:
            patches.restore()
    mat = convert.material_from_params(
        dict(hill=np.ones(6), sy=150., khard=500., drucker=0.),
        is_svc=False, dtype=dtype, device='cpu')
    md = fe3d.box_mesh(*n, uniax='z', eps_tot=0.002, dtype=dtype,
                       device='cpu')
    return fe3d.solve_uniaxial3(md, mat, CV, nsteps=4, n_inner=2,
                                dtype=dtype)


@pytest.mark.parametrize('n,cfg,cell', [
    ((16, 16), SVC, 'hill_ml_2d.solve_2048'),
    ((8, 8, 8), J2, 'j2_hex8_3d.solve_128')])
def test_the_judge_passes_the_program_s_solves(n, cfg, cell):
    limits = Manifest(ROOT).limits(cell)
    crit = rm.criterion_from(cfg, ROOT)
    grid = rfe.Grid(n, (1.,) * len(n))
    axis = len(n) - 1
    for dtype in (torch.float64, torch.float32):
        rounds = [] if len(n) == 2 else None
        state, hist = program_solve(n, cfg, dtype, rounds)
        last = None if rounds is None else dict(
            T_first=rounds[0][0], T_last=rounds[-1][0],
            du_last=rounds[-1][1])
        got = judge.judge_solve(grid, crit, CV, axis, 0.002, state.u,
                                state.sig, state.epl, state.eps,
                                hist[-1][0], last)
        assert set(limits) <= set(got)
        for k, lim in limits.items():
            assert got[k] <= lim, (dtype, k, got[k], lim)
        if dtype == torch.float64:
            assert got['identity'] < 1e-12 and got['bc'] < 1e-6
            assert got['strain'] < 1e-9
            if last is not None:
                assert got['start_tangent'] < 1e-15
                assert got['linear_residual'] < 1e-9


@pytest.mark.parametrize('n,cfg', [((16, 16), SVC), ((8, 8, 8), J2)])
def test_the_reference_solve_follows_the_program_s(n, cfg):
    """In float64 the reference's load history ends where the program's
    does: the same rounds, return map and tangent rule.  The two CG
    solvers (Jacobi against multigrid) stop at 1e-11 in different norms;
    on the SVC path, four large steps of three rounds leave the field far
    from equilibrium, and that difference reaches 2.6e-5 of the largest
    stress in a few elements at 16^2 (1e-5 MPa in most), so the 2-D
    comparison is held at 1e-4."""
    crit = rm.criterion_from(cfg, ROOT)
    grid = rfe.Grid(n, (1.,) * len(n))
    (u, sig, epl, eps), hist, last = rfe.solve_uniaxial(
        grid, crit, CV, len(n) - 1, 0.002, 4, 2, cg_maxiter=2000)
    state, phist = program_solve(n, cfg, torch.float64)
    rtol = 1e-4 if len(n) == 2 else 1e-6
    scale = float(sig.abs().max())
    assert float((sig - state.sig).abs().max()) <= rtol * scale
    assert float((hist[-1] - phist[-1][0]).abs().max()) <= rtol * scale
    assert float((u - state.u.reshape(-1)).abs().max()) <= rtol * float(
        u.abs().max())
    assert float((eps - state.eps).abs().max()) <= rtol * 0.002
    got = judge.linear_numbers(grid, CV, grid.uniaxial_bcs(len(n) - 1,
                                                           0.002)[0], **last)
    # its Jacobi-CG stops at 1e-11 of the lifted right-hand side's 2-norm
    assert got['start_tangent'] == 0. and got['linear_residual'] < 1e-7


@pytest.mark.parametrize('cfg', [SVC, J2])
def test_the_reference_return_map_is_the_program_s(cfg):
    from pylabfea_tpu_torch import convert
    from pylabfea_tpu_torch.ops import constitutive as con
    from harness import traffic
    crit = rm.criterion_from(cfg, ROOT)
    mix = {'pool': 1, 'states': 4096, 'radius': [0.55, 0.95],
           'deps_std': 2e-4 if cfg is J2 else 1e-4}
    sig0, epl0, deps = (t[0] for t in traffic.return_map_pool(
        mix, 2 ** 31 + 7, crit.sy, torch.float64, 'cpu'))
    if cfg is SVC:
        mat = convert.material_from_npz(ROOT / cfg['material']['svc_file'],
                                        dtype=torch.float64, device='cpu')[0]
    else:
        mat = convert.material_from_params(
            dict(hill=np.ones(6), sy=150., khard=500., drucker=0.),
            is_svc=False, dtype=torch.float64, device='cpu')
    C = torch.as_tensor(CV)
    f, sig, depl, tan = con.response_fast(mat, (sig0, epl0), deps, C, 12)
    fr, sr, dr, tr = rm.response(crit, sig0, epl0, deps, C, 12)
    plastic = (depl != 0).any(-1)
    assert 0.05 < float(plastic.double().mean()) < 0.95
    assert float((sig - sr).abs().max()) <= 1e-8 * crit.sy
    assert float((depl - dr).abs().max()) <= 1e-12
    assert float((f - fr).abs().max()) <= 1e-8
    assert float((tan - tr).abs().max()) <= 1e-6 * float(C.abs().max())
    got = judge.judge_return_map(crit, CV, sig0, epl0, deps, f, sig, depl,
                                 tan, 'cpu')
    assert got['identity'] < 1e-12 and got['yield_gap'] < 1e-10
    assert got['stress_gap'] < 1e-8 and got['depl_gap'] < 1e-8
    assert got['tangent_gap'] < 1e-6


def test_roofline_work_against_hand_counts():
    f32 = torch.float32
    Kp = torch.zeros((8, 8, 4, 3), dtype=f32)
    u = torch.zeros((5, 4), dtype=f32)
    # 8*8*12 stiffness values and 4 nodal planes of 20 values, 4 bytes
    assert roofline.kapply2d_work(Kp, u, u) == [
        ((768 + 80) * 4, 2 * 768, 4)]
    x = torch.zeros((10, 6), dtype=torch.float64)
    sv = torch.zeros((3, 6), dtype=torch.float64)
    # x and g 60 values each, f 10, sv 18 and dc 3; 34 operations a pair
    assert roofline.svc_fgrad_work(x, sv, sv[:, 0], 1., 0.) == [
        ((120 + 10 + 21) * 8, 10 * 3 * 34, 8)]
    assert roofline.svc_fgrad_work(x, sv, sv[:, 0], 1., 0., False) == [
        ((60 + 10 + 21) * 8, 10 * 3 * 22, 8)]
    Cp = torch.zeros((36, 2, 2, 2), dtype=f32)
    ub = torch.zeros((2, 3, 3, 3), dtype=f32)
    # two batch items: 288 tangents and 6 x 27 nodal values each
    assert roofline.kapply3d_work(Cp, ub, ub, ub, 1., 1., 1.) == [
        ((288 + 162) * 4, 612 * 8, 4)] * 2
    t, which = roofline.least_seconds(3.35e12, 1., 4)
    assert which == 'bytes' and abs(t - 1.) < 1e-12
    t, which = roofline.least_seconds(1., 67.e12, 4)
    assert which == 'operations' and abs(t - 1.) < 1e-12
