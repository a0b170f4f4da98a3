"""The multi-material and plane-stress workloads of ``bench.py`` and the
reference's tests, built with the port's constructors (``chip_smoke.py``
phases 10-12 and ``profile_step --inclusion`` run them).

Each builder returns (mesh, tuple of materials, tuple of elastic
stiffnesses) on ``device`` in ``dtype``.
"""
import os

import numpy as np

from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import fe3d
from pylabfea_tpu_torch.ops import fe_kernels as fek

#: the trained Hill-ML SVC of the REF_SOLVE problem
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'REF_SOLVE_svc.npz')
#: yield strength of the plastic materials (MPa)
SY = 150.
#: bench.py's inclusion BCs at LX = LY = 4: bottom and top displaced
#: (0.002 of LY), lateral edges free, the corner node pinned in x
INCL_BC = {'bot': {1: ('disp', 0.)}, 'left': {}, 'right': {},
           'top': {1: ('disp', 0.002 * 4.)},
           'nodes': ((0, 0, 0, 'disp', 0.),)}
#: the laminate (reference tests/test_basic.py:84-103): section widths,
#: (E, nu) of its two materials and the Voigt average of E
LAM_WIDTHS = (2., 1., 2., 1., 2.)
LAM_MATS = ((100.e3, 0.35), (300.e3, 0.3))
LAM_VOIGT = (100.e3 * 6. + 300.e3 * 2.) / 8.


def inclusion_map(N):
    """bench.py's 3-material layout: Hill (0) below, J2 (1) above, a soft
    elastic square (2) across the middle third."""
    mat_map = np.zeros((N, N), dtype=int)
    mat_map[N // 2:, :] = 1
    mat_map[N // 3: 2 * N // 3, N // 3: 2 * N // 3] = 2
    return mat_map


def inclusion_case(N, dtype, device):
    """bench.py's ``step_s_1024_inclusion`` workload at N x N
    (``bench.py:366-392``): Hill [0.7, 1, 1.4, 1, 1, 1] sdim=6 and J2
    sdim=3 (sy 150 MPa, E 200 GPa, nu 0.3) and an elastic E = 1e3, nu =
    0.27 inclusion over LX = LY = 4."""
    md = fek.rect_mesh(N, N, LX=4., LY=4., bc=INCL_BC,
                       mat_map=inclusion_map(N), dtype=dtype, device=device)
    return (md,) + inclusion_materials(dtype, device)


def inclusion_materials(dtype, device):
    """The three materials of ``inclusion_case`` and their elastic
    stiffnesses: (tuple of materials, tuple of CVs)."""
    hill = convert.material_from_params(
        dict(hill=[0.7, 1., 1.4, 1., 1., 1.], sy=SY, khard=0., drucker=0.),
        is_svc=False, dtype=dtype, device=device)
    j2 = convert.material_from_params(
        dict(hill=np.ones(6), sy=SY, khard=0., drucker=0.), is_svc=False,
        sdim3=True, dtype=dtype, device=device)
    mats = (hill, j2, convert.elastic_material(dtype, device))
    cv = convert.elastic_cv(200.e3, 0.3)
    return mats, (cv, cv, convert.elastic_cv(1.e3, 0.27))


def laminate_case(NX, NY, dtype, device):
    """The reference's plane-stress laminate on NX x NY elements over
    LX = 8, LY = 4: left and bottom fixed, right face force-free, top
    displaced 0.1 LY."""
    xc = (np.arange(NX) + 0.5) * sum(LAM_WIDTHS) / NX
    sec = np.searchsorted(np.cumsum(LAM_WIDTHS), xc)
    CVs = tuple(convert.elastic_cv(E, nu, True) for E, nu in LAM_MATS)
    md = fek.rect_mesh(
        NX, NY, LX=sum(LAM_WIDTHS), LY=4.,
        mat_map=np.repeat((sec % 2)[:, None], NY, axis=1), planestress=True,
        ps_CV=CVs, ps_E=tuple(E for E, _ in LAM_MATS),
        ps_nu=tuple(nu for _, nu in LAM_MATS),
        bc=dict(left={0: ('disp', 0.)}, bot={1: ('disp', 0.)},
                right={0: ('force', 0.)}, top={1: ('disp', 0.4)}),
        dtype=dtype, device=device)
    return md, (convert.elastic_material(dtype, device),) * 2, CVs


def box_inclusion_case(N, dtype, device):
    """bench.py's 3-D inclusion (``bench.py:479-526``): a stiff elastic
    cube (E = 600e3) at [3N/8, 5N/8)^3 in a J2 + khard 500 matrix, pulled
    to 0.002 in z."""
    mm = np.zeros((N, N, N), np.int32)
    lo, hi = 3 * N // 8, 5 * N // 8
    mm[lo:hi, lo:hi, lo:hi] = 1
    md = fe3d.box_mesh(N, N, N, uniax='z', eps_tot=0.002, mat_map=mm,
                       dtype=dtype, device=device)
    j2 = convert.material_from_params(
        dict(hill=np.ones(6), sy=SY, khard=500., drucker=0.), is_svc=False,
        dtype=dtype, device=device)
    mats = (j2, convert.elastic_material(dtype, device))
    return md, mats, (convert.elastic_cv(200.e3, 0.3),
                      convert.elastic_cv(600.e3, 0.3))


def svc_elastic_case(N, dtype, device):
    """A two-group N x N mesh: the trained SVC, with an elastic inclusion
    (E = 1e3) of odd area in the upper half, so both group blocks are of
    odd size; uniaxial y to the SVC's workload strain."""
    mat, CV, eps = convert.material_from_npz(NPZ, dtype=dtype, device=device)
    mat_map = np.zeros((N, N), dtype=int)
    mat_map[N // 2 + 1:N - 2, 3:N - 4] = 1
    md = fek.rect_mesh(N, N, LX=1., LY=1., uniax='y', eps_tot=eps,
                       mat_map=mat_map, dtype=dtype, device=device)
    return md, (mat, convert.elastic_material(dtype, device)), \
        (CV, convert.elastic_cv(1.e3, 0.27))
