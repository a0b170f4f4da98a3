"""Carry parameters and state into the port as tensors.

The JAX package's device pytrees (``DeviceMaterial``, ``MeshData``,
``MeshData3D``, ``SolverState``, ``SolverState3``) cross over as dicts of
numpy arrays plus their static fields, so the port never imports JAX;
``material_from_npz`` reads a trained SVC yield function saved as ``.npz``
(the ``REF_SOLVE_svc.npz`` layout: support_vectors, dual_coef, intercept,
gamma, scale_seq, sy, CV, dev_only, eps).  Every function builds on the
card unless ``device`` names another device.
"""
import numpy as np
import torch

from pylabfea_tpu_torch.config import DTYPE_DEVICE, resolve_device
from pylabfea_tpu_torch.ops.constitutive import DeviceMaterial
from pylabfea_tpu_torch.ops.fe3d import MeshData3D, SolverState3
from pylabfea_tpu_torch.ops.fe_kernels import MeshData, SolverState, \
    m64_matrix


def material_from_params(params, is_svc, dev_only=False, sdim3=False,
                         dtype=DTYPE_DEVICE, device=None):
    """DeviceMaterial from the JAX ``DeviceMaterial`` leaves as numpy
    arrays (keys: hill, sy, khard, drucker, sv, dc, rho, gamma, scale_seq,
    and optionally scale_wh, feat_mean, feat_scale, tex, voce_r, voce_b)
    and its static flags.  Analytic materials (``is_svc=False``) take the
    leaves of the JAX ``device_material_from`` analytic branch: hill, sy,
    khard, drucker and optionally voce_r, voce_b, scale_seq (default sy)
    and the dummy SVC leaves; a truthy ``tresca``/``barlat`` key or an
    ``lhs`` key marks criteria that have no device form."""
    if not is_svc:
        params = {'sv': np.zeros((1, 6)), 'dc': np.zeros(1), 'rho': 0.,
                  'gamma': 1., 'scale_seq': params['sy'], **params}
    sv = np.asarray(params['sv'])
    if sdim3:
        raise NotImplementedError('sdim=3 (principal-space) materials are '
                                  'not ported yet')
    if is_svc:
        if sv.ndim != 2 or sv.shape[1] != 6:
            raise NotImplementedError('only 6-D stress SVC features are '
                                      f'ported (got sv {sv.shape})')
        if any(np.size(params.get(k, ())) for k in ('feat_mean',
                                                     'feat_scale', 'tex')):
            raise NotImplementedError('texture-conditioned SVC features are '
                                      'not ported yet')
    elif (params.get('tresca') or params.get('barlat')
          or params.get('lhs') is not None):
        raise NotImplementedError('Tresca, Barlat and LHS criteria have no '
                                  'device form (no analytic flow gradient)')
    device = resolve_device(device)

    def ten(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    def num(k, default=None):
        return float(np.asarray(params.get(k, default)))

    return DeviceMaterial(
        hill=ten(params['hill']), sv=ten(sv), dc=ten(params['dc']),
        sy=num('sy'), khard=num('khard'), drucker=num('drucker'),
        rho=num('rho'), gamma=num('gamma'), scale_seq=num('scale_seq'),
        scale_wh=num('scale_wh', 1.), voce_r=num('voce_r', 0.),
        voce_b=num('voce_b', 1.), is_svc=bool(is_svc),
        dev_only=bool(dev_only))


def material_from_npz(path, dtype=DTYPE_DEVICE, device=None):
    """The trained SVC material of an ``.npz`` file, uncompressed (every
    support vector kept).  Returns (DeviceMaterial, CV (6, 6) float64
    numpy, total strain ``eps`` of the workload)."""
    with np.load(path) as z:
        sy = float(z['sy'])
        params = dict(hill=np.ones(6), sy=sy, khard=0., drucker=0.,
                      sv=z['support_vectors'], dc=z['dual_coef'],
                      rho=float(z['intercept']), gamma=float(z['gamma']),
                      scale_seq=float(z['scale_seq']))
        mat = material_from_params(params, is_svc=True,
                                   dev_only=bool(z['dev_only']), dtype=dtype,
                                   device=device)
        return mat, np.asarray(z['CV'], dtype=np.float64), float(z['eps'])


def mesh_from_arrays(arrays, grid, ndof, nel, groups=None,
                     dtype=DTYPE_DEVICE, device=None):
    """MeshData from the JAX ``MeshData`` leaves as numpy arrays (keys B,
    Bsum, jacw, vel, fixed, fixed_val, force; ps_b2 when present) and its
    static fields.  The float64 contraction matrix of the refinement
    residual comes from ``B`` and ``jacw`` as given, so float32 tables
    floor the refinement at their rounding."""
    if grid is None or np.ndim(arrays['B']) != 3:
        raise NotImplementedError('only structured 2-D grids are ported')
    if groups is not None or np.ndim(arrays.get('ps_b2', ())) == 3:
        raise NotImplementedError('multi-material meshes are not ported yet')
    device = resolve_device(device)

    def ten(k, dt=dtype):
        return torch.as_tensor(np.array(arrays[k]), dtype=dt, device=device)

    m64 = m64_matrix(arrays['B'], np.asarray(arrays['jacw']))
    return MeshData(B=ten('B'), Bsum=ten('Bsum'), jacw=ten('jacw'),
                    vel=ten('vel'), fixed=ten('fixed', torch.bool),
                    fixed_val=ten('fixed_val'), force=ten('force'),
                    ndof=int(ndof), nel=int(nel), grid=tuple(grid),
                    M64=torch.as_tensor(m64, dtype=torch.float64,
                                        device=device))


def mesh3_from_arrays(arrays, grid, ndof, nel, groups=None,
                      dtype=DTYPE_DEVICE, device=None):
    """MeshData3D from the JAX ``MeshData3D`` leaves as numpy arrays (keys
    B, Bsum, jacw, vel, fixed, fixed_val, force; perm/inv_perm are ignored)
    and its static fields."""
    if groups is not None:
        raise NotImplementedError('multi-material meshes are not ported yet')
    device = resolve_device(device)

    def ten(k, dt=dtype):
        return torch.as_tensor(np.array(arrays[k]), dtype=dt, device=device)

    return MeshData3D(B=ten('B'), Bsum=ten('Bsum'), jacw=ten('jacw'),
                      vel=ten('vel'), fixed=ten('fixed', torch.bool),
                      fixed_val=ten('fixed_val'), force=ten('force'),
                      ndof=int(ndof), nel=int(nel), grid=tuple(grid))


def _state_tensors(arrays, dtype, device):
    device = resolve_device(device)
    return {k: torch.as_tensor(np.array(arrays[k]), dtype=dtype,
                               device=device)
            for k in ('u', 'sig', 'epl', 'eps', 'elstiff')}


def state_from_arrays(arrays, dtype=DTYPE_DEVICE, device=None):
    """SolverState from numpy arrays u (2, nnX, nnY), sig/epl/eps (Nel, 6)
    and elstiff in planes layout (36, NX, NY)."""
    els = np.shape(arrays['elstiff'])
    if len(els) != 3 or els[0] != 36:
        raise ValueError('elstiff must be in planes layout (36, NX, NY)')
    return SolverState(**_state_tensors(arrays, dtype, device))


def state3_from_arrays(arrays, dtype=DTYPE_DEVICE, device=None):
    """SolverState3 from numpy arrays u (3, nnX, nnY, nnZ), sig/epl/eps
    (Nel, 6) and elstiff in volumes layout (36, NX, NY, NZ)."""
    els = np.shape(arrays['elstiff'])
    if len(els) != 4 or els[0] != 36:
        raise ValueError('elstiff must be in volumes layout (36, NX, NY, NZ)')
    return SolverState3(**_state_tensors(arrays, dtype, device))
