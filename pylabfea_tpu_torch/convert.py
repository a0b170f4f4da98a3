"""Carry parameters and state into the port as tensors.

The JAX package's device pytrees (``DeviceMaterial``, ``MeshData``,
``MeshData3D``, ``SolverState``, ``SolverState3``) cross over as dicts of
numpy arrays plus their static fields, so the port never imports JAX;
``material_from_npz`` reads a trained SVC yield function saved as ``.npz``:
the ``REF_SOLVE_svc.npz`` layout (support_vectors, dual_coef, intercept,
gamma, scale_seq, sy, CV, dev_only, eps), or every ``DeviceMaterial``
leaf under its own name with the static flags, CV and eps (the fixtures
under ``pylabfea_tpu_torch/data/``, which
``tools/make_torch_svc_fixtures.py`` trains with the JAX package).  A
multi-material model crosses as a tuple of materials
(``materials_from_params``) beside its tuple of elastic stiffnesses,
which the solvers take as numpy arrays.  ``material_to_npz`` writes a
material (an SVC the port trained, ``ml_train.train_svc``) in the fixture
layout, which ``material_from_npz`` reads back; ``theta_from_arrays``
carries a ``calibrate`` parameter dict and ``material_tree_from_params``
the output of a ``femu`` material builder (one material or a tuple).
Every function builds on the card unless ``device`` names another device.
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
    and the dummy SVC leaves; a truthy ``tresca`` key or a ``barlat`` or
    ``lhs`` key other than None/False marks criteria that have no device
    form.  ``sdim3`` (the Hill quadratic on principal stresses) applies to
    analytic materials; SVC materials take their feature layout from the
    shapes of ``sv`` and ``tex``."""
    if not is_svc:
        params = {'sv': np.zeros((1, 6)), 'dc': np.zeros(1), 'rho': 0.,
                  'gamma': 1., 'scale_seq': params['sy'], **params}
    sv = np.asarray(params['sv'])
    if is_svc:
        _check_svc_layout(sv, params)
    elif bool(params.get('tresca')) or any(
            params.get(k) is not None and params.get(k) is not False
            for k in ('barlat', 'lhs')):
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
        dev_only=bool(dev_only), sdim3=bool(sdim3),
        **{k: ten(np.ravel(params.get(k, np.zeros(0))))
           for k in ('feat_mean', 'feat_scale', 'tex')})


def _check_svc_layout(sv, params):
    """Raise for SVC features the JAX device path does not serve: 2
    (cylindrical), 6 (stress) and 15 (stress + work hardening) features,
    or with a texture descriptor of tdim values 6 + tdim or 15 + tdim,
    with a StandardScaler of as many."""
    tdim = np.size(params.get('tex', ()))
    nf = sv.shape[1] if sv.ndim == 2 else -1
    ok = nf in (2, 6, 15) if tdim == 0 else (
        nf in (6 + tdim, 15 + tdim)
        and np.size(params.get('feat_mean', ())) == nf
        and np.size(params.get('feat_scale', ())) == nf)
    if not ok:
        raise NotImplementedError(
            'device constitutive path supports cylindrical (Ndof=2), '
            'stress-only (Ndof=6), stress + work-hardening (Ndof=15) '
            f'or texture-scaled SVC features; got Ndof={nf}')


#: yield strength of a purely elastic material: far above any physical
#: stress, so its lanes stay on the elastic branch of the return map, and
#: finite in float32 through the masked plastic branch (whose
#: intermediates scale like its square)
ELASTIC_SY = 1.e15


def elastic_material(dtype=DTYPE_DEVICE, device=None):
    """An analytic DeviceMaterial that never yields (the JAX
    ``device_material_from`` of a material without plasticity)."""
    return material_from_params(dict(hill=np.ones(6), sy=ELASTIC_SY,
                                     khard=0., drucker=0.), is_svc=False,
                                dtype=dtype, device=device)


def elastic_cv(E, nu, planestress=False):
    """Isotropic elastic stiffness (6, 6) in Voigt notation, float64 numpy,
    as the host model computes it: the full 3-D tensor, or with
    ``planestress`` the reduced one of a plane-stress element (empty rows
    and columns 2, 3 and 4)."""
    hh = E / ((1. + nu) * (1. - 2. * nu))
    C44 = (0.5 - nu) * hh
    CV = np.zeros((6, 6))
    if planestress:
        hp = E / (1 - nu * nu)
        CV[0, 0] = CV[1, 1] = hp
        CV[0, 1] = CV[1, 0] = nu * hp
        CV[5, 5] = C44
        return CV
    CV[:3, :3] = nu * hh
    np.fill_diagonal(CV[:3, :3], (1. - nu) * hh)
    CV[3, 3] = CV[4, 4] = CV[5, 5] = C44
    return CV


def materials_from_params(items, dtype=DTYPE_DEVICE, device=None):
    """Tuple of DeviceMaterials, one for each dict of ``items``: the JAX
    ``DeviceMaterial._asdict()`` with its leaves as numpy arrays and its
    static flags ``is_svc``, ``dev_only``, ``sdim3`` (the material groups
    of a multi-material mesh, in group order)."""
    out = []
    for item in items:
        params = {k: v for k, v in item.items()
                  if k not in ('is_svc', 'dev_only', 'sdim3')}
        out.append(material_from_params(
            params, is_svc=bool(item['is_svc']),
            dev_only=bool(item.get('dev_only', False)),
            sdim3=bool(item.get('sdim3', False)), dtype=dtype,
            device=device))
    return tuple(out)


def material_from_npz(path, dtype=DTYPE_DEVICE, device=None):
    """The trained SVC material of an ``.npz`` file, uncompressed (every
    support vector kept), in either layout of the module docstring.
    Returns (DeviceMaterial, CV (6, 6) float64 numpy, total strain ``eps``
    of the workload)."""
    with np.load(path) as z:
        if 'sv' in z.files:
            params = {k: z[k] for k in z.files
                      if k not in ('is_svc', 'dev_only', 'sdim3', 'CV', 'eps',
                                   'tex_raw')}
            flags = dict(is_svc=bool(z['is_svc']),
                         dev_only=bool(z['dev_only']), sdim3=bool(z['sdim3']))
        else:
            params = dict(hill=np.ones(6), sy=float(z['sy']), khard=0.,
                          drucker=0., sv=z['support_vectors'],
                          dc=z['dual_coef'], rho=float(z['intercept']),
                          gamma=float(z['gamma']),
                          scale_seq=float(z['scale_seq']))
            flags = dict(is_svc=True, dev_only=bool(z['dev_only']))
        mat = material_from_params(params, **flags, dtype=dtype,
                                   device=device)
        return mat, np.asarray(z['CV'], dtype=np.float64), float(z['eps'])


_FLAGS = ('is_svc', 'dev_only', 'sdim3')
_TENSORS = ('hill', 'sv', 'dc', 'feat_mean', 'feat_scale', 'tex')
_FLOATS = ('sy', 'khard', 'drucker', 'rho', 'gamma', 'scale_seq',
           'scale_wh', 'voce_r', 'voce_b')


def material_params(mat):
    """The leaves of a DeviceMaterial as float64 numpy arrays under the
    JAX ``DeviceMaterial`` names, plus its static flags."""
    out = {k: np.asarray(getattr(mat, k).detach().cpu().double().numpy())
           for k in _TENSORS}
    out.update({k: np.float64(float(getattr(mat, k))) for k in _FLOATS})
    out.update({k: bool(getattr(mat, k)) for k in _FLAGS})
    return out


def material_to_npz(path, mat, CV, eps=0.):
    """Write a DeviceMaterial in the fixture layout that
    ``material_from_npz`` reads: every leaf under its own name, the
    static flags, the elastic stiffness ``CV`` and the workload strain
    ``eps``."""
    np.savez_compressed(path, **material_params(mat),
                        CV=np.asarray(CV, dtype=np.float64), eps=float(eps))


def theta_from_arrays(theta, dtype=DTYPE_DEVICE, device=None):
    """A ``calibrate`` parameter dict (log_sy, log_hill, raw_dsy, and as
    present raw_vr, log_vb_peeq, drucker, cv_raw) from numpy arrays to
    tensors."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                               device=device) for k, v in theta.items()}


def material_tree_from_params(tree, dtype=DTYPE_DEVICE, device=None):
    """The output of a ``femu`` material builder: one material's leaves
    as a dict of numpy arrays with its flags (the JAX
    ``DeviceMaterial._asdict()``), or a list or tuple of them (one per
    mesh group), as a DeviceMaterial or a tuple of them."""
    if isinstance(tree, dict):
        return materials_from_params([tree], dtype=dtype, device=device)[0]
    return materials_from_params(tree, dtype=dtype, device=device)


def _group_fields(arrays, groups, device):
    """perm, inv_perm (int64 tensors) and groups of a multi-material mesh's
    arrays, or Nones: single-material JAX meshes hold empty ``perm``
    arrays."""
    if groups is None:
        return dict(perm=None, inv_perm=None, groups=None)

    def idx(k):
        return torch.as_tensor(np.array(arrays[k]), dtype=torch.long,
                               device=device)

    return dict(perm=idx('perm'), inv_perm=idx('inv_perm'),
                groups=tuple((int(a), int(n)) for a, n in groups))


def mesh_from_arrays(arrays, grid, ndof, nel, groups=None,
                     dtype=DTYPE_DEVICE, device=None):
    """MeshData from the JAX ``MeshData`` leaves as numpy arrays (keys B,
    Bsum, jacw, vel, fixed, fixed_val, force; perm, inv_perm and ps_b2
    when present) and its static fields.  The float64 contraction matrix
    of the refinement residual comes from ``B`` and ``jacw`` as given, so
    float32 tables floor the refinement at their rounding."""
    if grid is None or np.ndim(arrays['B']) != 3:
        raise NotImplementedError('only structured 2-D grids are ported')
    device = resolve_device(device)

    def ten(k, dt=dtype):
        return torch.as_tensor(np.array(arrays[k]), dtype=dt, device=device)

    m64 = m64_matrix(arrays['B'], np.asarray(arrays['jacw']))
    ps_b2 = ten('ps_b2') if np.ndim(arrays.get('ps_b2', ())) == 3 else None
    return MeshData(B=ten('B'), Bsum=ten('Bsum'), jacw=ten('jacw'),
                    vel=ten('vel'), fixed=ten('fixed', torch.bool),
                    fixed_val=ten('fixed_val'), force=ten('force'),
                    ndof=int(ndof), nel=int(nel), grid=tuple(grid),
                    M64=torch.as_tensor(m64, dtype=torch.float64,
                                        device=device),
                    ps_b2=ps_b2, **_group_fields(arrays, groups, device))


def mesh3_from_arrays(arrays, grid, ndof, nel, groups=None,
                      dtype=DTYPE_DEVICE, device=None):
    """MeshData3D from the JAX ``MeshData3D`` leaves as numpy arrays (keys
    B, Bsum, jacw, vel, fixed, fixed_val, force; perm and inv_perm with
    ``groups``) and its static fields."""
    device = resolve_device(device)

    def ten(k, dt=dtype):
        return torch.as_tensor(np.array(arrays[k]), dtype=dt, device=device)

    return MeshData3D(B=ten('B'), Bsum=ten('Bsum'), jacw=ten('jacw'),
                      vel=ten('vel'), fixed=ten('fixed', torch.bool),
                      fixed_val=ten('fixed_val'), force=ten('force'),
                      ndof=int(ndof), nel=int(nel), grid=tuple(grid),
                      **_group_fields(arrays, groups, device))


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
