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

A host ``Material`` (the port's ``materials.Material``, the JAX package's,
or any object with its attributes) crosses as a *material record*, a dict of numpy values
that ``material_record`` reads from the object's attributes, without
importing its package: the parameters of ``device_material_from``
(the JAX ``constitutive.device_material_from``) and those of the host
methods that the bridge replays on the device (``calc_seq``,
``_yf_rows``, ``_sflow_rows``, ``_ml_full_yf_rows``).  ``compress_record``
adds a reduced-set compression of its SVC (``ops.svc.reduce_svc``);
``material_from_record`` builds the DeviceMaterial.
"""
import numpy as np
import torch

from pylabfea_tpu_torch.config import DTYPE_DEVICE, resolve_device, \
    yf_tolerance
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


# -----------------------------------------------------------------
# host materials: records, compression, DeviceMaterial
# -----------------------------------------------------------------
def _opt(v, default):
    return default if v is None else v


def material_record(mat, tex=None):
    """The material record of a host ``Material``, read by its attributes:
    elastic constants (E, nu, C44), the analytic law (sy, or NaN for an
    elastic material; khard, drucker, Voce, the host ``hill`` as it is with
    ``hill_6p``, sdim, lhs, the tresca and barlat flags) and, for an ML
    yield function (``ML_yf``), its SVC (sv, dc, rho, gamma), feature
    scales, ``dev_only`` and, for a texture-trained one, the fitted
    StandardScaler and the fixed descriptor ``tex`` in feature form (a
    PCA-whitened ADV descriptor through the object's own
    ``pca.transform``; the stress and work-hardening columns keep the
    scaler).  Raises for a texture material without ``tex``."""
    sy = getattr(mat, 'sy', None)
    hill = np.ones(3) if getattr(mat, 'hill', None) is None \
        else np.asarray(mat.hill, float)
    lhs = getattr(mat, 'lhs', None)
    rec = dict(
        E=float(_opt(getattr(mat, 'E', None), np.nan)),
        nu=float(_opt(getattr(mat, 'nu', None), np.nan)),
        C44=float(_opt(getattr(mat, 'C44', None), np.nan)),
        sy=np.nan if sy is None else float(sy),
        khard=float(_opt(getattr(mat, 'khard', None), 0.)),
        drucker=float(_opt(getattr(mat, 'drucker', None), 0.)),
        voce_r=float(_opt(getattr(mat, 'voce_r', None), 0.)),
        voce_b=float(_opt(getattr(mat, 'voce_b', None), 1.)),
        hill=hill, hill_6p=bool(getattr(mat, 'hill_6p', False)),
        sdim=int(_opt(getattr(mat, 'sdim', None), 0)),
        lhs=np.zeros(0) if lhs is None else np.asarray(lhs, float),
        tresca=bool(getattr(mat, 'tresca', False)),
        barlat=bool(getattr(mat, 'barlat', False)),
        ML_yf=bool(getattr(mat, 'ML_yf', False)))
    if not rec['ML_yf']:
        return rec
    p = mat._svc
    rec.update(sv=np.asarray(p.support_vectors, float),
               dc=np.asarray(p.dual_coef, float),
               rho=float(p.intercept), gamma=float(p.gamma),
               scale_seq=float(mat.scale_seq),
               scale_wh=float(getattr(mat, 'scale_wh', None) or 1.),
               dev_only=bool(getattr(mat, 'dev_only', False)))
    if bool(getattr(mat, 'txdat', False)):
        if tex is None:
            raise ValueError('texture-conditioned material: pass the fixed '
                             'texture descriptor via tex=')
        tx_raw = np.asarray(tex, dtype=float)
        mean = np.asarray(mat.std_scaler.mean_, float)
        scale = np.asarray(mat.std_scaler.scale_, float)
        pca = getattr(mat, 'pca', None)
        if pca is not None and 'ADV' in mat.msparam[0]['tx_descriptor']:
            ind_tx = mat.ind_tx
            tx_feat = np.asarray(pca.transform(tx_raw[None, :]), float)[0]
            mean = np.concatenate([mean[:ind_tx], np.zeros(tx_feat.size)])
            scale = np.concatenate([scale[:ind_tx], np.ones(tx_feat.size)])
            tx_raw = tx_feat
        rec.update(feat_mean=mean, feat_scale=scale, tex=tx_raw)
    return rec


def material_record_from(E, nu, sy=None, khard=0., hill=None, drucker=0.,
                         voce_r=0., voce_b=1., sdim=6, svc=None,
                         scale_seq=None, scale_wh=1., dev_only=False):
    """The material record of a host ``Material`` made by ``elasticity(E=E,
    nu=nu)`` and, with ``sy``, ``plasticity(sy=sy, khard=khard, hill=hill,
    drucker=drucker, voce_r=voce_r, voce_b=voce_b, sdim=sdim)`` (hill ones
    by default, ``hill_6p`` for six parameters), built from arrays;
    ``svc`` (a dict of sv, dc, rho, gamma) makes it an ML yield function
    with features over ``scale_seq`` (sy by default), as ``train_SVC``
    leaves a material trained on an sdim=6 reference."""
    hill = np.ones(sdim) if hill is None else np.asarray(hill, float)
    hh = E / ((1. + nu) * (1. - 2. * nu))
    rec = dict(E=float(E), nu=float(nu), C44=float((0.5 - nu) * hh),
               sy=np.nan if sy is None else float(sy), khard=float(khard),
               drucker=float(drucker), voce_r=float(voce_r),
               voce_b=float(voce_b), hill=hill, hill_6p=hill.size == 6,
               sdim=int(sdim), lhs=np.zeros(0), tresca=False, barlat=False,
               ML_yf=svc is not None)
    if svc is not None:
        rec.update(sv=np.asarray(svc['sv'], float),
                   dc=np.asarray(svc['dc'], float), rho=float(svc['rho']),
                   gamma=float(svc['gamma']),
                   scale_seq=float(sy if scale_seq is None else scale_seq),
                   scale_wh=float(scale_wh), dev_only=bool(dev_only))
    return rec


def _compress_spec(compress):
    """The cache key of a ``compress`` spec: 'auto' for True, else its
    repr (an int and a float of one value are different specs)."""
    return 'auto' if isinstance(compress, bool) or compress == 'auto' \
        else repr(compress)


def resolve_compress(params, compress, device=None):
    """Reduced-set compression of SVCParams per the ``compress`` spec (the
    JAX ``_resolve_compress``): True/'auto' = absolute decision-function
    error budget of 10 % of the yield-tolerance band, a float = that
    absolute bound, an int = the center count (bool checked before int).
    Returns (reduced params, relative RKHS error)."""
    from pylabfea_tpu_torch.ops.svc import reduce_svc
    if isinstance(compress, bool) or compress == 'auto':
        if not compress:
            return params, 0.
        return reduce_svc(params, abs_tol=0.1 * yf_tolerance, device=device)
    if isinstance(compress, int):
        return reduce_svc(params, n_out=compress, device=device)
    return reduce_svc(params, abs_tol=float(compress), device=device)


def compress_record(rec, compress, device=None):
    """The record with its SVC compressed per ``compress`` (in
    ``sv_red``, ``dc_red``, with ``compress_spec`` and the achieved
    relative RKHS error ``compress_rel``; the raw ``sv``/``dc`` stay), on
    ``device`` (the card unless given).  A record already compressed under
    the same spec, an analytic record or a falsy ``compress`` is returned
    as it is."""
    from pylabfea_tpu_torch.ops.svc import SVCParams
    if not compress or not rec.get('ML_yf'):
        return rec
    spec = _compress_spec(compress)
    if str(rec.get('compress_spec', '')) == spec:
        return rec
    red, rel = resolve_compress(
        SVCParams(rec['sv'], rec['dc'], float(rec['rho']),
                  float(rec['gamma'])), compress, device)
    return dict(rec, sv_red=np.asarray(red.support_vectors, float),
                dc_red=np.asarray(red.dual_coef, float),
                compress_spec=spec, compress_rel=float(rel))


def compress_host(mat, rec, compress, device=None):
    """``compress_record`` through the host material's cache
    (``mat._svc_reduced``, the JAX convention): a hit needs the same spec
    and the same ``mat._svc`` object (retraining replaces it, and a stale
    reduced set would be a wrong yield surface); sets
    ``mat.svc_compress_rel``."""
    from pylabfea_tpu_torch.ops.svc import SVCParams
    if not compress or not rec.get('ML_yf'):
        return rec
    spec = _compress_spec(compress)
    cached = getattr(mat, '_svc_reduced', None)
    if cached is not None and cached[0] == spec and cached[3] is mat._svc:
        p, rel = cached[1], cached[2]
        rec = dict(rec, sv_red=np.asarray(p.support_vectors, float),
                   dc_red=np.asarray(p.dual_coef, float),
                   compress_spec=spec, compress_rel=float(rel))
    else:
        rec = compress_record(rec, compress, device)
        mat._svc_reduced = (spec, SVCParams(
            rec['sv_red'], rec['dc_red'], float(rec['rho']),
            float(rec['gamma'])), rec['compress_rel'], mat._svc)
    mat.svc_compress_rel = rec['compress_rel']
    return rec


def material_from_record(rec, dtype=DTYPE_DEVICE, device=None):
    """The DeviceMaterial of a material record, as the JAX
    ``device_material_from`` builds it: an ML material with its SVC (the
    compressed one where the record holds it) and hill ones; an elastic
    one (sy NaN) with the ``ELASTIC_SY`` sentinel; an analytic one with
    its hill padded to six by ones and sdim=3 semantics.  Tresca, Barlat
    and LHS raise (no device form)."""
    if rec['ML_yf']:
        red = 'sv_red' in rec
        params = dict(hill=np.ones(6), sy=float(rec['sy']),
                      khard=float(rec['khard']), drucker=0.,
                      sv=rec['sv_red'] if red else rec['sv'],
                      dc=rec['dc_red'] if red else rec['dc'],
                      rho=float(rec['rho']), gamma=float(rec['gamma']),
                      scale_seq=float(rec['scale_seq']),
                      scale_wh=float(rec['scale_wh']))
        for k in ('feat_mean', 'feat_scale', 'tex'):
            if k in rec:
                params[k] = rec[k]
        return material_from_params(params, is_svc=True,
                                    dev_only=bool(rec['dev_only']),
                                    dtype=dtype, device=device)
    if np.isnan(float(rec['sy'])):
        return elastic_material(dtype=dtype, device=device)
    if rec['tresca'] or rec['barlat'] or np.size(rec['lhs']):
        raise NotImplementedError(
            'device constitutive path: Tresca/Barlat/LHS analytic criteria '
            'run on the host profile (no analytic flow gradient)')
    hill = np.ones(6)
    hill[:np.size(rec['hill'])] = rec['hill']
    return material_from_params(
        dict(hill=hill, sy=float(rec['sy']), khard=float(rec['khard']),
             drucker=float(rec['drucker']), voce_r=float(rec['voce_r']),
             voce_b=float(rec['voce_b'])), is_svc=False,
        sdim3=int(rec['sdim']) == 3, dtype=dtype, device=device)


def device_material_from(mat, dtype=DTYPE_DEVICE, tex=None, compress=None,
                         device=None):
    """DeviceMaterial from a host ``Material`` (the JAX
    ``constitutive.device_material_from``), read by its attributes
    (``material_record``).  ``compress`` (SVC materials) serves a
    reduced-set compression: True/'auto' bounds the absolute
    decision-function error at 10 % of the yield-tolerance band, a float
    sets that bound, an int the center count; the reduction is cached on
    the host material (``compress_host``) and its relative RKHS error set
    as ``mat.svc_compress_rel``; the host SVC stays untouched.  Builds on
    the card unless ``device`` names another device (the compression runs
    there too)."""
    rec = compress_host(mat, material_record(mat, tex), compress, device)
    return material_from_record(rec, dtype=dtype, device=device)
