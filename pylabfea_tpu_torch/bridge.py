"""Bridge between a host ``Model`` / ``Material`` (the port's own
``femodel.Model`` / ``materials.Material``, the JAX package's host
profile, or any object with their attributes) and the port's device solver
(the counterpart of ``pylabfea_tpu.bridge``).

The host objects are touched only at the two ends:

* **reading** (``read_model``, ``convert.material_record``): the host
  attributes become a *model record*, a dict of numpy values (grid,
  lengths, thickness, plane stress, the BC flags and values, the node set,
  per-element material ids, each material's record and elastic
  stiffness, and for a solved model the resume state).  ``grid_record``
  builds the same record from arrays, ``save_record`` / ``load_record``
  carry it through ``.npz``, so the same solvers run without a host
  ``Model``;
* **solving** (``solve_record``, ``solve_record_adaptive``,
  ``properties_record``): everything between runs on tensors on the
  device, the host methods the JAX bridge calls (``calc_seq``,
  ``_yf_rows``, ``_sflow_rows``, ``_ml_full_yf_rows``) replayed as the
  port's own device functions (``HostLaw``) from the record's parameters;
* **writing back** (``write_back``, ``write_properties``): the results
  go into the host objects in one place.

The five entry points of the JAX bridge keep their names, arguments and
defaults (``dtype`` a torch dtype, plus ``device``; ``device=None`` is the
card): ``to_device``, ``to_device_1d``, ``solve_on_device`` (serving SVC
materials through the reduced-set compression, ``compress='auto'``),
``solve_on_device_adaptive`` and ``calc_properties_on_device``; each is
read -> solve on the record -> write back.

Constraints of the 2-D device path (checked, with clear errors): a
meshed structured grid of uniform linear quads.
"""
import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.config import resolve_device, yf_tolerance
from pylabfea_tpu_torch.femodel import _halve_increment
from pylabfea_tpu_torch.ops import constitutive as con
from pylabfea_tpu_torch.ops import fe_kernels as fek
from pylabfea_tpu_torch.ops import jtensors as jt
from pylabfea_tpu_torch.ops import stencil as st
from pylabfea_tpu_torch.ops import svc_kernels as sk

#: marching steps a direction of the host's fixed-direction root find
#: (``Material._ml_full_yf_rows``); ``ml_yf_dist`` keeps kernel G's 400
HOST_MAXMARCH = 2000


# -----------------------------------------------------------------
# the reading end
# -----------------------------------------------------------------
def _check_supported(model):
    if model.dim != 2:
        raise ValueError('device solver bridge supports 2-D models only')
    if model.Nnode is None:
        raise ValueError('mesh the model before converting')
    if model.shapefact != 1:
        raise ValueError('device solver bridge supports linear elements')
    lx = {round(el.Lelx, 12) for el in model.element}
    ly = {round(el.Lely, 12) for el in model.element}
    if len(lx) != 1 or len(ly) != 1:
        raise ValueError('device solver bridge requires a uniform mesh')
    if model.Nel != (model.NnodeX - 1) * (model.NnodeY - 1):
        raise ValueError('device solver bridge requires a full structured '
                         'grid')


def _material_groups(model):
    """(materials, per-element group ids) in element raster order."""
    mats = []
    ids = np.empty(model.Nel, dtype=np.int64)
    by_id = {}
    for i, el in enumerate(model.element):
        k = by_id.setdefault(id(el.Mat), len(by_id))
        if k == len(mats):
            mats.append(el.Mat)
        ids[i] = k
    return mats, ids


def _read_materials(model, ids, mats, compress, tex, device):
    """Material records (compressed through the host cache) and the first
    element's stiffness of each group."""
    recs = [convert.compress_host(m, convert.material_record(m, tex),
                                  compress, device) for m in mats]
    first = {}
    for i, el in enumerate(model.element):
        first.setdefault(int(ids[i]), np.asarray(el.CV, float))
    return recs, [first[k] for k in range(len(mats))]


def _flags(v):
    return np.array([bool(x) for x in v])


def read_model(model, compress=None, tex=None, device=None):
    """The model record of a meshed host ``Model``, read by its
    attributes (2-D structured grids and 1-D bars).  ``compress`` applies
    the reduced-set compression to its SVC materials through the host
    material's cache (on ``device``); a model with displacements also
    carries its resume state: ``u``, the element ``sig``/``eps``/``epl``/
    ``elstiff`` and the BC memory ``bc{r,t,n}_mem``."""
    if model.dim == 1:
        return _read_model_1d(model, compress, tex, device)
    _check_supported(model)
    mats, ids = _material_groups(model)
    recs, CVs = _read_materials(model, ids, mats, compress, tex, device)
    rec = dict(dim=2, NX=model.NnodeX - 1, NY=model.NnodeY - 1,
               lenx=float(model.lenx), leny=float(model.leny),
               thick=float(model.thick), planestress=bool(model.planestress),
               ids=ids, materials=recs, CVs=CVs)
    for side in ('left', 'bot', 'right', 'top'):
        rec['bc' + side[0]] = np.asarray(getattr(model, 'bc' + side[0]),
                                         float)
        rec['ubc' + side] = _flags(getattr(model, 'ubc' + side))
    rec['bcn'] = np.asarray(model.bcn, float)
    rec['ubcn'] = _flags(model.ubcn)
    if model.noset is not None:
        rec['noset'] = np.array([int(np.ravel(j)[0]) for j in model.noset],
                                dtype=np.int64)
    if model.u is not None:
        rec.update(_read_state(model))
    return rec


def _read_state(model):
    """The resume state of a solved host model: displacements, the stored
    element states and tangents (``el.elstiff``: the host keeps the
    self-consistent plastic tangents across solve() calls, the device
    write-back leaves them as they were) and the BC memory."""
    out = dict(u=np.asarray(model.u, float))
    for k in ('sig', 'eps', 'epl', 'elstiff'):
        out[k] = np.array([getattr(el, k) for el in model.element], float)
    for k in ('bcr_mem', 'bct_mem'):
        out[k] = np.asarray(getattr(model, k), float)
    if model.noset is not None:
        out['bcn_mem'] = np.asarray(model.bcn_mem, float)
    return out


def _read_model_1d(model, compress, tex, device):
    if model.Nnode is None:
        raise ValueError('mesh the model before converting')
    els = model.element
    mats, ids = _material_groups(model)
    recs, CVs = _read_materials(model, ids, mats, compress, tex, device)
    return dict(
        dim=1, dofs=np.array([el.nodes for el in els], dtype=np.int64),
        B=np.stack([np.stack(el.Bmat) for el in els]).astype(float),
        jacw=np.array([el.Jac * el.wght for el in els], float),
        Bsum=np.array([el.wght * sum(el.Bmat) for el in els], float),
        vel=np.array([el.Vel for el in els], float), ndof=int(model.Ndof),
        noleft=np.atleast_1d(np.asarray(model.noleft, np.int64)),
        noright=np.atleast_1d(np.asarray(model.noright, np.int64)),
        bcl=np.asarray(model.bcl, float), bcr=np.asarray(model.bcr, float),
        ubcleft=_flags(model.ubcleft), ubcright=_flags(model.ubcright),
        ids=ids, materials=recs, CVs=CVs)


def grid_record(NX, NY, materials, CVs, LX=1., LY=1., thick=1.,
                planestress=False, ids=None, bcl=(0., 0.),
                ubcleft=(True, False), bcb=(0., 0.), ubcbot=(False, True),
                bcr=(0., 0.), ubcright=(False, False), bct=(0., 0.),
                ubctop=(False, False), noset=None, bcn=(0., 0.),
                ubcn=(False, False)):
    """The model record of an NX x NY grid built from arrays, without a
    host ``Model``: ``materials`` the material records, ``CVs`` their
    elastic stiffnesses, ``ids`` (NX * NY,) the material of each element
    in raster order (elem = column * NY + row; all 0 by default), and the
    host ``Model``'s BC attributes with its defaults (left fixed in x,
    bottom in y, right and top force-free)."""
    return dict(dim=2, NX=int(NX), NY=int(NY), lenx=float(LX),
                leny=float(LY), thick=float(thick),
                planestress=bool(planestress),
                ids=np.zeros(NX * NY, np.int64) if ids is None
                else np.asarray(ids, np.int64).reshape(-1),
                materials=list(materials),
                CVs=[np.asarray(c, float) for c in CVs],
                bcl=np.asarray(bcl, float), ubcleft=_flags(ubcleft),
                bcb=np.asarray(bcb, float), ubcbot=_flags(ubcbot),
                bcr=np.asarray(bcr, float), ubcright=_flags(ubcright),
                bct=np.asarray(bct, float), ubctop=_flags(ubctop),
                bcn=np.asarray(bcn, float), ubcn=_flags(ubcn),
                **({} if noset is None else
                   dict(noset=np.asarray(noset, np.int64).reshape(-1))))


def save_record(path, rec, **extra):
    """Write a model record (and ``extra`` arrays) to ``.npz``: each
    material record's values under ``m<k>.<name>``, the stiffnesses as
    ``CV<k>``."""
    flat = {k: v for k, v in rec.items() if k not in ('materials', 'CVs')}
    flat['nmat'] = len(rec['materials'])
    for k, (m, C) in enumerate(zip(rec['materials'], rec['CVs'])):
        flat.update({f'm{k}.{n}': v for n, v in m.items()})
        flat[f'CV{k}'] = np.asarray(C, float)
    flat.update(extra)
    np.savez_compressed(path, **flat)


def _value(a):
    a = np.asarray(a)
    return a.item() if a.ndim == 0 else a


def load_record(path):
    """The model record of ``save_record`` (with its extra arrays as
    top-level keys).  Raises if the file lacks a field the solvers read."""
    with np.load(path) as z:
        flat = {k: _value(z[k]) for k in z.files}
    nmat = int(flat.pop('nmat'))
    rec = {k: v for k, v in flat.items()
           if not (k.startswith('m') and '.' in k)
           and not (k.startswith('CV') and k[2:].isdigit())}
    rec['materials'] = [
        {k.split('.', 1)[1]: v for k, v in flat.items()
         if k.startswith(f'm{i}.')} for i in range(nmat)]
    rec['CVs'] = [np.asarray(flat[f'CV{i}'], float) for i in range(nmat)]
    need = (('dim', 'ids') + (('NX', 'NY', 'lenx', 'leny', 'thick',
                               'planestress', 'bcl', 'bcb', 'bcr', 'bct',
                               'ubcleft', 'ubcbot', 'ubcright', 'ubctop',
                               'bcn', 'ubcn')
                              if rec.get('dim') == 2 else
                              ('dofs', 'B', 'jacw', 'Bsum', 'vel', 'ndof',
                               'noleft', 'noright', 'bcl', 'bcr', 'ubcleft',
                               'ubcright')))
    missing = [k for k in need if k not in rec]
    for m in rec['materials']:
        missing += [k for k in ('ML_yf', 'E', 'nu', 'sy', 'khard', 'hill',
                                'hill_6p', 'sdim', 'drucker', 'lhs')
                    if k not in m]
    if missing:
        raise KeyError(f'{path}: model record lacks {sorted(set(missing))}')
    return rec


# -----------------------------------------------------------------
# the host methods as device functions
# -----------------------------------------------------------------
@dataclass
class HostLaw:
    """The host ``Material`` methods that the JAX bridge calls, as device
    functions of the record's parameters: ``seq`` (``calc_seq``) and
    ``sflow`` (``_sflow_rows``) are ``constitutive.seq_hill`` and
    ``flow_stress`` of ``host``, the analytic material of the record's own
    hill (padded to six; the principal-stress form unless ``hill_6p``),
    drucker and Voce constants; ``yf`` (``_yf_rows``) is the served
    material ``dm``'s decision function (kernel D on the card) or seq -
    sflow; ``ml_full_yf`` is ``_ml_full_yf_rows`` along a fixed load
    direction (kernel G).  An anisotropic 3-parameter Hill law assigns the
    principal stresses to the axes by the device convention
    (``jtensors.sig_princ_vals``) where the host ``calc_seq`` follows
    LAPACK's eigenvalue order, so on rotated stresses its ``seq`` (and the
    load-step scaling) may differ from the host's."""
    dm: con.DeviceMaterial
    host: con.DeviceMaterial
    sdim: int
    ml: bool

    @classmethod
    def of(cls, rec, dm):
        elastic = math.isnan(float(rec['sy']))
        hill = np.ones(6)
        if not elastic:
            hill[:np.size(rec['hill'])] = rec['hill']
        host = convert.material_from_params(
            dict(hill=hill, sy=float(rec['sy']), khard=float(rec['khard']),
                 drucker=0. if elastic else float(rec['drucker']),
                 voce_r=float(rec['voce_r']), voce_b=float(rec['voce_b'])),
            is_svc=False, sdim3=elastic or not bool(rec['hill_6p']),
            dtype=dm.sv.dtype, device=dm.sv.device)
        return cls(dm=dm, host=host, sdim=int(rec['sdim']),
                   ml=bool(rec['ML_yf']))

    @property
    def plastic(self):
        return not math.isnan(self.host.sy)

    def seq(self, sig):
        """``calc_seq`` of (N, 6) Voigt or (N, 3) principal rows."""
        return con.seq_hill(self.host, sig)

    def sflow(self, epl):
        """``_sflow_rows``: sy + khard peeq (+ the Voce rise)."""
        return con.flow_stress(self.host, jt.eps_eq(epl))

    def yf(self, sig, epl):
        """``_yf_rows``: the SVC decision function or seq - sflow."""
        if self.ml:
            return con.yf(self.dm, sig, None, epl)
        return self.seq(sig) - self.sflow(epl)

    def ml_full_yf(self, sig, epl, ld, root=sk.svc_yf_root):
        """``_ml_full_yf_rows(sig, epl, ld=ld)``: the distance to the SVC
        locus along the FIXED load direction su = ld sqrt(1.5) / |ld| of
        every row, through kernel G (on the card; its plain version on
        the CPU): start at sflow (halved where su_0 su_1 < -1e-5), march
        down by 0.98 while f >= 0 and x > 0.01 and up by 1.02 while f < 0
        and x < 5 sflow, at most ``HOST_MAXMARCH`` steps each, then
        Brent with xtol 1e-5 (100 iterations, rtol 4 eps, as
        ``brent_vec``); roots beyond 4 sflow or unconverged lanes take
        seq - 0.85 sflow.  G evaluates the decision function with
        matmul-expansion distances where the host takes direct
        differences: the roots agree to Brent's xtol.  ``root`` as in
        ``constitutive.ml_yf_dist``."""
        N = sig.shape[0]
        seq = self.seq(sig)
        sflow = self.sflow(epl)
        fallback = seq - 0.85 * sflow
        ld = np.asarray(ld, float)[0:self.sdim]
        hh = float(np.linalg.norm(ld))
        if hh < 1.e-3:
            warnings.warn(f'ML_full_yf called with inconsistent ld={ld}')
            hh = 1.
            ld = np.zeros(self.sdim)
            ld[0] = 1.
        su = torch.as_tensor(ld * np.sqrt(1.5) / hh, dtype=sig.dtype,
                             device=sig.device).expand(N, self.sdim)
        su = su.contiguous()
        x0 = torch.where(su[:, 0] * su[:, 1] < -1.e-5, 0.5 * sflow, sflow)
        m = self.dm
        xs, ok = root(su, x0.contiguous(), (5. * sflow).contiguous(), m.sv,
                      m.dc, m.gamma, m.rho, con._root_features(m, su, epl),
                      xtol=1.e-5, maxmarch=HOST_MAXMARCH)
        good = ok & (xs < 4. * sflow)
        return torch.where(good, seq - xs * self.seq(su), fallback)


# -----------------------------------------------------------------
# records -> device
# -----------------------------------------------------------------
def _materials(rec, dtype, compress, device):
    """(DeviceMaterials, material records) of a record, each SVC
    compressed per ``compress`` unless the record already holds that
    compression."""
    recs = [convert.compress_record(m, compress, device)
            for m in rec['materials']]
    return [convert.material_from_record(m, dtype=dtype, device=device)
            for m in recs], recs


def _bc_spec(rec, dbcr=None, dbct=None, dbcn=None):
    """The ``make_edge_bcs`` spec of a 2-D record: displacement-controlled
    components become fixed values, force-controlled ones on the
    incremental edges (right, top) total edge forces, the node set
    per-node pins or loads; ``dbc*`` replace the incremental values."""
    nnY = rec['NY'] + 1
    bcr = rec['bcr'] if dbcr is None else dbcr
    bct = rec['bct'] if dbct is None else dbct
    bcn = rec['bcn'] if dbcn is None else dbcn
    spec = dict(
        left={k: ('disp', rec['bcl'][k]) for k in range(2)
              if rec['ubcleft'][k]},
        bot={k: ('disp', rec['bcb'][k]) for k in range(2)
             if rec['ubcbot'][k]},
        right={k: ('disp', bcr[k]) if rec['ubcright'][k]
               else ('force', bcr[k]) for k in range(2)},
        top={k: ('disp', bct[k]) if rec['ubctop'][k]
             else ('force', bct[k]) for k in range(2)})
    nodes = []
    for n in np.atleast_1d(rec.get('noset', np.zeros(0, np.int64))):
        ix, iy = divmod(int(n), nnY)
        for k in range(2):
            if rec['ubcn'][k]:
                nodes.append((ix, iy, k, 'disp', bcn[k]))
            elif abs(bcn[k]) > 1.e-12:
                nodes.append((ix, iy, k, 'force', bcn[k]))
    spec['nodes'] = tuple(nodes)
    return spec


def record_to_device(rec, dtype=torch.float32, compress=None, device=None):
    """``(MeshData, mat(s), CV(s))`` of a model record (the JAX
    ``to_device`` / ``to_device_1d`` results): one material and stiffness
    for a single-material model, tuples aligned with the mesh's material
    groups otherwise."""
    return _device_parts(rec, dtype, compress, device)[:3]


def _device_parts(rec, dtype, compress, device):
    """``record_to_device`` and the (compressed) material records."""
    device = resolve_device(device)
    dms, recs = _materials(rec, dtype, compress, device)
    CVs = [np.asarray(c, float) for c in rec['CVs']]
    multi = len(dms) > 1
    if rec['dim'] == 1:
        md = _mesh_1d(rec, dtype, device, multi)
    else:
        NX, NY = rec['NX'], rec['NY']
        ps = {}
        if rec['planestress']:
            mats = rec['materials']
            ps = dict(planestress=True,
                      ps_CV=tuple(CVs) if multi else CVs[0],
                      ps_E=tuple(float(m['E']) for m in mats) if multi
                      else float(mats[0]['E']),
                      ps_nu=tuple(float(m['nu']) for m in mats) if multi
                      else float(mats[0]['nu']))
        md = fek.rect_mesh(NX, NY, LX=rec['lenx'], LY=rec['leny'],
                           thick=rec['thick'], dtype=dtype, device=device,
                           bc=_bc_spec(rec),
                           mat_map=np.asarray(rec['ids']).reshape(NX, NY)
                           if multi else None, **ps)
    if multi:
        return md, tuple(dms), tuple(CVs), recs
    return md, dms[0], CVs[0], recs


def _mesh_1d(rec, dtype, device, multi):
    """The flat MeshData of a 1-D bar: per-element B (Nel, ngp, 6, n),
    Bsum and (Nel,) jacw, DOF numbering equal to the host's node
    numbering, displacement or force BCs on the two bar ends."""
    ndof = int(rec['ndof'])
    fixed = np.zeros(ndof, dtype=bool)
    fval = np.zeros(ndof)
    force = np.zeros(ndof)
    for side, bc in (('left', 'bcl'), ('right', 'bcr')):
        nodes = np.asarray(rec['no' + side])
        if rec['ubc' + side][0]:
            fixed[nodes] = True
            fval[nodes] = rec[bc][0]
        else:
            force[nodes] = rec[bc][0]
    perm = inv_perm = groups = None
    if multi:
        perm, inv_perm, groups = fek.material_groups(rec['ids'])

    def ten(a, dt=dtype):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=dt, device=device)

    dofs = np.asarray(rec['dofs'], np.int64)
    return fek.MeshData(B=ten(rec['B']), Bsum=ten(rec['Bsum']),
                        jacw=ten(rec['jacw']), vel=ten(rec['vel']),
                        fixed=ten(fixed, torch.bool), fixed_val=ten(fval),
                        force=ten(force), ndof=ndof, nel=dofs.shape[0],
                        grid=None, M64=None, perm=ten(perm, torch.long),
                        inv_perm=ten(inv_perm, torch.long), groups=groups,
                        dofs=ten(dofs, torch.long))


def to_device(model, dtype=torch.float32, compress=None, device=None):
    """Convert a meshed 2-D host Model to ``(MeshData, mat(s), CV(s))``
    (the JAX ``to_device``): grouped meshes for several materials, plane
    stress (one material or per material), general edge and node BCs;
    ``compress`` applies the reduced-set compression to SVC materials."""
    if model.dim != 2:
        _check_supported(model)
    rec = read_model(model, compress=compress, device=device)
    return record_to_device(rec, dtype, compress, device)


def to_device_1d(model, dtype=torch.float32, compress=None, device=None):
    """Convert a meshed 1-D host bar (linear or quadratic elements,
    per-section lengths) to ``(MeshData, mat(s), CV(s))`` on the flat
    layout (the JAX ``to_device_1d``)."""
    if model.dim != 1:
        raise ValueError('to_device_1d expects a 1-D model')
    rec = read_model(model, compress=compress, device=device)
    return record_to_device(rec, dtype, compress, device)


# -----------------------------------------------------------------
# solvers on records
# -----------------------------------------------------------------
def _host_u(u):
    """Device displacements -> the host's interleaved numbering."""
    if u.dim() == 1:
        return u.double().cpu().numpy()
    return u.double().permute(1, 2, 0).reshape(-1).cpu().numpy()


def _forces_2d(md, sig):
    """Nodal forces (host numbering) from the element stresses: the
    element-average stress sums the 4 Gauss points, so the consistent
    internal force is (jacw / 4) Bsum^T sigma, scattered to the nodes."""
    NX, NY = md.grid[:2]
    fe = (md.jacw / 4.) * torch.einsum('ai,ea->ei', md.Bsum, sig)
    f8 = fe.T.reshape(8, NX, NY)
    return _host_u(torch.stack(st.scatter_planes(
        tuple(f8[i] for i in range(8)), NX, NY), 0))


def _results(u, f, state, sgl, egl, epgl, **extra):
    return dict(u=u, f=f, sig=state.sig.double().cpu().numpy(),
                eps=state.eps.double().cpu().numpy(),
                epl=state.epl.double().cpu().numpy(),
                sgl=np.array(sgl), egl=np.array(egl), epgl=np.array(epgl),
                **extra)


def _glob(v):
    return torch.mean(v, dim=0).double().cpu().numpy()


def solve_record(rec, nsteps=20, n_inner=2, dtype=torch.float32, nsub=4,
                 fast=True, cg_tol=None, n_refine=0, compress='auto',
                 device=None):
    """``solve_on_device`` on a model record: ``nsteps`` equal load
    steps of ``load_step_split`` threading the warm start, the hierarchy
    and the tangent change (``du0``/``kes0``/``dst0``).  Returns the
    results (host numbering, float64 numpy) that ``write_back`` writes."""
    if rec['dim'] == 1:
        return _solve_record_1d(rec, nsteps, n_inner, dtype, nsub, fast,
                                cg_tol, n_refine, compress, device)
    md, dm, CV = record_to_device(rec, dtype, compress, device)
    state = fek.init_state(md, CV, dtype=dtype)
    sgl, egl, epgl = [np.zeros(6)], [np.zeros(6)], [np.zeros(6)]
    du0 = kes0 = dst0 = None
    for _ in range(nsteps):
        state, diag = fek.load_step_split(
            md, state, dm, CV, 1. / nsteps, n_inner=n_inner, nsub=nsub,
            fast=fast, du0=du0, cg_tol=cg_tol, kes0=kes0, dst0=dst0,
            n_refine=n_refine)
        du0, kes0, dst0 = diag['du'], diag['kes'], diag['dstiff']
        sgl.append(diag['glob_sig'].double().cpu().numpy())
        egl.append(diag['glob_eps'].double().cpu().numpy())
        epgl.append(diag['glob_epl'].double().cpu().numpy())
    return _results(_host_u(state.u), _forces_2d(md, state.sig), state,
                    sgl, egl, epgl)


def _solve_record_1d(rec, nsteps, n_inner, dtype, nsub, fast, cg_tol,
                     n_refine, compress, device):
    """1-D bars on the flat layout: volume-weighted global history (the
    elements differ in size), nodal forces from the full unmasked K u
    (reaction forces on the fixed dofs included)."""
    md, dm, CV = record_to_device(rec, dtype, compress, device)
    state = fek.init_state(md, CV, dtype=dtype)
    wv = md.vel / md.vel.sum()
    sgl, egl, epgl = [np.zeros(6)], [np.zeros(6)], [np.zeros(6)]
    du0 = None
    for _ in range(nsteps):
        state, diag = fek.load_step_split(
            md, state, dm, CV, 1. / nsteps, n_inner=n_inner, nsub=nsub,
            fast=fast, du0=du0, cg_tol=cg_tol, n_refine=n_refine)
        du0 = diag['du']
        for hist, v in ((sgl, state.sig), (egl, state.eps),
                        (epgl, state.epl)):
            hist.append((v.T @ wv).double().cpu().numpy())
    Ke = fek.element_stiffness(md, state.elstiff)
    fe = torch.einsum('eij,ej->ei', Ke, fek.gather_element(md, state.u))
    return _results(_host_u(state.u),
                    _host_u(fek.scatter_element(md, fe)), state, sgl, egl,
                    epgl)


def _load_direction(rec):
    """The loading direction of the ML yield-locus searches (the host
    solve convention)."""
    bcr, bct = rec['bcr'], rec['bct']
    sld = np.zeros(6)
    if abs(bcr[0]) > 1.e-6:
        sld[0] = np.sign(bcr[0])
    if abs(bct[1]) > 1.e-6:
        sld[1] = np.sign(bct[1])
    if abs(bcr[1]) > 1.e-6:
        sld[5] = np.sign(bcr[1])
    if abs(bct[0]) > 1.e-6:
        sld[5] = np.sign(bct[0])
    if np.linalg.norm(sld) < 1.e-3:
        sld[0] = 1.
    return sld


def _calc_scf(groups, sig, epl, dsig, sld):
    """The host load-step scaling statistics (``Model._calc_scf``,
    reference model.py:1036-1067) on element tensors: per-element
    distance-to-yield scaling factors, the double append for elements
    starting well inside the elastic regime, and the min-vs-(mean - std)
    selection.  ``groups`` pairs each ``HostLaw`` with its element
    indices."""
    Nel = sig.shape[0]
    sref = sig.new_zeros(Nel)
    yf0 = sig.new_zeros(Nel)
    for law, idx in groups:
        sref[idx] = law.seq(dsig[idx])
        if law.plastic:
            yf0[idx] = law.yf(sig[idx], epl[idx])
            need = (sref[idx] > 0.1) & (yf0[idx] < -0.15)
            if law.ml and bool(need.any()):
                k = idx[need]
                yf0[k] = law.ml_full_yf(sig[k], epl[k], sld)
    sc = []
    for law, idx in groups:
        if not law.plastic:
            continue
        ii = idx[sref[idx] > 0.1]
        deep = yf0[ii] < -0.15
        dd = ii[deep]
        hh = torch.clamp(-yf0[dd] / sref[dd], max=1.)
        sc += [hh, hh]      # the host's double append
        rest = ii[~deep]
        sc.append(torch.clamp(math.sqrt(1.5) * law.sflow(epl[rest])
                              / sref[rest], max=1.))
    sc = torch.cat(sc) if sc else sig.new_zeros(0)
    if sc.numel() == 0:
        return 1.
    hh = float(torch.std(sc, correction=0))
    scf = float(sc.min()) if hh < 0.1 else max(1.e-3, float(sc.mean()) - hh)
    return max(scf, 1.e-3)


def _state_from_record(rec, md, dtype):
    """The device ``SolverState`` of a record's resume state: the
    displacements in the (2, nnX, nnY) layout, the element states, the
    tangents from the stored element stiffnesses."""
    dev = md.device
    sh = md.fixed.shape
    u = torch.as_tensor(np.asarray(rec['u'], float).reshape(
        sh[1], sh[2], sh[0]), dtype=dtype, device=dev).permute(2, 0, 1)

    def ten(k):
        return torch.as_tensor(np.asarray(rec[k], float), dtype=dtype,
                               device=dev)

    return fek.SolverState(u=u.contiguous(), sig=ten('sig'), epl=ten('epl'),
                           eps=ten('eps'),
                           elstiff=fek.elstiff_planes(md, ten('elstiff')))


def _elstiff_rows(planes):
    return planes.reshape(36, -1).T.reshape(-1, 6, 6)


def solve_record_adaptive(rec, min_step=None, verb=False,
                          dtype=torch.float64, fast=False, nsub=4,
                          device=None):
    """``solve_on_device_adaptive`` on a 2-D model record: the host's
    adaptive load stepping (touch-yield scaling of the first increments,
    up to 15 inner iterations with load halving for il < 6 and tangent
    averaging at the 15th, convergence on the normalized yield excess),
    each linear solve an MG-CG (the hierarchy reused while no tangent
    changed; an f32 warm start only then) and each constitutive update
    the grouped return map.  A record with a resume state continues from
    it: the BC memory marks the load already applied and only the rest is
    stepped.  Returns the results for ``write_back`` with ``nsteps``,
    ``niter``, ``co_nconv``, the BC memory and ``append`` (resume)."""
    if rec['dim'] != 2:
        raise ValueError('device solver bridge supports 2-D models only')
    resume = 'u' in rec
    device = resolve_device(device)
    md, dm, CV, recs = _device_parts(rec, dtype, None, device)
    if md.groups is None:
        dm, CV = (dm,), (CV,)
        groups_idx = [torch.arange(md.nel, device=device)]
    else:
        groups_idx = [md.perm[s:s + z] for s, z in md.groups]
    laws = [HostLaw.of(r, d) for r, d in zip(recs, dm)]
    groups = list(zip(laws, groups_idx))
    nonlin = any(law.plastic for law in laws)
    one = md.groups is None
    mat_arg, CV_arg = (dm[0], CV[0]) if one else (dm, CV)
    state = _state_from_record(rec, md, dtype) if resume \
        else fek.init_state(md, CV_arg, dtype=dtype)
    f64 = dtype == torch.float64
    noset = 'noset' in rec
    kes = {'kes': None}

    def solve_inc(elstiff, dbcr, dbct, dbcn, x0=None, reuse=False):
        _, fval, force = fek.make_edge_bcs(
            rec['NX'], rec['NY'], **_bc_spec(rec, dbcr, dbct, dbcn))
        bc_val = torch.as_tensor(fval, dtype=dtype, device=device)
        force = torch.as_tensor(force, dtype=dtype, device=device)
        if not reuse or kes['kes'] is None:
            kes['kes'] = fek._hier_kes(md, elstiff)
            # warm-start freshness gate: an increment of a CHANGED
            # tangent system poisons f32 CG
            if not f64:
                x0 = None
        tol = 1.e-11 if f64 else 1.e-6
        x0 = torch.zeros_like(bc_val) if x0 is None else x0
        return fek._mg_solve(md, kes['kes'], bc_val, force, tol, 100, x0)[0]

    sld = _load_direction(rec)
    bcr, bct, bcn = (np.asarray(rec[k], float) for k in ('bcr', 'bct',
                                                           'bcn'))
    if resume:
        bcr0 = np.array(rec['bcr_mem'], float)
        bct0 = np.array(rec['bct_mem'], float)
        bcn0 = np.array(rec['bcn_mem'], float) if noset else None
        sgl, egl, epgl = [], [], []
    else:
        bcr0, bct0 = np.zeros(2), np.zeros(2)
        bcn0 = np.zeros(2) if noset else None
        sgl, egl, epgl = [np.zeros(6)], [np.zeros(6)], [np.zeros(6)]
    il = 0
    niter, co_nconv = [], []
    nconv = 0
    bc_inc = True
    tangent_changed = True
    while bc_inc:
        max_dbct = bct - bct0
        max_dbcr = bcr - bcr0
        if min_step is not None:
            scd = np.maximum(1, min_step - il)
            max_dbct = max_dbct / scd
            max_dbcr = max_dbcr / scd
        dbcr, dbct = np.array(max_dbcr), np.array(max_dbct)
        if noset:
            max_dbcn = bcn - bcn0
            if min_step is not None:
                max_dbcn = max_dbcn / np.maximum(1, min_step - il)
            dbcn = np.array(max_dbcn)
        else:
            max_dbcn = dbcn = None
        elstiff = state.elstiff
        du = solve_inc(elstiff, dbcr, dbct, dbcn, reuse=not tangent_changed)
        nit = 0
        if nonlin:
            if il < 10:
                deps = fek.element_deps(md, du)
                dsig = torch.einsum('nij,nj->ni', _elstiff_rows(elstiff),
                                    deps)
                scale_bc = _calc_scf(groups, state.sig, state.epl, dsig,
                                     sld)
            else:
                scale_bc = 1.
            dbcr = max_dbcr * scale_bc
            dbct = max_dbct * scale_bc
            change = True
            conv = False
            while (change or not conv) and nit <= 15:
                if il < 6 and nit > 1:
                    dbcr = _halve_increment(dbcr, max_dbcr, bcr, bcr0)
                    dbct = _halve_increment(dbct, max_dbct, bct, bct0)
                    if noset:
                        dbcn = _halve_increment(dbcn, max_dbcn, bcn, bcn0)
                du = solve_inc(elstiff, dbcr, dbct, dbcn, x0=du,
                               reuse=not tangent_changed)
                deps_d = fek.element_deps(md, du)
                fy, res_sig, res_depl, grad = fek.respond_grouped(
                    md, mat_arg, CV_arg, state.sig, state.epl, deps_d,
                    fast=fast, nsub=nsub)
                # normalized yield excess per plastic element (host conv)
                fnorm = torch.zeros_like(fy)
                for law, idx in groups:
                    if law.plastic:
                        fnorm[idx] = fy[idx] / law.sflow(state.epl[idx])
                conv = bool(torch.all(fnorm <= yf_tolerance * 1.0001))
                if not conv:
                    nconv += 1
                # tangent update: replace above the change threshold,
                # average at the 15th iteration (host fallback)
                gP = fek.elstiff_planes(md, grad)
                dst = torch.sqrt(torch.sum((elstiff - gP) ** 2, dim=0))
                upd = dst > 1.e-3
                new = gP if nit < 15 else 0.5 * (gP + elstiff)
                elstiff = torch.where(upd, new, elstiff)
                change = bool(torch.any(upd))
                tangent_changed = change
                nit += 1
        else:
            deps_d = fek.element_deps(md, du)
            fy, res_sig, res_depl, grad = fek.respond_grouped(
                md, mat_arg, CV_arg, state.sig, state.epl, deps_d,
                fast=fast, nsub=nsub)
        state = fek.SolverState(u=state.u + du, sig=res_sig,
                                epl=state.epl + res_depl,
                                eps=state.eps + fek.element_deps(md, du),
                                elstiff=elstiff)
        il += 1
        niter.append(nit - 1 if nonlin else 0)
        co_nconv.append(nconv)
        bcr0 = bcr0 + dbcr
        bct0 = bct0 + dbct
        hl0 = abs(bcr0[0] - bcr[0]) > 1e-6 and abs(bcr[0]) > 1e-9
        hl1 = abs(bcr0[1] - bcr[1]) > 1e-6 and abs(bcr[1]) > 1e-9
        hr0 = abs(bct0[0] - bct[0]) > 1e-6 and abs(bct[0]) > 1e-9
        hr1 = abs(bct0[1] - bct[1]) > 1e-6 and abs(bct[1]) > 1e-9
        if noset:
            bcn0 = bcn0 + dbcn
            hr0 = hr0 or (abs(bcn0[0] - bcn[0]) > 1e-6
                          and abs(bcn[0]) > 1e-9)
            hr1 = hr1 or (abs(bcn0[1] - bcn[1]) > 1e-6
                          and abs(bcn[1]) > 1e-9)
        bc_inc = hl0 or hl1 or hr0 or hr1
        sgl.append(_glob(state.sig))
        egl.append(_glob(state.eps))
        epgl.append(_glob(state.epl))
    extra = dict(nsteps=il, niter=niter, co_nconv=co_nconv, bcr_mem=bcr0,
                 bct_mem=bct0, append=resume)
    if noset:
        extra['bcn_mem'] = bcn0
    return _results(_host_u(state.u), _forces_2d(md, state.sig), state, sgl,
                    egl, epgl, **extra)


def record_after(rec, res):
    """The record that ``read_model`` gives of the host model once
    ``write_back(model, res)`` has run: the displacements, element states
    and BC memory of the results, the element tangents as the model held
    them (the write-back leaves ``el.elstiff`` as it was)."""
    out = dict(rec, u=res['u'], sig=res['sig'], eps=res['eps'],
               epl=res['epl'])
    for k in ('bcr_mem', 'bct_mem', 'bcn_mem'):
        if k in res:
            out[k] = res[k]
    if 'elstiff' not in out:
        out['elstiff'] = np.stack([rec['CVs'][int(i)] for i in rec['ids']])
    return out


# -----------------------------------------------------------------
# the writing end
# -----------------------------------------------------------------
def write_back(model, res):
    """Write the results of a solver on records into the host model:
    displacements, nodal forces, element states, the global history
    (appended on a resume), the step counters and BC memory where the
    solver returns them, then ``model.calc_global()``."""
    model.u = res['u']
    model.f = res['f']
    for i, el in enumerate(model.element):
        el.sig = res['sig'][i]
        el.eps = res['eps'][i]
        el.epl = res['epl'][i]
    for k in ('sgl', 'egl', 'epgl'):
        rows = np.asarray(res[k]).reshape(-1, 6)
        setattr(model, k, np.append(getattr(model, k), rows, axis=0)
                if res.get('append') else rows)
    for k in ('bct_mem', 'bcr_mem', 'bcn_mem', 'nsteps', 'niter',
              'co_nconv'):
        if k in res:
            setattr(model, k, res[k])
    model.calc_global()
    return model


# -----------------------------------------------------------------
# the entry points
# -----------------------------------------------------------------
def solve_on_device(model, nsteps=20, n_inner=2, dtype=torch.float32,
                    nsub=4, fast=True, cg_tol=None, n_refine=0,
                    compress='auto', device=None):
    """Solve the (supported subset of) host model with the device solver
    and write displacements, element states and global history back (the
    JAX ``solve_on_device``).  ``fast=False`` selects the
    reference-faithful substepped return map; ``cg_tol`` overrides the
    linear-solve tolerance (1e-11 float64, 1e-6 float32); ``n_refine``
    adds mixed-precision refinement passes to each linear solve;
    ``compress`` (default 'auto') serves SVC materials through the
    reduced-set compression with an absolute decision-function error
    bound of 10 % of the yield-tolerance band (None serves the raw SV
    set).  1-D bars run on the flat layout and Jacobi-CG, 2-D grids on
    MG-CG."""
    rec = read_model(model, compress=compress, device=device)
    return write_back(model, solve_record(
        rec, nsteps=nsteps, n_inner=n_inner, dtype=dtype, nsub=nsub,
        fast=fast, cg_tol=cg_tol, n_refine=n_refine, compress=compress,
        device=device))


def solve_on_device_adaptive(model, min_step=None, verb=False,
                             dtype=torch.float64, fast=False, nsub=4,
                             device=None):
    """Device twin of ``Model.solve`` (the JAX
    ``solve_on_device_adaptive``): mirrors the host's adaptive load
    stepping (``solve_record_adaptive``) with every linear solve on the
    MG-CG and every constitutive update on the grouped return map, and
    writes the results back.  A model with displacements resumes (the BC
    memory marks the load already applied; the history is appended)."""
    rec = read_model(model, device=device)
    return write_back(model, solve_record_adaptive(
        rec, min_step=min_step, verb=verb, dtype=dtype, fast=fast,
        nsub=nsub, device=device))


#: the load cases of ``calc_properties``: the displaced edges and the
#: strains eps_x, eps_y over the total strain (material.py:3125-3153)
LOAD_CASES = {'stx': ('x', 1., 0.), 'sty': ('y', 0., 1.),
              'et2': ('xy', 0.4, 0.4), 'ect': ('xy', -0.8, 0.8)}


def _solve_grid(md, elstiff, bc_val):
    """One MG-CG solve of a structured mesh (the JAX ``solve_linear``'s
    grid branch): prescribed ``bc_val``, no force, zero start."""
    tol = 1.e-11 if elstiff.dtype == torch.float64 else 1.e-6
    zero = torch.zeros_like(bc_val)
    return fek._mg_solve(md, fek._hier_kes(md, elstiff), bc_val, zero, tol,
                         100, zero)[0]


def properties_record(mrec, size=2., Nel=16, eps=0.005, nsteps=20,
                      n_inner=3, dtype=torch.float32,
                      load_cases=('stx', 'sty', 'et2', 'ect'), device=None):
    """``calc_properties_on_device`` on a material record (its SVC
    compressed where the record holds a compression): the canonical
    plane-stress load paths (uniaxial x and y, equibiaxial, pure shear)
    on an Nel x Nel mesh, the first increment scaled to touch the yield
    surface (``ml_yf_dist``, kernel G, for an SVC; sy / max seq
    otherwise), then ``nsteps`` steps of ``load_step_split``.  Returns
    {case: dict(prop=..., propJ2=..., sigeps=...)}."""
    device = resolve_device(device)
    E, nu, C44 = float(mrec['E']), float(mrec['nu']), float(mrec['C44'])
    hh = E / (1. - nu * nu)
    CV = np.zeros((6, 6))
    CV[0, 0] = CV[1, 1] = hh
    CV[0, 1] = CV[1, 0] = nu * hh
    CV[5, 5] = C44
    dm = convert.material_from_record(mrec, dtype=dtype, device=device)
    law = HostLaw.of(mrec, convert.material_from_record(
        mrec, dtype=torch.float64, device=device))
    CVt = torch.as_tensor(CV, dtype=dtype, device=device)
    out = {}
    for sel in load_cases:
        uniax, fx, fy = LOAD_CASES[sel]
        md = fek.rect_mesh(Nel, Nel, LX=size, LY=size, uniax=uniax,
                           eps_tot=0., eps_x=fx * eps, eps_y=fy * eps,
                           dtype=dtype, device=device, planestress=True,
                           ps_CV=CV, ps_E=E, ps_nu=nu)
        state = fek.init_state(md, CV, dtype=dtype)
        du = _solve_grid(md, state.elstiff, md.fixed_val)
        sig_tr = fek.element_deps(md, du) @ CVt.T
        if dm.is_svc:
            dist = con.ml_yf_dist(dm, sig_tr, torch.zeros(
                sig_tr.shape[0], dtype=dtype, device=device))
            seq_tr = jt.seq_j2_voigt(sig_tr.double()).to(dtype)
            scale = float(torch.min((seq_tr.double() - dist.double())
                                    / torch.clamp(seq_tr.double(),
                                                  min=1e-12)))
        else:
            seq_tr = law.seq(sig_tr.double())
            scale = float(mrec['sy']) / max(float(seq_tr.max()), 1e-12)
        scale = min(max(scale, 0.), 1.)
        fracs = [scale] + [(1. - scale) / nsteps] * nsteps if scale < 1. \
            else [1. / nsteps] * nsteps
        sgl, egl, epgl = [np.zeros(6)], [np.zeros(6)], [np.zeros(6)]
        for frac in fracs:
            state, diag = fek.load_step_split(md, state, dm, CV, frac,
                                              n_inner=n_inner)
            sgl.append(diag['glob_sig'].double().cpu().numpy())
            egl.append(diag['glob_eps'].double().cpu().numpy())
            epgl.append(diag['glob_epl'].double().cpu().numpy())
        sgl, egl, epgl = np.array(sgl), np.array(egl), np.array(epgl)
        t64 = dict(dtype=torch.float64, device=device)
        seq = law.seq(torch.as_tensor(sgl, **t64)).cpu().numpy()
        eeq = jt.eps_eq(torch.as_tensor(egl, **t64)).cpu().numpy()
        peeq = jt.eps_eq(torch.as_tensor(epgl, **t64)).cpu().numpy()
        seqJ2 = jt.seq_j2_voigt(torch.as_tensor(sgl, **t64)).cpu().numpy()
        iys = np.nonzero(peeq < 1.e-2)[0]
        iysJ2 = np.nonzero(peeq < 1.e-6)[0]
        out[sel] = dict(
            prop=dict(ys=seq[iys[-1]], seq=seq, eeq=eeq, peeq=peeq),
            propJ2=dict(ys=seqJ2[iysJ2[-1]], seq=seqJ2, eeq=eeq,
                        peeq=peeq),
            sigeps=dict(sig=sgl, eps=egl, epl=epgl), scale=scale)
    return out


def write_properties(mat, props):
    """Fill ``mat.prop`` / ``mat.propJ2`` / ``mat.sigeps`` from
    ``properties_record`` results, as the host ``calc_properties`` does,
    and set ``mat.prop_calculated``."""
    for sel, r in props.items():
        for key in ('prop', 'propJ2', 'sigeps'):
            getattr(mat, key)[sel].update(r[key])
    mat.prop_calculated = True
    return mat


def calc_properties_on_device(mat, size=2., Nel=16, eps=0.005, nsteps=20,
                              n_inner=3, dtype=torch.float32,
                              load_cases=('stx', 'sty', 'et2', 'ect'),
                              device=None):
    """``Material.calc_properties`` on the device solver (the JAX
    ``calc_properties_on_device``): fills ``mat.prop`` / ``mat.propJ2``
    / ``mat.sigeps`` like the host version, at a mesh of ``Nel`` x
    ``Nel`` elements.  The SVC is served uncompressed, as in JAX."""
    return write_properties(mat, properties_record(
        convert.material_record(mat), size=size, Nel=Nel, eps=eps,
        nsteps=nsteps, n_inner=n_inner, dtype=dtype, load_cases=load_cases,
        device=device))


def run_record(rec, dtype=None, device=None):
    """Run the solver a saved record names (``solver``: 'solve_on_device'
    or 'solve_on_device_adaptive', its keyword arguments as ``kw.<name>``,
    the dtype by name) on the record, in ``dtype`` where given; a record
    with ``bct2`` is solved again from the results with the top BC raised
    to it (the continued-loading protocol), its history appended.
    Returns the results with ``glob_sig``, the volume-weighted mean
    stress of ``Model.calc_global``."""
    kw = {k[3:]: _value(v) for k, v in rec.items() if k.startswith('kw.')}
    kw['dtype'] = dtype if dtype is not None else getattr(
        torch, str(kw.get('dtype', 'float32')))
    kw['device'] = device
    solve = solve_record if rec['solver'] == 'solve_on_device' \
        else solve_record_adaptive
    res = solve(rec, **kw)
    if 'bct2' in rec:
        nxt = dict(record_after(rec, res), bct=np.asarray(rec['bct2']))
        res2 = solve(nxt, **kw)
        for k in ('sgl', 'egl', 'epgl'):
            res2[k] = np.append(res[k], res2[k], axis=0)
        res = res2
    w = np.asarray(rec['vel'], float) if rec['dim'] == 1 \
        else np.ones(len(rec['ids']))
    res['glob_sig'] = w @ res['sig'] / w.sum()
    return res
