"""Write the JAX reference results that the port's domain-decomposition
tests hold ``pylabfea_tpu_torch.parallel`` against:

    JAX_PLATFORMS=cpu python tools/make_torch_parallel_fixtures.py

runs ``pylabfea_tpu.parallel.sharded`` and ``sharded3`` on 4 of 8 virtual
CPU devices (the test suite's mesh) in float64 and float32 and writes
``pylabfea_tpu_torch/data/parallel_strip.npz`` and ``parallel_slab.npz``
(a few minutes, most of it compiling).  Every result is kept block by
block, (D, ...) with block d that of device d; the materials are kept as
the JAX ``DeviceMaterial`` leaves (``m{k}.{leaf}``) or, for the trained
SVC of ``REF_SOLVE_svc.npz``, as the marker ``mats = 'svc'``.
"""
import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
_flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8').strip()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update('jax_enable_x64', True)

import pylabfea_tpu as FE  # noqa: E402
from pylabfea_tpu.ops import constitutive as con  # noqa: E402
from pylabfea_tpu.parallel import sharded as sh  # noqa: E402
from pylabfea_tpu.parallel import sharded3 as sh3  # noqa: E402
import torch  # noqa: E402
from pylabfea_tpu_torch import convert  # noqa: E402

DATA = os.path.join(ROOT, 'pylabfea_tpu_torch', 'data')
NPZ = os.path.join(ROOT, 'REF_SOLVE_svc.npz')
#: devices (strips / slabs) of every fixture
W = 4
#: the JAX test's 3-material inclusion (tests/test_sharded_strip.py)
INCL_BC = {'bot': {1: ('disp', 0.)}, 'top': {1: ('disp', 0.0025 * 2.)},
           'nodes': ((0, 0, 0, 'disp', 0.),)}


def svc(dtype):
    """The trained SVC of REF_SOLVE_svc.npz as a JAX DeviceMaterial and
    its CV (the construction of tests/test_torch_fe_step.py)."""
    mat, CV, _ = convert.material_from_npz(NPZ, dtype=torch.float64,
                                           device='cpu')
    f = lambda a: jnp.asarray(np.asarray(a, float), dtype)  # noqa: E731
    dm = con.DeviceMaterial(
        hill=f(np.ones(6)), sy=f(mat.sy), khard=f(0.), drucker=f(0.),
        sv=f(mat.sv.numpy()), dc=f(mat.dc.numpy()), rho=f(mat.rho),
        gamma=f(mat.gamma), scale_seq=f(mat.scale_seq), scale_wh=f(1.),
        feat_mean=f(np.zeros(0)), feat_scale=f(np.zeros(0)),
        tex=f(np.zeros(0)), is_svc=True, dev_only=mat.dev_only)
    return dm, CV


def leaves(out, tag, dms, CVs):
    """The materials' leaves and elastic stiffnesses under ``tag``."""
    for k, (dm, CV) in enumerate(zip(dms, CVs)):
        for name, v in dm._asdict().items():
            out[f'{tag}.m{k}.{name}'] = np.asarray(v)
        out[f'{tag}.CV{k}'] = np.asarray(CV, float)
    out[f'{tag}.nmat'] = np.asarray(len(dms))


def strip_case(out, tag, NX, NY, LX, LY, dtype, dm, CV, frac, n_inner,
               cg_tol=1e-8, schwarz=2, bc=None, mat_map=None, eps=0.002):
    sm = sh.StripMesh(NX, NY, LX=LX, LY=LY, uniax='y', eps_tot=eps,
                      n_devices=W, dtype=dtype, bc=bc, mat_map=mat_map)
    multi = not isinstance(dm, con.DeviceMaterial)
    if multi:
        rows = np.stack(CV)[np.asarray(mat_map).reshape(-1)]
    else:
        rows = np.broadcast_to(np.asarray(CV), (NX * NY, 6, 6)).copy()
    el0 = sm.shard_elements(rows)
    z = sm.shard_elements(np.zeros((NX * NY, 6)))
    sig, epl, du, d = sh.strip_load_step(
        sm, el0, z, z, dm, frac, n_inner, cg_tol, 4, schwarz,
        CVs=CV if multi else None)
    out.update({f'{tag}.sig': np.asarray(sig), f'{tag}.epl': np.asarray(epl),
                f'{tag}.du': np.stack([np.asarray(x) for x in du]),
                f'{tag}.glob_sig': np.asarray(d['glob_sig']),
                f'{tag}.glob_epl': np.asarray(d['glob_epl']),
                f'{tag}.cg_iters': np.asarray(int(d['cg_iters']))})
    print(tag, np.asarray(d['glob_sig']), int(d['cg_iters']), flush=True)


def slab_case(out, tag, N3, dtype, dm, CV, nsteps, n_inner, mat_map=None,
              eps=0.002):
    sm = sh3.SlabMesh3(*N3, uniax='z', eps_tot=eps, n_devices=W,
                       dtype=dtype, mat_map=mat_map)
    sig, epl, u, hist = sh3.solve_uniaxial3_slab(sm, dm, CV, nsteps=nsteps,
                                                 n_inner=n_inner)
    out.update({f'{tag}.sig': np.asarray(sig), f'{tag}.epl': np.asarray(epl),
                f'{tag}.u': np.stack([np.asarray(x) for x in u]),
                f'{tag}.glob_sig': np.stack([np.asarray(h[0]) for h in hist]),
                f'{tag}.cg_iters': np.asarray([int(h[2]) for h in hist])})
    print(tag, np.asarray(hist[-1][0]), [int(h[2]) for h in hist],
          flush=True)


def strips():
    out = {'W': np.asarray(W)}
    # float64 to 1e-12 (two CG runs agree to about their tolerance),
    # float32 at the default 1e-8 of the JAX test
    for dt, tag, tol in ((jnp.float64, 'plastic64', 1e-12),
                         (jnp.float32, 'plastic32', 1e-8)):
        dm, CV = svc(dt)
        strip_case(out, tag, 32, 8, 4., 1., dt, dm, CV, 0.5, 2, cg_tol=tol)
    dm, CV = svc(jnp.float64)
    # 32 x 16 on 4 devices: JAX's Schwarz V-cycle traces only a one-level
    # strip hierarchy (coarsen_mesh under shard_map fails its
    # varying-axes check once NXd and NY reach 16)
    for schwarz in (0, 2):
        strip_case(out, f'schwarz{schwarz}', 32, 16, 4., 1., jnp.float64,
                   dm, CV, 0.5, 2, cg_tol=1e-12, schwarz=schwarz)
    mats = []
    for num, kw in ((1, dict(hill=[0.7, 1., 1.4, 1., 1., 1.])), (2, {})):
        m = FE.Material(num=num)
        m.elasticity(E=200.e3, nu=0.3)
        m.plasticity(sy=150., sdim=6, **kw)
        mats.append(m)
    m = FE.Material(num=3)
    m.elasticity(E=1.e3, nu=0.27)
    mats.append(m)
    dms = tuple(con.device_material_from(m, dtype=jnp.float64) for m in mats)
    CVs = tuple(np.asarray(m.CV, float) for m in mats)
    NX, NY = 32, 16
    mm = np.zeros((NX, NY), dtype=int)
    mm[NX // 2:, :] = 1
    mm[NX // 3: 2 * NX // 3, NY // 3: 2 * NY // 3] = 2
    leaves(out, 'incl64', dms, CVs)
    out['incl64.mat_map'] = mm
    strip_case(out, 'incl64', NX, NY, 4., 2., jnp.float64, dms, CVs, 0.8, 3,
               cg_tol=1e-10, bc=INCL_BC, mat_map=mm)
    np.savez_compressed(os.path.join(DATA, 'parallel_strip.npz'), **out)


def slabs():
    out = {'W': np.asarray(W)}
    N3 = (8, 4, 4)

    def j2(sy, dt):
        m = FE.Material()
        m.elasticity(E=200.e3, nu=0.3)
        m.plasticity(sy=sy, khard=500., sdim=6)
        return m, con.device_material_from(m, dtype=dt)

    m, dm = j2(1.e9, jnp.float64)
    leaves(out, 'elastic64', (dm,), (m.CV,))
    slab_case(out, 'elastic64', N3, jnp.float64, dm, m.CV, 1, 1, eps=0.001)
    for dt, tag, n_inner in ((jnp.float32, 'plastic32', 2),
                             (jnp.float64, 'plastic64', 1)):
        m, dm = j2(150., dt)
        leaves(out, tag, (dm,), (m.CV,))
        slab_case(out, tag, N3, dt, dm, m.CV, 2, n_inner)
    m, dm = j2(150., jnp.float64)
    incl = FE.Material(num=2)
    incl.elasticity(E=600.e3, nu=0.3)
    di = con.device_material_from(incl, dtype=jnp.float64)
    CVi = convert.elastic_cv(600.e3, 0.3)
    mm = np.zeros(N3, np.int32)
    mm[3:5, 1:3, 1:3] = 1
    leaves(out, 'incl64', (dm, di), (m.CV, CVi))
    out['incl64.mat_map'] = mm
    slab_case(out, 'incl64', N3, jnp.float64, (dm, di), (m.CV, CVi), 2, 1,
              mat_map=mm)
    np.savez_compressed(os.path.join(DATA, 'parallel_slab.npz'), **out)


if __name__ == '__main__':
    which = sys.argv[1:] or ['strip', 'slab']
    if 'strip' in which:
        strips()
    if 'slab' in which:
        slabs()
