"""PyTorch port: it imports no JAX, its constructors build on the card
unless asked for the CPU, and its kernel wrappers take the plain version
only for CPU tensors."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pylabfea_tpu_torch import bridge, config, convert, ml_train
from pylabfea_tpu_torch.kernels import build
from pylabfea_tpu_torch.ops import calibrate, fe3d, fe_kernels, rootfind, \
    stencil, volume
from pylabfea_tpu_torch.ops import svc as tsvc
from pylabfea_tpu_torch.ops import svc_kernels as sk

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'pylabfea_tpu_torch')

_PROBE = """
import sys
import torch
torch.set_num_threads(1)
import pylabfea_tpu_torch
from pylabfea_tpu_torch import bridge, convert, ml_train
from pylabfea_tpu_torch.kernels import build
from pylabfea_tpu_torch.ops import (calibrate, constitutive, dual, fe3d,
                                    fe_kernels, femu, jtensors, multigrid,
                                    rootfind, stencil, svc, svc_kernels,
                                    volume)
cpu = dict(device='cpu')
mat, CV, eps = convert.material_from_npz('REF_SOLVE_svc.npz', **cpu)
md = fe_kernels.rect_mesh(16, 16, eps_tot=eps, **cpu)
state, hist = fe_kernels.solve_uniaxial(md, mat, CV, nsteps=2, n_inner=1)
f64 = dict(dtype=torch.float64, **cpu)
mat64, _, _ = convert.material_from_npz('REF_SOLVE_svc.npz', **f64)
md4 = fe_kernels.rect_mesh(4, 4, eps_tot=0.001, **f64)
state4, hist4 = fe_kernels.solve_uniaxial(md4, mat64, CV, nsteps=2,
                                          dtype=torch.float64, gate=True,
                                          commit_faithful=True)
j2 = convert.material_from_params(dict(hill=[1.] * 6, sy=150., khard=500.,
                                       drucker=0.), is_svc=False, **cpu)
md3 = fe3d.box_mesh(2, 2, 2, eps_tot=0.002, **cpu)
state3, hist3 = fe3d.solve_uniaxial3(md3, j2, CV, nsteps=2, n_inner=1)
dist = []
for name in ('svc_wh', 'svc_cyl', 'svc_tex_gsh3', 'svc_tex_adv'):
    m, _, _ = convert.material_from_npz(
        f'pylabfea_tpu_torch/data/{name}.npz', **f64)
    s = torch.linspace(-90., 120., 12, dtype=torch.float64).reshape(2, 6)
    dist.append(constitutive.ml_yf_dist(m, s, torch.zeros(2, **f64)))
mats = (j2, convert.elastic_material(**f64))
mdi = fe_kernels.rect_mesh(2, 2, eps_tot=0.002, mat_map=[[0, 1], [1, 1]],
                           **f64)
u_femu = femu.simulate(mdi, mats, (CV, CV), [1.], n_inner=2, maxiter=8)[0]
deps = torch.full((2, 3, 6), 5e-4, dtype=torch.float64)
sim = calibrate.simulate_paths(
    {'log_sy': torch.tensor(5.), 'log_hill': torch.zeros(6),
     'raw_dsy': torch.tensor(1.)}, torch.as_tensor(CV), deps, 8)
trained, score, _ = ml_train.train_svc(
    torch.tensor([[0.5] + [0.] * 5, [1.5] + [0.] * 5]),
    torch.tensor([-1., 1.]), 100., iters=20, **f64)
rec = bridge.load_record('pylabfea_tpu_torch/data/bridge_bcnode.npz')
res = bridge.run_record(rec, **cpu)
j2rec = convert.material_record_from(200.e3, 0.3, sy=150., khard=500.)
props = bridge.properties_record(j2rec, Nel=2, nsteps=2, load_cases=('sty',),
                                 **f64)
red, rel = svc.reduce_svc(svc.SVCParams(mat64.sv.numpy(), mat64.dc.numpy(),
                                        mat64.rho, mat64.gamma), n_out=8,
                          **cpu)
bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')
             or m == 'pylabfea_tpu' or m.startswith('pylabfea_tpu.'))
assert not bad, bad
print('clean', float(hist[-1][0][1]), float(hist4[-1][0][1]),
      float(hist3[-1][0][2]), [float(d[0]) for d in dist],
      float(u_femu.abs().max()), float(sim[0, -1, 0]), score,
      float(res['u'][684]), float(props['sty']['prop']['ys']), rel)
"""


def test_port_runs_without_importing_jax():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith('clean')


def test_constructors_default_to_the_card(monkeypatch):
    """Without ``device`` every constructor asks for the card; where none
    is visible it raises instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        config.default_device()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        fe_kernels.rect_mesh(4, 4)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        fe3d.box_mesh(2, 2, 2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.material_from_npz(os.path.join(ROOT, 'REF_SOLVE_svc.npz'))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.material_from_params(dict(hill=[1.] * 6, sy=1., khard=0.,
                                          drucker=0.), is_svc=False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.materials_from_params([dict(hill=[1.] * 6, sy=1., khard=0.,
                                            drucker=0., is_svc=False)])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.elastic_material()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        fe_kernels.rect_mesh(4, 4, mat_map=np.eye(4, dtype=int))
    md = fe_kernels.rect_mesh(4, 4, device='cpu')
    arrays = {f: getattr(md, f).numpy() for f in ('B', 'Bsum', 'jacw', 'vel',
                                                  'fixed', 'fixed_val',
                                                  'force')}
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.mesh_from_arrays(arrays, md.grid, md.ndof, md.nel)
    md3 = fe3d.box_mesh(2, 2, 2, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.mesh3_from_arrays({f: getattr(md3, f).numpy()
                                   for f in arrays}, md3.grid, md3.ndof,
                                  md3.nel)
    st = fe3d.init_state3(md3, torch.eye(6, dtype=torch.float64))
    st_arrays = {f: getattr(st, f).numpy() for f in ('u', 'sig', 'epl',
                                                     'eps', 'elstiff')}
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.state3_from_arrays(st_arrays)
    st_arrays['elstiff'] = st_arrays['elstiff'][..., 0]
    st_arrays['u'] = st_arrays['u'][:2, :, :, 0]
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.state_from_arrays(st_arrays)
    assert md.B.device.type == md3.B.device.type == 'cpu'
    X, y = np.eye(6)[:2], np.array([-1., 1.])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ml_train.fit_svc(X, y, iters=2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ml_train.train_svc(X, y, 100., iters=2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ml_train.gridsearch_svc(X, y, [1.], [1.], n_splits=2, iters=2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        calibrate.resample_paths({'a': {'Stress': np.ones((5, 6)),
                                        'Strain_Total': np.cumsum(
                                            np.ones((5, 6)), 0)}})
    with pytest.raises(RuntimeError, match='no CUDA device'):
        calibrate.fit_plasticity(np.ones((1, 4, 6)), np.ones((1, 4, 6)),
                                 np.eye(6))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.theta_from_arrays({'log_sy': 5.})
    # the bridge: materials, meshes and the solvers on records, the
    # compression
    j2 = convert.material_record_from(200.e3, 0.3, sy=150.)
    rec = bridge.grid_record(2, 2, [j2], [convert.elastic_cv(200.e3, 0.3)])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.material_from_record(j2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bridge.record_to_device(rec)
    for solve in (bridge.solve_record, bridge.solve_record_adaptive):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            solve(rec)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bridge.properties_record(j2, Nel=2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tsvc.reduce_svc(tsvc.SVCParams(np.eye(6)[:2], np.array([1., -1.]),
                                       0., 1.), n_out=1)


def test_no_port_source_imports_jax():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith('.py'):
                continue
            path = os.path.join(dirpath, name)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or '']
                else:
                    continue
                for m in mods:
                    top = m.split('.')[0]
                    assert top not in ('jax', 'jaxlib', 'pylabfea_tpu'), \
                        f'{path} imports {m}'


def test_cpu_tensors_take_plain_versions_without_launch():
    Kp = torch.rand(8, 8, 4, 3, dtype=torch.float64)
    u0, u1 = (torch.rand(5, 4, dtype=torch.float64) for _ in range(2))
    n0 = stencil.k_apply.launches
    out = stencil.k_apply(Kp, u0, u1)
    ref = stencil.k_apply_plain(Kp, u0, u1)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    x, sv, dc = torch.rand(7, 6), torch.rand(5, 6), torch.rand(5)
    counts = [c.launches for c in (sk.svc_f_grad, sk.svc_decision,
                                   sk.svc_f_grad_mm, rootfind.brent_step)]
    f, g = sk.svc_f_grad(x, sv, dc, 2.5, 0.1)
    fr, gr = sk.svc_f_grad_plain(x, sv, dc, 2.5, 0.1)
    assert torch.equal(f, fr) and torch.equal(g, gr)
    assert torch.equal(sk.svc_decision(x, sv, dc, 2.5, 0.1), fr)
    fm, gm = sk.svc_f_grad_mm(x, sv, dc, 2.5, 0.1)
    assert torch.equal(fm, fr) and torch.equal(gm, gr)
    st = {k: torch.rand(7) for k in rootfind.STATE}
    st.update(done=torch.rand(7) < 0.5, ok=torch.zeros(7, dtype=torch.bool))
    new = rootfind.brent_step(st, 1e-5, 1e-15)
    ref = rootfind.brent_step_plain(st, 1e-5, 1e-15)
    assert all(torch.equal(new[k], ref[k]) for k in rootfind.STATE)
    assert stencil.k_apply.launches == n0
    assert [c.launches for c in (sk.svc_f_grad, sk.svc_decision,
                                 sk.svc_f_grad_mm, rootfind.brent_step)] \
        == counts


def test_other_devices_raise_instead_of_falling_back():
    meta = dict(device='meta')
    with pytest.raises(TypeError):
        stencil.k_apply(torch.empty(8, 8, 4, 3, **meta),
                        torch.empty(5, 4, **meta), torch.empty(5, 4, **meta))
    for fn in (sk.svc_f_grad, sk.svc_decision, sk.svc_f_grad_mm):
        with pytest.raises(TypeError):
            fn(torch.empty(7, 6, **meta), torch.empty(5, 6, **meta),
               torch.empty(5, **meta), 2.5, 0.1)
    with pytest.raises(TypeError):
        rootfind.brent_step({k: torch.empty(5, **meta)
                             for k in rootfind.STATE}, 1e-5, 1e-15)
    with pytest.raises(TypeError):
        sk.svc_yf_root(torch.empty(7, 6, **meta), torch.empty(7, **meta),
                       torch.empty(7, **meta), torch.empty(5, 6, **meta),
                       torch.empty(5, **meta), 2.5, 0.1, sk.FeatureMap(150.))
    with pytest.raises(TypeError):
        volume.k_apply3(torch.empty(36, 2, 2, 2, **meta),
                        *(torch.empty(3, 3, 3, **meta) for _ in range(3)),
                        1., 1., 1.)


def test_build_key_tracks_sources_and_flags(tmp_path, monkeypatch):
    srcs = build._sources()
    stems = ('svc_fgrad', 'kapply2d', 'kapply3d', 'svc_decision',
             'svc_fgrad_mm', 'brent_step', 'yf_root')
    assert {s.name for s in srcs} == {f'{k}.cu' for k in stems}
    assert build._key(srcs) == build._key(list(srcs))
    assert len({build._library(s) for s in srcs}) == len(srcs)
    assert 'arch=compute_90a,code=sm_90a' in build.NVCC_FLAGS
    assert set(build.SIGNATURES) == {
        f'pylabfea_{k}_{t}' for k in stems for t in ('f32', 'f64')}
    # the shared headers are part of the key of every source that
    # includes them, and of no other
    uses = {s.stem: {h.name for h in build._headers(s)} for s in srcs}
    assert uses['svc_decision'] == uses['svc_fgrad'] \
        == uses['svc_fgrad_mm'] == {'svc_eval.cuh', 'fp_ops.cuh'}
    assert uses['brent_step'] == {'brent_body.cuh', 'fp_ops.cuh'}
    assert uses['yf_root'] == {'svc_eval.cuh', 'brent_body.cuh',
                               'fp_ops.cuh'}
    assert uses['kapply2d'] == uses['kapply3d'] == set()
    for s in srcs:
        (tmp_path / s.name).write_bytes(s.read_bytes())
    for h in build.CSRC_DIR.glob('*.cuh'):
        (tmp_path / h.name).write_bytes(h.read_bytes())
    monkeypatch.setattr(build, 'CSRC_DIR', tmp_path)
    copies = build._sources()
    before = {s.stem: build._key([s]) for s in copies}
    assert before == {s.stem: build._key([s]) for s in srcs}
    with open(tmp_path / 'svc_eval.cuh', 'a') as fh:
        fh.write('// edited\n')
    after = {s.stem: build._key([s]) for s in copies}
    assert {k for k in after if after[k] != before[k]} \
        == {'svc_fgrad', 'svc_decision', 'svc_fgrad_mm', 'yf_root'}
    with open(tmp_path / 'fp_ops.cuh', 'a') as fh:
        fh.write('// edited\n')
    again = {s.stem: build._key([s]) for s in copies}
    assert {k for k in again if again[k] != after[k]} \
        == set(stems) - {'kapply2d', 'kapply3d'}


_PARALLEL_PROBE = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import stencil, volume
from pylabfea_tpu_torch.parallel import (distributed, launch, runs, sharded,
                                         sharded3)
one = distributed.RankMesh()
cpu = torch.device('cpu')
res = runs.suite(one, cpu, [
    dict(kind='strip_step', NX=8, NY=8, eps=0.002, dtype='float64',
         mats='svc', load_frac=0.5, n_inner=1),
    dict(kind='slab', NX=2, NY=2, NZ=2, eps=0.002, dtype='float64',
         mats='j2', nsteps=1, n_inner=1)])
assert stencil.k_apply.launches == volume.k_apply3.launches == 0
bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')
             or m == 'pylabfea_tpu' or m.startswith('pylabfea_tpu.'))
assert not bad, bad
print('clean', res[0]['glob_sig'][1], res[1]['glob_sig'][-1][2])
"""


def test_parallel_runs_on_the_cpu_without_jax_or_launch():
    """The domain decomposition at world size 1 on CPU tensors: the plain
    versions, no kernel launch, no JAX module imported."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', _PARALLEL_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith('clean')


def test_parallel_meshes_default_to_the_card(monkeypatch):
    """Without ``device`` the strip and slab meshes and a multi-process
    ``init_multihost`` ask for the card; where none is visible they raise
    instead of building on the CPU."""
    from pylabfea_tpu_torch.parallel import distributed, sharded, sharded3
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    one = distributed.RankMesh()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sharded.StripMesh(4, 4, mesh=one)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sharded3.SlabMesh3(2, 2, 2, mesh=one)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        distributed.init_multihost('127.0.0.1:1', 2, 0)
    assert sharded.StripMesh(4, 4, mesh=one,
                             device='cpu').md_loc.B.device.type \
        == sharded3.SlabMesh3(2, 2, 2, mesh=one,
                              device='cpu').md_loc.B.device.type == 'cpu'


def test_launcher_defaults_to_the_card(monkeypatch):
    """``launch.spawn`` without devices places its ranks on the card (one
    card a rank under NCCL where as many are visible, else every rank on
    card 0 under Gloo) and, where no card is visible, raises before it
    starts a process; the CPU runs only when the caller lists it."""
    from pylabfea_tpu_torch.parallel import launch, runs
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        launch.spawn(runs.suite, 2, args=([],))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        launch.placement(2)
    assert launch.placement(2, ['cpu'] * 2) == (['cpu', 'cpu'], 'gloo')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert launch.placement(4) == (
        ['cuda:0', 'cuda:1', 'cuda:2', 'cuda:3'], 'nccl')
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert launch.placement(2) == (['cuda:0', 'cuda:0'], 'gloo')


def test_parallel_applies_raise_instead_of_falling_back():
    """The strip and slab applies hand a tensor that is neither on the CPU
    nor on the card to their kernel's wrapper, which raises: no quiet
    plain version."""
    from pylabfea_tpu_torch.parallel import distributed, sharded, sharded3
    one = distributed.RankMesh()
    meta = dict(device='meta', dtype=torch.float32)
    sm = sharded.StripMesh(4, 3, mesh=one, device='cpu')
    fixed = tuple(torch.zeros(5, 4, dtype=torch.bool, device='meta')
                  for _ in range(2))
    with pytest.raises(TypeError):
        sharded.apply_planes(sm, torch.empty(8, 8, 4, 3, **meta),
                             tuple(torch.empty(5, 4, **meta)
                                   for _ in range(2)), fixed)
    sl = sharded3.SlabMesh3(2, 2, 2, mesh=one, device='cpu')
    with pytest.raises(TypeError):
        fe3d._k_apply3_raw(sl.md_loc, torch.empty(36, 2, 2, 2, **meta),
                           tuple(torch.empty(3, 3, 3, **meta)
                                 for _ in range(3)))


_ELEMENT_PROBE = """
import os
import sys
import tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from pylabfea_tpu_torch.ops import fe3d, stencil, svc_kernels, volume
from pylabfea_tpu_torch.parallel import distributed, mesh, mesh3d, runs
from pylabfea_tpu_torch.utils import checkpoint, profiling
one = mesh.make_mesh(device='cpu')
assert one == distributed.RankMesh()
deps = np.full((2, 4, 6), 5e-4)
deps[1, :, 1] *= -1.
res = runs.suite(one, torch.device('cpu'), [
    dict(kind='elem2d', NX=4, NY=4, eps=0.002, dtype='float64', mats='svc',
         fracs=[0.5], n_inner=1),
    dict(kind='elem3d', NX=2, NY=2, NZ=2, eps=0.002, dtype='float64',
         mats='j2', fracs=[0.5], n_inner=1),
    dict(kind='fit', deps=deps, sig=deps * 2e5, CV=np.eye(6) * 2e5,
         steps=1, dtype='float64')])
md3 = fe3d.box_mesh(2, 2, 2, dtype=torch.float64, device='cpu')
st3 = fe3d.init_state3(md3, np.eye(6), dtype=torch.float64)
vols = fe3d.field_volumes(md3, st3)
timer = profiling.StepTimer(device='cpu')
with tempfile.TemporaryDirectory() as tmp:
    with timer.step(), profiling.trace(tmp, device='cpu'):
        checkpoint.save_state(os.path.join(tmp, 's.npz'), st3)
    back, _ = checkpoint.load_state(os.path.join(tmp, 's.npz'), device='cpu')
assert torch.equal(back.elstiff, st3.elstiff)
assert stencil.k_apply.launches == volume.k_apply3.launches == 0
assert svc_kernels.svc_f_grad.launches == svc_kernels.svc_decision.launches \\
    == 0
bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')
             or m == 'pylabfea_tpu' or m.startswith('pylabfea_tpu.'))
assert not bad, bad
print('clean', res[0]['glob_sig'][0][1], res[1]['glob_sig'][0][2],
      res[2]['sy'], float(vols['seq'].sum()), timer.summary()['steps'])
"""


def test_element_sharding_and_utils_run_on_the_cpu_without_jax_or_launch():
    """The element-sharded steps, the path-sharded fit, the checkpoint
    and profiling utilities and ``field_volumes`` on CPU tensors: the
    plain versions, no kernel launch, no JAX module imported."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', _ELEMENT_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith('clean')


def test_element_sharding_and_utils_default_to_the_card(monkeypatch,
                                                        tmp_path):
    """Without ``device`` the element meshes, ``load_state``, the profiling
    utilities and a path-sharded ``fit_plasticity`` on host data ask for
    the card; where none is visible they raise instead of running on the
    CPU, which they do only when the caller lists it."""
    from pylabfea_tpu_torch.parallel import distributed, mesh, mesh3d
    from pylabfea_tpu_torch.utils import checkpoint, profiling
    one = distributed.RankMesh()
    md = fe_kernels.rect_mesh(4, 4, device='cpu')
    md3 = fe3d.box_mesh(2, 2, 2, device='cpu')
    path = str(tmp_path / 's.npz')
    checkpoint.save_state(path, fe3d.init_state3(md3, np.eye(6)))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (lambda: mesh.make_mesh(), lambda: mesh3d.make_mesh3(),
                 lambda: mesh.shard_mesh_data(md, one),
                 lambda: mesh3d.shard_mesh_data3(md3, one),
                 lambda: checkpoint.load_state(path),
                 lambda: profiling.StepTimer(),
                 lambda: profiling.trace(str(tmp_path)).__enter__(),
                 lambda: calibrate.fit_plasticity(
                     np.ones((1, 4, 6)), np.ones((1, 4, 6)), np.eye(6),
                     ranks=one)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
    assert mesh.shard_mesh_data(md, one, 'cpu').dofs.device.type == 'cpu'
    assert mesh3d.shard_mesh_data3(md3, one, 'cpu').B.device.type == 'cpu'
    assert checkpoint.load_state(path, device='cpu')[0].u.device.type \
        == 'cpu'


_HOST_PROBE = """
import importlib
import importlib.abc
import sys
BLOCKED = ('jax', 'jaxlib', 'pylabfea_tpu', 'sklearn', 'matplotlib',
           'tkinter')


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'No module named {name!r} (refused)')
        return None


sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
torch.set_num_threads(1)
import pylabfea_tpu_torch as FE
for m in ('core', 'core.tensors', 'training', 'materials', 'femodel',
          'dataio', 'gui', 'bridge', 'ml_train', 'utils.checkpoint',
          'utils.native', 'ops.svc', 'ops.rootfind'):
    importlib.import_module('pylabfea_tpu_torch.' + m)
mat_h = FE.Material(name='Hill-reference')
mat_h.elasticity(E=200.e3, nu=0.3)
mat_h.plasticity(sy=50., rv=[1.2, 1., 0.8, 1., 1., 1.], sdim=6)
mat_ml = FE.Material(name='Hill-ML')
score, _ = mat_ml.train_SVC(C=4, gamma=1.5, mat_ref=mat_h, Nlc=12, Nseq=4,
                            Fe=0.3, Ce=0.95, backend='jax', device='cpu')
mat_ml.dev_only = False
try:
    FE.Material().train_SVC(mat_ref=mat_h, Nlc=4, Nseq=2)
    refused = False
except ImportError as err:
    refused = 'refused' in str(err)
mat_el = FE.Material(name='elastic inclusion')
mat_el.elasticity(E=600.e3, nu=0.3)


def model():
    fem = FE.Model(dim=2, planestress=False)
    fem.geom([2., 2., 2.], LY=2.)
    fem.assign([mat_h, mat_el, mat_ml])
    fem.bcleft(0.)
    fem.bcbot(0.)
    fem.bcright(0., 'force')
    fem.bctop(0.002 * fem.leny, 'disp')
    fem.mesh(NX=6, NY=2)
    return fem


host = model()
host.solve()
host.calc_global()
dev = model()
FE.bridge.solve_on_device_adaptive(dev, device='cpu')
assert len(dev.sgl) == len(host.sgl)
assert np.abs(dev.u - host.u).max() < 1e-7
bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not bad, bad
print('clean', score, refused, host.glob['sig'][1], dev.glob['sig'][1])
"""


def test_host_profile_runs_where_jax_and_sklearn_are_missing():
    """The card's machine simulated: an import hook refuses ``jax``,
    ``pylabfea_tpu`` (the JAX package, not the port), ``sklearn``,
    ``matplotlib`` and ``tkinter``.  Every new module imports, and
    ``examples/train_hill.py``'s workflow runs at a tiny size on the CPU:
    ``train_SVC(backend='jax', device='cpu')`` on 12 load cases x 4
    levels, the 6 x 2 laminate's ``Model.solve()``, then
    ``bridge.solve_on_device_adaptive`` (faithful, f64) with the host's
    increments and its displacements within 1e-7; the default
    ``backend='sklearn'`` raises the refused import instead of switching
    to the card's trainer."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', _HOST_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout.splitlines()[-1].split()
    assert out[0] == 'clean' and float(out[1]) >= 95. and out[2] == 'True'


def test_host_profile_asks_for_the_card(monkeypatch):
    """Without ``device`` the host profile's hooks into the port (the
    ``backend='jax'`` fit and grid search, ``compress_svc``,
    ``Data.fit_material``) ask for the card and raise where none is
    visible; no module of the port imports scikit-learn, matplotlib or
    tkinter at module level."""
    import pylabfea_tpu_torch as FE
    from pylabfea_tpu_torch.ops import svc as tsvc
    ref = FE.Material()
    ref.elasticity(E=200.e3, nu=0.3)
    ref.plasticity(sy=50., sdim=6)
    mat = FE.Material()
    mat.elasticity(CV=ref.CV)
    mat.plasticity(sy=50., sdim=6)
    x, y = mat.create_sig_data(N=6, mat_ref=ref, Nseq=2)
    mat.train_SVC(C=4, gamma=1.5, mat_ref=ref, Nlc=6, Nseq=2,
                  backend='jax', device='cpu')
    assert isinstance(mat._svc, tsvc.SVCParams)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (lambda: mat.train_SVC(C=4, gamma=1.5, mat_ref=ref, Nlc=6,
                                       Nseq=2, backend='jax'),
                 lambda: mat.setup_yf_SVM(x, y, backend='jax'),
                 lambda: mat.setup_yf_SVM_6D(x, y, backend='jax',
                                             gridsearch=True, cvals=[1.],
                                             gvals=[1.]),
                 lambda: mat.compress_svc(nsv=4)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
    db = FE.Data.__new__(FE.Data)
    db.mat_data = {'Name': 'db'}
    db.lc_data = {'a': {'Stress': np.ones((5, 6)),
                        'Strain_Total': np.cumsum(np.ones((5, 6)), 0)}}
    with pytest.raises(RuntimeError, match='no CUDA device'):
        db.fit_material(shear_convention='engineering')
    lazy = ('sklearn', 'matplotlib', 'tkinter')
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith('.py'):
                continue
            path = os.path.join(dirpath, name)
            for node in ast.parse(open(path).read(), path).body:
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or '']
                else:
                    continue
                assert not any(m.split('.')[0] in lazy for m in mods), \
                    f'{path} imports {mods} at module level'
