"""PyTorch port: the 3-D x-slab domain decomposition (``parallel.sharded3``)
against the JAX package's ``parallel/sharded3.py``: rank r's slab against
JAX's block r at world size 4 (4 Gloo ranks on the CPU; JAX on 4 of the 8
virtual CPU devices, results committed in
``pylabfea_tpu_torch/data/parallel_slab.npz`` by
``tools/make_torch_parallel_fixtures.py``).  An 8 x 4 x 4 box on 4 slabs
puts NXd = 2 element layers on each.  Float64 within 1e-10, float32
within the JAX test's 1e-4 of the stress scale; the duplicated boundary
planes bitwise equal on both ranks."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.parallel import sharded3 as jsh3
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import fe3d as tfe3d
from pylabfea_tpu_torch.parallel import launch, runs
from pylabfea_tpu_torch.parallel import sharded3 as tsh3
from pylabfea_tpu_torch.parallel.distributed import RankMesh

# One torch thread: the suite runs several test processes at once (the
# spawned ranks take one each too).
torch.set_num_threads(1)

W = 4
N3 = dict(NX=8, NY=4, NZ=4)
FIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pylabfea_tpu_torch', 'data', 'parallel_slab.npz')
T64 = dict(dtype=torch.float64, device='cpu')


@pytest.fixture(scope='module')
def fix():
    with np.load(FIX) as z:
        return {k: z[k] for k in z.files}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _case(fix, tag, eps=0.002, **kw):
    n = int(fix[f'{tag}.nmat'])
    items = []
    for k in range(n):
        pre = f'{tag}.m{k}.'
        items.append({m[len(pre):]: fix[m] for m in fix if m.startswith(pre)})
    case = dict(kind='slab', eps=eps, mats=items,
                CVs=[fix[f'{tag}.CV{k}'] for k in range(n)], **N3, **kw)
    if f'{tag}.mat_map' in fix:
        case['mat_map'] = fix[f'{tag}.mat_map']
    return case


def _errs(fix, tag, res):
    """Rank r's slab against JAX's block r: (fields, glob_sig history)."""
    return (max(_rel(np.stack([r['sig'] for r in res]), fix[f'{tag}.sig']),
                _rel(np.stack([r['u'] for r in res], 1), fix[f'{tag}.u'])),
            _rel(res[0]['glob_sig'], fix[f'{tag}.glob_sig']))


def _dup_bitwise(res):
    for r in range(len(res) - 1):
        np.testing.assert_array_equal(res[r]['u'][:, -1],
                                      res[r + 1]['u'][:, 0])


def _spawn(cases):
    return list(zip(*launch.spawn(runs.suite, W, 'gloo', ['cpu'] * W,
                                  (cases,))))


def test_slab_float64_matches_jax(fix):
    """An elastic step (eps 0.001, effectively infinite sy) and two plastic
    steps (J2 + khard 500, n_inner 1), float64: u, sig and the glob_sig
    history within 1e-10 of JAX's blocks, the same CG iteration counts,
    the duplicated planes bitwise equal."""
    el, pl = _spawn([_case(fix, 'elastic64', dtype='float64', nsteps=1,
                           n_inner=1, eps=0.001),
                     _case(fix, 'plastic64', dtype='float64', nsteps=2,
                           n_inner=1)])
    for tag, res in (('elastic64', el), ('plastic64', pl)):
        err, gerr = _errs(fix, tag, res)
        assert err <= 1e-10 and gerr <= 1e-10, tag
        assert res[0]['cg_iters'] == list(fix[f'{tag}.cg_iters']), tag
        _dup_bitwise(res)


def test_slab_float32_and_inclusion_match_jax(fix):
    """Two float32 plastic steps with n_inner 2 (the glob_sig history
    within the JAX test's 1e-4 of its scale, plastic strain within 1e-6)
    and the float64 stiff inclusion (masked multi-pass return map; within
    1e-10, the inclusion's elements elastic)."""
    pl, inc = _spawn([_case(fix, 'plastic32', dtype='float32', nsteps=2,
                            n_inner=2),
                      _case(fix, 'incl64', dtype='float64', nsteps=2,
                            n_inner=1)])
    gs = fix['plastic32.glob_sig']
    assert np.abs(pl[0]['glob_sig'] - gs).max() <= 1e-4 * np.abs(gs).max()
    epl = np.stack([r['epl'] for r in pl])
    assert np.abs(epl).max() > 1e-4
    assert np.abs(epl - fix['plastic32.epl']).max() <= 1e-6
    err, gerr = _errs(fix, 'incl64', inc)
    assert err <= 1e-10 and gerr <= 1e-10
    ids = fix['incl64.mat_map'].reshape(W, -1)
    epl = np.stack([r['epl'] for r in inc])
    assert np.abs(epl[ids == 1]).max() < 1e-12
    assert np.abs(epl[ids == 0]).max() > 1e-5
    _dup_bitwise(inc)


@pytest.mark.parametrize('pos', range(W))
def test_slab_blocks_match_jax(pos):
    """Rank r's BC volumes and ownership weights equal JAX's block r, its
    initial tangent volumes and element rows the global ones' slab r (built
    without collectives)."""
    js = jsh3.SlabMesh3(8, 4, 4, uniax='z', eps_tot=0.002, n_devices=W,
                        dtype=jnp.float64)
    ts = tsh3.SlabMesh3(8, 4, 4, uniax='z', eps_tot=0.002,
                        mesh=RankMesh(tuple(range(W)), pos), **T64)
    for name in ('fixed', 'fixed_val', 'force', 'own'):
        for c in range(3):
            np.testing.assert_array_equal(
                getattr(ts, name)[c].numpy(),
                np.asarray(getattr(js, name)[c])[pos], err_msg=name)
    rows = np.random.default_rng(pos).normal(size=(8 * 4 * 4, 6, 6))
    np.testing.assert_array_equal(ts.elstiff_blocks(rows).numpy(),
                                  np.asarray(js.elstiff_blocks(rows))[pos])
    np.testing.assert_array_equal(ts.shard_elements(rows).numpy(),
                                  np.asarray(js.shard_elements(rows))[pos])
    assert ts.md_loc.grid == tuple(js.md_loc.grid)


def test_one_slab_matches_fe3d():
    """World size 1: two plastic steps of the slab solver land within 1e-9
    of the port's unsharded ``fe3d.solve_uniaxial3`` (float64, 4^3): the
    glob_sig history, the stresses and the displacements."""
    j2 = convert.material_from_params(dict(hill=np.ones(6), sy=150.,
                                           khard=500., drucker=0.),
                                      is_svc=False, **T64)
    CV = convert.elastic_cv(200.e3, 0.3)
    md = tfe3d.box_mesh(4, 4, 4, eps_tot=0.002, **T64)
    st, h1 = tfe3d.solve_uniaxial3(md, j2, CV, nsteps=2, n_inner=1)
    sm = tsh3.SlabMesh3(4, 4, 4, eps_tot=0.002, mesh=RankMesh(), **T64)
    sig, _, u, h2 = tsh3.solve_uniaxial3_slab(sm, j2, CV, nsteps=2,
                                              n_inner=1)
    assert _rel(h2[-1][0].numpy(), h1[-1][0].numpy()) <= 1e-9
    assert _rel(sig.numpy(), st.sig.numpy()) <= 1e-9
    assert _rel(torch.stack(u).numpy(), st.u.numpy()) <= 1e-9
