"""PyTorch port: the x-strip domain decomposition (``parallel.sharded``)
against the JAX package's ``parallel/sharded.py``, rank r's block against
JAX's block r at world size 4 (4 Gloo ranks on the CPU, JAX on 4 of the 8
virtual CPU devices of ``conftest.py``).

The elastic halo K-apply and CG run live in JAX; the plastic, Schwarz and
grouped multi-material steps are held against the JAX results committed
in ``pylabfea_tpu_torch/data/parallel_strip.npz``
(``tools/make_torch_parallel_fixtures.py``).  Float64 within 1e-10 (the
elastic case 1e-12), float32 within the JAX test's own bound; the
duplicated boundary columns bitwise equal on both ranks."""
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.parallel import sharded as jsh
from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import fe_kernels as tfek
from pylabfea_tpu_torch.parallel import launch, runs
from pylabfea_tpu_torch.parallel import sharded as tsh
from pylabfea_tpu_torch.parallel.distributed import RankMesh

# One torch thread: the suite runs several test processes at once (the
# spawned ranks take one each too).
torch.set_num_threads(1)

W = 4
FIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pylabfea_tpu_torch', 'data', 'parallel_strip.npz')
T64 = dict(dtype=torch.float64, device='cpu')
#: the JAX test's 3-material inclusion BCs (tests/test_sharded_strip.py)
INCL_BC = {'bot': {1: ('disp', 0.)}, 'top': {1: ('disp', 0.0025 * 2.)},
           'nodes': ((0, 0, 0, 'disp', 0.),)}


@pytest.fixture(scope='module')
def fix():
    with np.load(FIX) as z:
        return {k: z[k] for k in z.files}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _mats(fix, tag):
    """The fixture's materials as ``runs`` case entries."""
    items = []
    for k in range(int(fix[f'{tag}.nmat'])):
        pre = f'{tag}.m{k}.'
        items.append({n[len(pre):]: fix[n] for n in fix if n.startswith(pre)})
    return dict(mats=items, CVs=[fix[f'{tag}.CV{k}']
                                 for k in range(int(fix[f'{tag}.nmat']))])


def _dup_bitwise(res, key='du'):
    for r in range(len(res) - 1):
        np.testing.assert_array_equal(res[r][key][:, -1],
                                      res[r + 1][key][:, 0])


def _step(fix, tag, res):
    """Rank r's step against JAX's block r."""
    return (max(_rel(np.stack([r['sig'] for r in res]), fix[f'{tag}.sig']),
                _rel(np.stack([r['du'] for r in res], 1), fix[f'{tag}.du'])),
            _rel(res[0]['glob_sig'], fix[f'{tag}.glob_sig']))


def _spawn(cases):
    return list(zip(*launch.spawn(runs.suite, W, 'gloo', ['cpu'] * W,
                                  (cases,))))


def test_elastic_halo_apply_and_cg_match_jax():
    """The BC lift through the halo K-apply and the Jacobi-CG solve at
    16 x 8, float64: every block within 1e-12 of JAX's, the same
    iteration count, the duplicated columns bitwise equal."""
    (res,) = _spawn([dict(kind='strip_elastic', NX=16, NY=8, eps=0.002,
                          dtype='float64')])
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    sm = jsh.StripMesh(16, 8, LX=4., LY=1., uniax='y', eps_tot=0.002,
                       n_devices=W, dtype=jnp.float64)
    CV = convert.elastic_cv(200.e3, 0.3)

    @partial(shard_map, mesh=sm.mesh, in_specs=(P('x'), (P('x'), P('x'))),
             out_specs=(P('x'), P('x')))
    def dcalc(el_loc, fixed_loc):
        Kp = jsh.element_Ke_planes(sm, el_loc[0])
        d = jsh._scatter_local(tuple(Kp[i, i] for i in range(8)), sm.NXd,
                               sm.NY, sm.nnY)
        d = jsh._halo_accumulate(d)
        return tuple(jnp.where(f[0], 1., x)[None]
                     for f, x in zip(fixed_loc, d))

    @jax.jit     # one program: shard_map run op by op compiles every op
    def run(el):
        du_bc = tuple(jnp.where(f, b, 0.)
                      for f, b in zip(sm.fixed, sm.fixed_val))
        neg = jsh.make_k_apply(sm)(el, du_bc, tuple(jnp.zeros_like(f)
                                                    for f in sm.fixed))
        rhs = tuple(jnp.where(f, b, -q)
                    for f, b, q in zip(sm.fixed, sm.fixed_val, neg))
        du, _, it = jsh.cg_solve_strip(sm, el, rhs, du_bc,
                                       dcalc(el, sm.fixed), tol=1e-12,
                                       maxiter=5000)
        return neg, du, it

    neg, du, it = run(sm.shard_elements(
        np.broadcast_to(CV, (128, 6, 6)).copy()))
    jneg = np.stack([np.asarray(x) for x in neg], 1)
    jdu = np.stack([np.asarray(x) for x in du], 1)
    for r, out in enumerate(res):
        assert _rel(out['neg'], jneg[r]) <= 1e-12
        assert _rel(out['du'], jdu[r]) <= 1e-12
        assert out['it'] == int(it)
    _dup_bitwise(res)
    _dup_bitwise(res, 'neg')


def test_plastic_steps_match_jax(fix):
    """One 0.5 step at 32 x 8 with the trained SVC, two-level Schwarz:
    float64 (CG to 1e-12) blocks within 1e-10 of JAX's; float32 glob_sig
    within the JAX test's 5e-3 (there against the unsharded step)."""
    base = dict(kind='strip_step', NX=32, NY=8, LX=4., LY=1., eps=0.002,
                mats='svc', load_frac=0.5, n_inner=2)
    res64, res32 = _spawn([dict(base, dtype='float64', cg_tol=1e-12),
                           dict(base, dtype='float32')])
    err, gerr = _step(fix, 'plastic64', res64)
    assert err <= 1e-10 and gerr <= 1e-10
    assert res64[0]['cg_iters'] == int(fix['plastic64.cg_iters'])
    _, gerr32 = _step(fix, 'plastic32', res32)
    assert gerr32 <= 5e-3
    _dup_bitwise(res64)


def test_two_level_schwarz_iteration_counts(fix):
    """Jacobi against two-level Schwarz at 32 x 16 on 4 strips, float64,
    CG to 1e-12:
    JAX's CG iteration counts of the last solve, the coarse space cutting
    them below 40 from above 40 (tests/test_sharded_strip.py's property),
    the same answer within 1e-10 of JAX's."""
    base = dict(kind='strip_step', NX=32, NY=16, LX=4., LY=1., eps=0.002,
                mats='svc', load_frac=0.5, n_inner=2, dtype='float64',
                cg_tol=1e-12)
    r0, r2 = _spawn([dict(base, schwarz=0), dict(base, schwarz=2)])
    for tag, res in (('schwarz0', r0), ('schwarz2', r2)):
        err, gerr = _step(fix, tag, res)
        assert err <= 1e-10 and gerr <= 1e-10, tag
        assert res[0]['cg_iters'] == int(fix[f'{tag}.cg_iters']), tag
    assert r2[0]['cg_iters'] < 40 < r0[0]['cg_iters']


def test_grouped_inclusion_matches_jax(fix):
    """The JAX test's 3-material inclusion (free lateral edges, corner
    pin) at 32 x 16, float64: the grouped return map's blocks within 1e-10
    of JAX's, and the masked multi-pass (``grouped=False``) equal to it
    within 1e-9 of the stress scale."""
    mm = fix['incl64.mat_map']
    base = dict(kind='strip_step', NX=32, NY=16, LX=4., LY=2., eps=0.,
                dtype='float64', bc=INCL_BC, mat_map=mm, load_frac=0.8,
                n_inner=3, cg_tol=1e-10, **_mats(fix, 'incl64'))
    grouped, masked = _spawn([base, dict(base, grouped=False)])
    err, gerr = _step(fix, 'incl64', grouped)
    assert err <= 1e-10 and gerr <= 1e-10
    sig_g = np.stack([r['sig'] for r in grouped])
    sig_m = np.stack([r['sig'] for r in masked])
    assert np.abs(sig_g - sig_m).max() <= 1e-9 * np.abs(sig_g).max()
    _dup_bitwise(grouped)


@pytest.mark.parametrize('pos', range(W))
def test_strip_blocks_match_jax(pos):
    """Rank r's BC planes, ownership weights and material ids equal
    JAX's block r, and its material blocks the rows that JAX's
    capacity-padded group tables select on block r (built without
    collectives)."""
    NX, NY = 16, 4
    mm = np.zeros((NX, NY), dtype=int)
    mm[NX // 2:, :] = 1
    mm[3:5, 1:3] = 2
    bc = {'left': {0: ('disp', 0.)}, 'bot': {1: ('disp', 0.)},
          'top': {1: ('force', 40.)}, 'nodes': [(2, 3, 0, 'disp', 0.)]}
    mesh = RankMesh(tuple(range(W)), pos)
    for kw in (dict(mat_map=mm), dict(bc=bc)):
        js = jsh.StripMesh(NX, NY, eps_tot=0.002, n_devices=W,
                           dtype=jnp.float64, **kw)
        ts = tsh.StripMesh(NX, NY, eps_tot=0.002, mesh=mesh, **T64, **kw)
        for name in ('fixed', 'fixed_val', 'force', 'own'):
            for c in range(2):
                np.testing.assert_array_equal(
                    getattr(ts, name)[c].numpy(),
                    np.asarray(getattr(js, name)[c])[pos], err_msg=name)
    assert ts.mat_ids is None and ts.md_loc.groups is None
    js = jsh.StripMesh(NX, NY, n_devices=W, mat_map=mm)
    ts = tsh.StripMesh(NX, NY, mesh=mesh, mat_map=mm, **T64)
    np.testing.assert_array_equal(ts.mat_ids.numpy(),
                                  np.asarray(js.mat_ids)[pos])
    perm = ts.md_loc.perm.numpy()
    inv = np.asarray(js.group_inv)[pos]
    off = 0
    for k, (a, n) in enumerate(ts.md_loc.groups):
        idx = np.asarray(js.group_idx[k])[pos]
        assert n == np.sum(ts.mat_ids.numpy() == k) <= js.group_caps[k]
        np.testing.assert_array_equal(perm[a:a + n], idx[:n])
        np.testing.assert_array_equal(inv[perm[a:a + n]],
                                      off + np.arange(n))
        off += js.group_caps[k]
    np.testing.assert_array_equal(ts.md_loc.inv_perm.numpy()[perm],
                                  np.arange(len(perm)))


def test_one_rank_matches_unsharded():
    """World size 1 (no process group): the two-level Schwarz strip step
    on a 32 x 32 mesh with a two-level strip hierarchy (which JAX's
    shard_map cannot trace) lands within 1e-9 of the port's unsharded
    ``load_step_split`` from the same state, float64; a mesh that the
    ranks do not divide raises."""
    mat, CV, _ = convert.material_from_npz(runs.workloads.NPZ, **T64)
    md = tfek.rect_mesh(32, 32, eps_tot=0.002, **T64)
    _, d1 = tfek.load_step_split(md, tfek.init_state(md, CV, torch.float64),
                                 mat, CV, 0.5, n_inner=2, cg_tol=1e-12)
    sm = tsh.StripMesh(32, 32, eps_tot=0.002, mesh=RankMesh(), **T64)
    el = sm.shard_elements(np.broadcast_to(CV, (32 * 32, 6, 6)).copy())
    z = torch.zeros((32 * 32, 6), dtype=torch.float64)
    _, _, _, d2 = tsh.strip_load_step(sm, el, z, z, mat, 0.5, 2, 1e-12)
    assert _rel(d2['glob_sig'].numpy(), d1['glob_sig'].numpy()) <= 1e-9
    with pytest.raises(ValueError, match='divisible'):
        tsh.StripMesh(30, 8, mesh=RankMesh((0, 1, 2, 3), 0), **T64)


def test_schwarz_hierarchy_built_once_a_solve():
    """The port builds the strip-local hierarchy once a solve; JAX builds
    it at every application from the same tangents.  Both give the same
    bits."""
    mat, CV, _ = convert.material_from_npz(runs.workloads.NPZ, **T64)
    sm = tsh.StripMesh(32, 32, eps_tot=0.002, mesh=RankMesh(), **T64)
    rng = np.random.default_rng(3)
    el = sm.shard_elements(CV[None] * rng.uniform(0.5, 1.5, (32 * 32, 1, 1)))
    diag = tsh.k_diag_planes(sm, tsh.element_Ke_planes(sm, el))
    prepare = tsh.make_schwarz_two_level(sm, el)
    once = prepare(el, diag)
    for _ in range(2):
        r = tuple(torch.as_tensor(rng.normal(size=(33, 33))) for _ in range(2))
        for a, b in zip(once(r), prepare(el, diag)(r)):
            assert torch.equal(a, b)
