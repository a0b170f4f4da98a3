"""PyTorch port: the checkpoint and profiling utilities and the 3-D field
helpers against the JAX package's: ``save_state`` / ``load_state`` files
cross-load bit for bit both ways (2-D, flat and 3-D states), a newer
format raises; ``StepTimer`` gives JAX's summary on the same notes and
``trace`` writes a Chrome trace on the CPU; ``field_volumes`` matches
JAX's within 1e-12 (float64) and ``plot_midplane`` draws its slice."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import fe3d as jfe3d
from pylabfea_tpu.ops import fe_kernels as jfek
from pylabfea_tpu.utils import checkpoint as jck
from pylabfea_tpu.utils import profiling as jprof
from pylabfea_tpu_torch.ops import fe3d as tfe3d
from pylabfea_tpu_torch.ops import fe_kernels as tfek
from pylabfea_tpu_torch.utils import checkpoint as tck
from pylabfea_tpu_torch.utils import profiling as tprof

# One torch thread: the suite runs several test processes at once.
torch.set_num_threads(1)

FIELDS = ('u', 'sig', 'epl', 'eps', 'elstiff')


def _random_state(shapes, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {f: rng.normal(size=s).astype(dtype) for f, s in shapes.items()}


def _shapes2d(NX=4, NY=3, flat=False):
    nel, nn = NX * NY, (NX + 1) * (NY + 1)
    return dict(u=(2 * nn,) if flat else (2, NX + 1, NY + 1), sig=(nel, 6),
                epl=(nel, 6), eps=(nel, 6),
                elstiff=(nel, 6, 6) if flat else (36, NX, NY))


def _shapes3d(NX=3, NY=2, NZ=2):
    nel = NX * NY * NZ
    return dict(u=(3, NX + 1, NY + 1, NZ + 1), sig=(nel, 6), epl=(nel, 6),
                eps=(nel, 6), elstiff=(36, NX, NY, NZ))


@pytest.mark.parametrize('kind', ['2d', 'flat', '3d', '2d-f32'])
def test_jax_checkpoints_load_in_the_port_bitwise(tmp_path, kind):
    """A state JAX's ``save_state`` wrote loads in the port with every
    array bit for bit, the dtype kept, the meta dict intact, as the 2-D or
    3-D state its displacement's layout names."""
    shapes = _shapes3d() if kind == '3d' else _shapes2d(flat=kind == 'flat')
    dt = np.float32 if kind == '2d-f32' else np.float64
    arrays = _random_state(shapes, 1, dt)
    path = str(tmp_path / 'jax.npz')
    jck.save_state(path, jfek.SolverState(**{f: jnp.asarray(arrays[f])
                                             for f in FIELDS}),
                   meta={'step': 7, 'load': 0.25})
    st, meta = tck.load_state(path, device='cpu')
    assert meta == {'step': 7, 'load': 0.25}
    assert isinstance(st, tfe3d.SolverState3 if kind == '3d'
                      else tfek.SolverState)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(), arrays[f])
        assert getattr(st, f).numpy().dtype == dt
    st32, _ = tck.load_state(path, dtype=torch.float32, device='cpu')
    assert st32.sig.dtype == torch.float32


@pytest.mark.parametrize('kind', ['2d', '3d'])
def test_port_checkpoints_load_in_jax_bitwise(tmp_path, kind):
    """A state the port's ``save_state`` wrote loads in JAX's
    ``load_state`` bit for bit, with its meta dict."""
    shapes = _shapes3d() if kind == '3d' else _shapes2d()
    arrays = _random_state(shapes, 2)
    cls = tfe3d.SolverState3 if kind == '3d' else tfek.SolverState
    path = str(tmp_path / 'port.npz')
    tck.save_state(path, cls(**{f: torch.as_tensor(arrays[f])
                                for f in FIELDS}), meta={'tag': kind})
    st, meta = jck.load_state(path)
    assert meta == {'tag': kind}
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(st, f)), arrays[f])


def test_a_newer_checkpoint_format_raises(tmp_path):
    arrays = _random_state(_shapes2d(), 3)
    path = str(tmp_path / 'new.npz')
    np.savez_compressed(path, __manifest__=json.dumps(
        {'format': 2, 'fields': list(FIELDS), 'meta': {}}), **arrays)
    with pytest.raises(ValueError, match='newer'):
        tck.load_state(path, device='cpu')


def test_step_timer_summary_matches_jax():
    """The same steps noted: JAX's summary keys and counter statistics
    (the step times are each timer's own)."""
    notes = [dict(cg_iters=12, rounds=3), dict(cg_iters=7, rounds=2),
             dict(cg_iters=9)]
    tt, tj = tprof.StepTimer(device='cpu'), jprof.StepTimer()
    for n in notes:
        for timer in (tt, tj):
            with timer.step():
                pass
            timer.note(**n)
    st, sj = tt.summary(), tj.summary()
    assert st.keys() == sj.keys()
    for k in sj:
        if not k.endswith('_s'):
            assert st[k] == sj[k], k
    assert st['steps'] == 3 and st['max_s'] <= st['total_s']
    assert tprof.StepTimer(device='cpu').summary() == {'steps': 0}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / 'tr'), device='cpu'):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / 'tr' / 'trace.json'
    assert path.exists()
    events = json.loads(path.read_text())['traceEvents']
    assert any('mm' in str(e.get('name', '')) for e in events)


def _states3d(seed=4):
    arrays = _random_state(_shapes3d(4, 3, 2), seed)
    arrays['sig'] *= 100.
    arrays['epl'] *= 1e-3
    md_j = jfe3d.box_mesh(4, 3, 2, dtype=jnp.float64)
    md_t = tfe3d.box_mesh(4, 3, 2, dtype=torch.float64, device='cpu')
    return (md_j, jfe3d.SolverState3(**{f: jnp.asarray(arrays[f])
                                        for f in FIELDS}),
            md_t, tfe3d.SolverState3(**{f: torch.as_tensor(arrays[f])
                                        for f in FIELDS}))


def test_field_volumes_match_jax():
    md_j, st_j, md_t, st_t = _states3d()
    vj, vt = jfe3d.field_volumes(md_j, st_j), tfe3d.field_volumes(md_t, st_t)
    assert vt.keys() == vj.keys()
    for k in vj:
        a, b = vt[k].numpy(), np.asarray(vj[k])
        assert a.shape == b.shape == (4, 3, 2), k
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())


def test_plot_midplane_draws_the_midplane_slice():
    mpl = pytest.importorskip('matplotlib')
    mpl.use('Agg')
    import matplotlib.pyplot as plt
    _, _, md_t, st_t = _states3d(5)
    ax = tfe3d.plot_midplane(md_t, st_t, sel='seq', axis='y', show=False)
    img = np.asarray(ax.images[0].get_array())
    seq = tfe3d.field_volumes(md_t, st_t)['seq'].numpy()
    np.testing.assert_array_equal(img, seq[:, 1, :].T)
    assert ax.get_title() == 'seq, y = plane 1'
    with pytest.raises(ValueError, match='unknown field'):
        tfe3d.plot_midplane(md_t, st_t, sel='nope', show=False)
    plt.close('all')
