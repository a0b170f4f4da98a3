"""PyTorch port: the recorder of ``utils/profiling`` on the CPU.  Off by
default, and then a shared no-op that records nothing; a hand-built span
tree's parents, requests and self times; a 16^2 2-D and a 4^3 3-D solve
bit for bit with the recorder on and off (off, with no clock read, no
``record_function`` and no synchronize), their counters against the
solves' own diagnostics, every scalar read of a tensor through
``host_read``; the ``plfea.*`` ranges in ``trace``'s CPU trace and
none under another profiler."""
import json
import sys
from collections import Counter

import pytest
import torch

from pylabfea_tpu_torch import convert, workloads
from pylabfea_tpu_torch.ops import fe3d
from pylabfea_tpu_torch.ops import fe_kernels as fek
from pylabfea_tpu_torch.utils import profiling

# One torch thread: the suite runs several test processes at once.
torch.set_num_threads(1)

#: the ways a tensor hands a scalar to the host
READS = ('__float__', '__bool__', '__int__', 'item')


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    profiling.stop()


def _solve2():
    mat, CV, eps = convert.material_from_npz(workloads.NPZ, device='cpu')
    md = fek.rect_mesh(16, 16, eps_tot=eps, device='cpu')
    state, hist = fek.solve_uniaxial(md, mat, CV, nsteps=2, n_inner=2)
    return state, [h[0] for h in hist]


def _solve3():
    CV = convert.elastic_cv(200.e3, 0.3)
    mat = convert.material_from_params(
        dict(hill=[1.] * 6, sy=150., khard=500., drucker=0.), is_svc=False,
        device='cpu')
    md = fe3d.box_mesh(4, 4, 4, uniax='z', eps_tot=0.002, device='cpu')
    state, hist = fe3d.solve_uniaxial3(md, mat, CV, nsteps=1, n_inner=2)
    return state, [h[0] for h in hist], [h[2] for h in hist]


def test_the_recorder_is_off_by_default_and_then_records_nothing():
    assert not profiling.enabled()
    assert profiling.span('cg') is profiling.span('load_step')
    profiling.start()
    profiling.stop()
    with profiling.span('load_step'), profiling.span('cg'):
        profiling.count('cg_iters', 3)
        assert profiling.host_read(torch.tensor(2.5), 'cg') == 2.5
    assert profiling.spans() == [] and profiling.counters() == {}
    assert profiling.summary() == {}


def test_a_hand_built_span_tree(monkeypatch):
    ticks = iter(range(0, 1000, 10))
    monkeypatch.setattr(profiling, '_now', lambda: next(ticks))
    profiling.start()
    with profiling.span('solve'):                   # 0 .. 90
        with profiling.span('load_step'):           # 10 .. 60
            with profiling.span('cg'):              # 20 .. 50
                profiling.host_read(torch.tensor(True), 'cg')   # 30 .. 40
                profiling.count('cg_iters', 4)
        with profiling.span('load_step'):           # 70 .. 80
            pass
    with profiling.span('return_map', outermost=True):     # 100 .. 130
        with profiling.span('return_map', outermost=True):
            with profiling.span('newton'):          # 110 .. 120
                pass
    profiling.stop()
    sp = {(s.name, s.start_ns): s for s in profiling.spans()}
    assert [(s.name, s.start_ns, s.end_ns) for s in profiling.spans()] == [
        ('solve', 0, 90), ('load_step', 10, 60), ('cg', 20, 50),
        ('host_read', 30, 40), ('load_step', 70, 80),
        ('return_map', 100, 130), ('newton', 110, 120)]
    assert sp[('cg', 20)].parent is sp[('load_step', 10)]
    assert sp[('load_step', 70)].parent is sp[('solve', 0)]
    assert sp[('newton', 110)].parent is sp[('return_map', 100)]
    assert {s.request for s in profiling.spans()[:5]} == {1}
    assert {s.request for s in profiling.spans()[5:]} == {2}
    assert profiling.counters() == {'host_reads': 1, 'host_reads.cg': 1,
                                    'cg_iters': 4}
    summ = {k: (v['count'], round(v['total_s'] * 1e9),
                round(v['self_s'] * 1e9))
            for k, v in profiling.summary().items()}
    assert summ == {'solve': (1, 90, 30), 'load_step': (2, 60, 30),
                    'cg': (1, 30, 20), 'host_read': (1, 10, 10),
                    'return_map': (1, 30, 20), 'newton': (1, 10, 10)}


def _never(*args, **kwargs):
    raise AssertionError('called while the recorder is off')


def _reads_through_host_read(monkeypatch):
    """Count each tensor-to-host read by whether ``host_read`` made it."""
    calls = Counter()
    code = profiling.host_read.__code__
    for name in READS:
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *args, _orig=orig, _name=name):
            calls[_name, sys._getframe(1).f_code is code] += 1
            return _orig(self, *args)
        monkeypatch.setattr(torch.Tensor, name, wrapper)
    return calls


@pytest.mark.parametrize('dim', [2, 3])
def test_solves_bit_for_bit_with_the_recorder_on_and_off(monkeypatch, dim):
    solve = _solve2 if dim == 2 else _solve3
    with monkeypatch.context() as m:
        m.setattr(profiling, '_now', _never)
        m.setattr(torch.profiler, 'record_function', _never)
        m.setattr(torch.cuda, 'synchronize', _never)
        off = solve()
    with monkeypatch.context() as m:
        calls = _reads_through_host_read(m)
        profiling.start()
        on = solve()
        profiling.stop()
    for a, b in zip(off, on):
        if isinstance(a, list):
            assert all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                       for x, y in zip(a, b))
        else:
            for f in ('u', 'sig', 'epl', 'eps', 'elstiff'):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
    c = profiling.counters()
    assert not [k for k in calls if not k[1]], calls
    assert sum(calls.values()) == c['host_reads']
    assert c['host_reads.cg'] == 2 * c['cg_solves'] + c['cg_iters']
    assert c['host_reads'] == c['host_reads.cg'] + c['host_reads.newton'] \
        + c.get('host_reads.dst', 0)
    steps = 2 if dim == 2 else 1
    assert c['load_steps'] == steps and c['rounds'] == 3 * steps
    assert c['cg_solves'] == c['return_map_calls'] == 3 * steps
    assert c['host_reads.newton'] >= c['newton_trips'] > 0
    assert c['mesh_chain_builds'] == 1
    s = profiling.summary()
    assert s['solve']['count'] == 1 and s['load_step']['count'] == steps
    assert s['newton']['count'] == 3 * steps * 4    # nsub 4 a call
    assert s['hierarchy']['count'] == c['hierarchy_builds']
    assert s['coarse_inverse']['count'] >= 1
    assert s['host_read']['count'] == c['host_reads']
    assert s['cg']['total_s'] <= s['load_step']['total_s'] \
        <= s['solve']['total_s']
    if dim == 2:
        assert c['host_reads.dst'] == c['rounds']
    else:
        assert c['hierarchy_builds'] == 2       # entering + mid-step
    assert {sp.request for sp in profiling.spans()} == {1}


def test_cg_iters_are_the_steps_histories():
    """The counter against ``diag['cg_iters_hist']`` of each step."""
    mat, CV, eps = convert.material_from_npz(workloads.NPZ, device='cpu')
    md = fek.rect_mesh(16, 16, eps_tot=eps, device='cpu')
    st = fek.init_state(md, CV)
    profiling.start()
    _, d1 = fek.load_step_split(md, st, mat, CV, 0.5, n_inner=2)
    profiling.stop()
    assert profiling.counters()['cg_iters'] == sum(d1['cg_iters_hist'])
    md3 = fe3d.box_mesh(4, 4, 4, uniax='z', eps_tot=0.002, device='cpu')
    CV3 = convert.elastic_cv(200.e3, 0.3)
    mat3 = convert.material_from_params(
        dict(hill=[1.] * 6, sy=150., khard=500., drucker=0.), is_svc=False,
        device='cpu')
    profiling.start()
    _, d3 = fe3d.load_step3(md3, fe3d.init_state3(md3, CV3), mat3, CV3, 0.5)
    profiling.stop()
    assert profiling.counters()['cg_iters'] == sum(d3['cg_iters_hist'])


def test_a_profiler_trace_holds_the_program_s_ranges(tmp_path):
    mat, CV, eps = convert.material_from_npz(workloads.NPZ, device='cpu')
    md = fek.rect_mesh(8, 8, eps_tot=eps, device='cpu')
    with profiling.trace(str(tmp_path), device='cpu'):
        fek.solve_uniaxial(md, mat, CV, nsteps=1, n_inner=1)
    assert not profiling.enabled()
    names = {e.get('name') for e in json.loads(
        (tmp_path / 'trace.json').read_text())['traceEvents']}
    for part in ('solve', 'load_step', 'hierarchy', 'cg', 'return_map',
                 'newton', 'host_read'):
        assert f'plfea.{part}' in names, part
    # made under the profiler: kept apart from the window's records
    assert profiling.spans() == [] and profiling.counters() == {}
    assert profiling.counters(profiled=True)['load_steps'] == 1
    assert profiling.summary(profiled=True)['load_step']['count'] == 1


def test_another_profiler_gets_no_ranges():
    """Outside ``trace`` the spans open no range: a range's device-side
    twin would read as device work in another reader's trace."""
    profiling.start()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span('cg'):
            torch.ones(4) + 1
            profiling.count('cg_iters')
    assert not [e for e in prof.events() if e.name.startswith('plfea.')]
    assert [s.name for s in profiling.spans(profiled=True)] == ['cg']
    assert profiling.counters(profiled=True) == {'cg_iters': 1}
