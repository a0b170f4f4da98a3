"""The harness on the CPU at tiny sizes: one run of each traffic mix
through the program's plain path, the command's refusal without a card,
the reading of a trace, and ``correct`` coming out false for the control
and for each fault a cell can have, with the cells' own limits.  The
last test runs a cell on the card and skips without one."""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import cells, runner, trace  # noqa: E402
from harness.manifest import Manifest  # noqa: E402

SEED = 2 ** 31 + 4242
TINY = {'hill_ml_2d.solve_2048': {'mesh': [16, 16]},
        'j2_hex8_3d.solve_128': {'mesh': [8, 8, 8]},
        'hill_ml_2d.return_map_1m': {'states': 4096, 'pool': 4,
                                     'sample': 4}}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_run(cell, traced=False, seconds=0.2):
    return runner.run(cell, SEED, seconds, traced, ROOT, device='cpu',
                      mix_overrides=TINY[cell], log=lambda m: None)


@pytest.mark.parametrize('cell', sorted(TINY))
@pytest.mark.parametrize('traced', [False, True])
def test_one_tiny_run_of_each_mix_on_the_plain_path(cell, traced):
    man = Manifest(ROOT)
    r = tiny_run(cell, traced)
    assert r['correct'] and r['attempted'] >= 1 and r['failed'] == 0
    assert list(r)[-1] == 'checks'
    assert set(r['checks']) == set(man.limits(cell))
    names = {m['name'] for m in (man.per_layer(cell) if traced
                                 else man.end_to_end(cell))}
    assert set(r['metrics']) <= names
    if not traced:
        assert set(r['metrics']) == names
        assert all(m['value'] > 0 for m in r['metrics'].values())


def test_the_command_fails_without_a_card():
    env = {**os.environ, 'CUDA_VISIBLE_DEVICES': ''}
    p = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload',
         'hill_ml_2d.return_map_1m', '--seed', str(SEED), '--seconds', '1',
         '--trace', '0'], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ''


def test_the_command_fails_in_a_bare_checkout(tmp_path):
    import shutil
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(BENCH, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    p = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload',
         'hill_ml_2d.return_map_1m', '--seed', str(SEED), '--seconds', '1',
         '--trace', '0'], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ''


class Event:
    """A trace event with the accessors of ``_KinetoEvent``."""

    def __init__(self, name, kind, start, end, tid=1):
        self._v = (name, kind, start, end, tid)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        return 'DeviceType.CUDA' if self._v[1] in trace.DEVICE_KINDS or \
            self._v[1].startswith('gpu') else 'DeviceType.CPU'

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]


class OlderEvent(Event):
    """The same without ``activity_type`` (older releases of PyTorch)."""

    def __getattribute__(self, name):
        if name == 'activity_type':
            raise AttributeError(name)
        return super().__getattribute__(name)


@pytest.mark.parametrize('Event', [Event, OlderEvent])
def test_the_trace_reading_on_a_known_timeline(Event):
    ev = [Event(trace.WINDOW, 'user_annotation', 0, 1000),
          Event('portbench.linear_solve', 'user_annotation', 0, 600),
          Event('aten::item', 'cpu_op', 100, 300),
          Event('k1', 'kernel', 50, 100),
          Event('k1', 'kernel', 300, 400),
          Event('k2', 'kernel', 350, 500),
          Event('Memcpy DtoH', 'gpu_memcpy', 700, 710),
          Event('portbench.linear_solve', 'gpu_user_annotation', 40, 720),
          Event('k1', 'kernel', 1200, 1300)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    s = trace.summarize(prof)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(260e-9)
    assert s.n_ops == 4
    assert s.kernel('k1') == (pytest.approx(150e-9), 2)
    assert s.idle_by_host == pytest.approx({
        'linear_solve/python': 250e-9, 'linear_solve/aten::item': 200e-9,
        'none/python': 290e-9})
    b = s.breakdown()
    assert b['device_ops'][0][0] == 'k1' and len(b['idle_gaps']) == 3


@pytest.mark.parametrize('cell', sorted(TINY))
def test_the_control_is_not_correct(cell):
    """The reference in bfloat16 in the program's place, judged with the
    cell's limits."""
    man = Manifest(ROOT)
    wl = man.workload(cell)
    mix = {**man.traffic(wl['traffic']), **TINY[cell]}
    c = cells.make(man.config(wl['config']), mix, ROOT, 'cpu')
    limits = man.limits(cell)
    numbers = c.judge(c.control(SEED, 2))
    assert any(n[k] > limits[k] for n in numbers for k in limits)


def fault_state_unchanged(monkeypatch, cell):
    """The second load step, or every return map, hands back the state it
    was given."""
    from pylabfea_tpu_torch.ops import constitutive as con
    from pylabfea_tpu_torch.ops import fe3d
    from pylabfea_tpu_torch.ops import fe_kernels as fek
    if cell.endswith('return_map_1m'):
        orig = con.response_fast

        def broken(m, state, deps, CV, *a, **k):
            f, sig, depl, tan = orig(m, state, deps, CV, *a, **k)
            return f, state[0], torch.zeros_like(depl), tan
        monkeypatch.setattr(con, 'response_fast', broken)
        return
    mod, name = (fe3d, 'load_step3') if 'hex8' in cell else (
        fek, 'load_step_split')
    orig = getattr(mod, name)
    calls = []

    def broken(md, state, *a, **k):
        new, diag = orig(md, state, *a, **k)
        calls.append(1)
        return (state, diag) if len(calls) % 4 == 2 else (new, diag)
    monkeypatch.setattr(mod, name, broken)


def fault_half_batch(monkeypatch, cell):
    """The return map serves the first half of its rows; the rest keep
    their entering stress and book no plastic strain."""
    from pylabfea_tpu_torch.ops import constitutive as con
    orig = con.response_fast

    def broken(m, state, deps, CV, *a, **k):
        f, sig, depl, tan = orig(m, state, deps, CV, *a, **k)
        h = sig.shape[0] // 2
        sig = torch.cat([sig[:h], state[0][h:]])
        depl = torch.cat([depl[:h], torch.zeros_like(depl[h:])])
        return f, sig, depl, tan
    monkeypatch.setattr(con, 'response_fast', broken)


def fault_altered(monkeypatch, cell):
    """One stress of every return map is off by 1 MPa where it is made."""
    from pylabfea_tpu_torch.ops import constitutive as con
    orig = con.response_fast

    def broken(m, state, deps, CV, *a, **k):
        f, sig, depl, tan = orig(m, state, deps, CV, *a, **k)
        sig = sig.clone()
        sig[0, 1] += 1.
        return f, sig, depl, tan
    monkeypatch.setattr(con, 'response_fast', broken)


def fault_linear_solve_skipped(monkeypatch, cell):
    """Every MG-CG solve hands back its start (zero iterations)."""
    from pylabfea_tpu_torch.ops import fe3d
    from pylabfea_tpu_torch.ops import multigrid as mg
    mod, name = (fe3d, 'mg_cg_solve3') if 'hex8' in cell else (
        mg, 'mg_cg_solve')
    monkeypatch.setattr(mod, name, lambda levels, b, x0, *a, **k: (
        x0, 1., 0))


def fault_gradient_term_dropped(monkeypatch, cell):
    """Kernel A's gradient loses its shear terms: the return map flows
    in the wrong direction."""
    import functools
    from pylabfea_tpu_torch.ops import svc_kernels as sk
    orig = sk.svc_f_grad

    @functools.wraps(orig)
    def broken(*a, **k):
        f, g = orig(*a, **k)
        if g is not None:
            g = g.clone()
            g[:, 3:] = 0.
        return f, g
    monkeypatch.setattr(sk, 'svc_f_grad', broken)


SOLVES = ('hill_ml_2d.solve_2048', 'j2_hex8_3d.solve_128')
FAULTS = [(c, f) for c in sorted(TINY) for f in (
    fault_state_unchanged, fault_half_batch, fault_altered)] + [
    (c, fault_linear_solve_skipped) for c in SOLVES] + [
    ('hill_ml_2d.return_map_1m', fault_gradient_term_dropped)]


@pytest.mark.parametrize('cell,fault', FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, cell, fault):
    """The cells run on one card and exchange nothing between cards, so
    the fault of a left-out exchange does not apply."""
    fault(monkeypatch, cell)
    r = tiny_run(cell)
    assert not r['correct'] and r['failed'] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize('cell', sorted(TINY))
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    p = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', cell, '--seed',
         str(SEED), '--seconds', '2', '--trace', '0'], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    import json
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r['correct'] and r['device']['platform'] == 'gpu'
