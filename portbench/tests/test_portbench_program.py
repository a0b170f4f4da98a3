"""The readers of the program's recorder on fabricated records: each
ratio from the window's spans and counters alone, nothing from a program
without the recorder, and the five metrics of a tiny traced run of each
cell on the CPU."""
import math
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import program, runner  # noqa: E402
from harness.manifest import Manifest, load_reader  # noqa: E402
from pylabfea_tpu_torch.utils import profiling  # noqa: E402

SEED = 2 ** 31 + 77
NEW = {'hill_ml_2d.solve_2048': ('host_reads_per_step.fe',
                                 'cg_ms_per_iter.fe', 'hierarchy_share.fe'),
       'j2_hex8_3d.solve_128': ('host_reads_per_step.fe',
                                'cg_ms_per_iter.fe', 'hierarchy_share.fe'),
       'hill_ml_2d.return_map_1m': ('host_reads_per_call.rmap',
                                    'newton_ms_per_trip.rmap')}
TINY = {'hill_ml_2d.solve_2048': {'mesh': [16, 16]},
        'j2_hex8_3d.solve_128': {'mesh': [8, 8, 8]},
        'hill_ml_2d.return_map_1m': {'states': 4096, 'pool': 4,
                                     'sample': 4}}


def _span(name, ms):
    """A closed span of ``ms`` milliseconds on the fabricated clock."""
    with profiling.span(name):
        profiling._now.t += int(ms * 1e6)


class Clock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


def _fabricate(monkeypatch, profiled):
    """One load step and one return-map call's worth of records, made
    outside (or, ``profiled``, under) a running profiler."""
    monkeypatch.setattr(profiling, '_profiling', lambda: profiled)
    for _ in range(2):
        with profiling.span('load_step'):
            profiling.count('load_steps')
            _span('hierarchy', 5)
            with profiling.span('cg'):
                profiling._now.t += int(15e6)
                for _ in range(10):
                    profiling.host_read(torch.tensor(1.), 'cg')
                profiling.count('cg_iters', 8)
            profiling._now.t += int(30e6)
    with profiling.span('return_map'):
        profiling.count('return_map_calls')
        with profiling.span('newton'):
            profiling._now.t += int(6e6)
            for _ in range(12):
                profiling.host_read(torch.tensor(True), 'newton')
            profiling.count('newton_trips', 12)


def test_the_readers_take_the_window_alone(monkeypatch):
    monkeypatch.setattr(profiling, '_now', Clock())
    readers = {n: load_reader(n) for names in NEW.values() for n in names}
    assert profiling.enabled()
    _fabricate(monkeypatch, profiled=False)
    _fabricate(monkeypatch, profiled=True)
    got = {n: r.read(None) for n, r in readers.items()}
    assert got == pytest.approx({
        'host_reads_per_step.fe': 32 / 2,       # 20 CG + 12 Newton reads
        'cg_ms_per_iter.fe': 30 / 16,
        'hierarchy_share.fe': 100. * 10 / 100,
        'host_reads_per_call.rmap': 32 / 1,
        'newton_ms_per_trip.rmap': 6 / 12})


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, 'start')
    readers = [load_reader(n) for names in NEW.values() for n in names]
    assert not profiling.enabled()
    program.start()
    assert program.window() is None
    assert all(r.read(None) is None for r in readers)


def test_nothing_recorded_reads_nothing():
    program.start()
    assert program.window() is None
    for names in NEW.values():
        for n in names:
            assert load_reader(n).read(None) is None


@pytest.mark.parametrize('cell', sorted(NEW))
def test_a_tiny_traced_run_reports_the_five(cell):
    man = Manifest(ROOT)
    assert set(NEW[cell]) <= {m['name'] for m in man.per_layer(cell)}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = runner.run(cell, SEED, 0.2, True, ROOT, device='cpu',
                       mix_overrides=TINY[cell], log=lambda m: None)
    finally:
        torch.set_num_threads(n)
    assert r['correct']
    for name in NEW[cell]:
        v = r['metrics'][name]['value']
        assert math.isfinite(v) and v > 0, (name, v)
