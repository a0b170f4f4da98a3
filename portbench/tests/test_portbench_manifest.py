"""The manifest keeps to the benchmark's contract, and every name in it
resolves to its file.

    python -m pytest portbench/tests -q
"""
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness.manifest import Manifest, load_reader  # noqa: E402

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
WIDTH = re.compile(r'(_dim|_rank)$|hidden|intermediate|latent|state|'
                   r'projection|head|expansion|per_tok')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


@pytest.fixture(scope='module')
def man():
    return Manifest(ROOT)


def line_ok(s):
    return 1 <= len(s) <= 200 and '\n' not in s and '\t' not in s


def test_top_level_keys_and_size(man):
    assert set(man.data) == {'command', 'paths', 'run_seconds', 'configs',
                             'workloads', 'end_to_end', 'per_layer'}
    assert (ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024


def test_command_and_paths(man):
    d = man.data
    assert 1 <= len(d['paths']) <= 16
    for p in d['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(d['command']) <= 32
    for w in d['command']:
        assert line_ok(w) and not w.startswith('/') and '..' not in w
        if '/' in w:
            assert any(w.startswith(p + '/') for p in d['paths'])


def test_run_seconds_fits_the_check_of_24_cells(man):
    rs = man.data['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(man):
    d = man.data
    names = [c['name'] for c in d['configs']]
    names += [w['name'] for w in d['workloads']]
    metrics = d['end_to_end'] + d['per_layer']
    names += [m['name'] for m in metrics]
    for n in names:
        assert NAME.match(n), n
    for group in (d['configs'], d['workloads'], metrics):
        assert len({x['name'] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
    for w in d['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert line_ok(w['why']) and w['chips'] in (1, 4)
    for c in d['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert line_ok(c['source']) and line_ok(c['why'])
        assert len(c['reduced']) <= 16
        for k in c['reduced']:
            assert NAME.match(k) and not WIDTH.search(k)
    for m in d['per_layer']:
        assert line_ok(m['layer'])


def test_end_to_end_metrics(man):
    d = man.data
    e2e = {m['name']: m for m in d['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in d['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for w in d['workloads']:
        names = [m['name'] for m in man.end_to_end(w['name'])]
        assert 'setup_s' in names and len(names) >= 2
        assert man.per_layer(w['name'])


def test_per_layer_metrics(man):
    d = man.data
    e2e = {m['name'] for m in d['end_to_end']}
    cells = {w['name'] for w in d['workloads']}
    for m in d['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e
        for c in m['workloads']:
            assert c in cells
            assert m['moves'] in [x['name'] for x in man.end_to_end(c)]
        if 'roofline' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'


def test_every_name_resolves_to_its_file(man):
    d = man.data
    for c in d['configs']:
        path = ROOT / c['file']
        assert path.is_file() and c['file'].startswith('portbench/')
        cfg = json.loads(path.read_text())
        assert cfg['name'] == c['name'] and cfg['reduced'] == c['reduced']
    used = {w['config'] for w in d['workloads']}
    assert used == set(man.configs)
    for w in d['workloads']:
        assert (BENCH / 'traffic' / f'{w["traffic"]}.json').is_file()
        limits = man.limits(w['name'])
        assert limits and all(v >= 0 for v in limits.values())
    for m in d['per_layer']:
        assert callable(load_reader(m["name"]).read)


def test_configs_state_their_material(man):
    for name in man.configs:
        cfg = man.config(name)
        m = cfg['material']
        if m['criterion'] == 'svc':
            import numpy as np
            with np.load(ROOT / m['svc_file']) as z:
                assert z['support_vectors'].shape == (m['support_vectors'],
                                                      m['features'])
                assert float(z['gamma']) == m['gamma']
                assert float(z['sy']) == m['sy']
