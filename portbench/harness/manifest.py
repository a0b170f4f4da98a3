"""``BENCHMARK.json`` and the files it names: each configuration in
``configs/<name>.json``, each traffic mix in ``traffic/<name>.json``, each
per-layer metric's reader in ``metrics/<name>.py`` (or, for a metric
``<base>.<part>`` with no file of its own, the reader ``metrics/<base>.py``
that its kind shares) and each cell's limits in ``limits/<cell>.json``,
all under the benchmark's folder."""
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


class Manifest:
    """The parsed manifest and the lookups of one cell's files."""

    def __init__(self, root):
        self.root = Path(root)
        self.data = json.loads((self.root / 'BENCHMARK.json').read_text())
        self.configs = {c['name']: c for c in self.data['configs']}
        self.workloads = {w['name']: w for w in self.data['workloads']}

    def workload(self, name):
        if name not in self.workloads:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json '
                           f'(has {sorted(self.workloads)})')
        return self.workloads[name]

    def config(self, name):
        return json.loads((self.root / self.configs[name]['file'])
                          .read_text())

    def traffic(self, name):
        return json.loads((BENCH_DIR / 'traffic' / f'{name}.json')
                          .read_text())

    def limits(self, cell):
        return json.loads((BENCH_DIR / 'limits' / f'{cell}.json')
                          .read_text())

    def _applies(self, metric, cell):
        return cell in metric.get('workloads', [cell])

    def end_to_end(self, cell):
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data['end_to_end'] if self._applies(m, cell)]

    def per_layer(self, cell):
        """The per-layer metrics this cell reports."""
        return [m for m in self.data['per_layer'] if self._applies(m, cell)]


def reader_path(name):
    """The reader file of the per-layer metric ``name``."""
    path = BENCH_DIR / 'metrics' / f'{name}.py'
    if not path.exists() and '.' in name:
        path = BENCH_DIR / 'metrics' / f'{name.rsplit(".", 1)[0]}.py'
    return path


def load_reader(name):
    """The reader module of the per-layer metric ``name``."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
