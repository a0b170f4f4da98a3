"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-window, the judge and the result line."""
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from harness import cells, instrument, trace
from harness.manifest import Manifest, load_reader

#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pylabfea_tpu')


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def card_info():
    """(name, power limit) of card 0 from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


class Context:
    """What the per-layer readers read."""

    def __init__(self, cell, probe, window_s, summary):
        self.cell = cell
        self.spans = probe.spans
        self.window_s = window_s
        self.counters = dict(probe.counters)
        self.counters.update(cell.counters)
        self.work = probe.work
        self.trace = summary
        self.notes = []

    def span_share(self, layer):
        """Percent of the window spent in the outermost calls of
        ``layer``, or None without such a span."""
        if not any(s[0] == layer for s in self.spans) or self.window_s <= 0:
            return None
        return 100. * sum(t1 - t0 for name, t0, t1 in self.spans
                          if name == layer) / self.window_s


def window(cell, seconds, probe=None):
    """Requests back to back until ``seconds`` have passed; the request
    running then finishes and counts.  Returns (records, latencies,
    window seconds)."""
    records, lat = [], []
    t0 = time.perf_counter()
    while True:
        start = time.perf_counter()
        if start - t0 >= seconds and records:
            break
        if probe is not None:
            cell.sync()
        rec = cell.request()
        end = time.perf_counter()
        if probe is not None:
            probe.spans.append(('request', start, end))
        records.append(rec)
        lat.append(end - start)
    return records, lat, end - t0


def profiled(cell, probe, count):
    """``count`` requests under ``torch.profiler``; the TraceSummary."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cell.device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    probe.mode = 'profile'
    cell.sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for _ in range(count):
                with torch.profiler.record_function('portbench.request'):
                    cell.request()
            cell.sync()
    probe.mode = None
    return trace.summarize(prof)


def end_to_end(mix, records, lat, window_s, setup_s, cell):
    """The end-to-end metrics of a window."""
    out = {'setup_s': setup_s}
    if mix['kind'] == 'fe_solve':
        out['elem_updates_per_s'] = cell.work * len(records) / window_s
    else:
        out['return_maps_per_s'] = cell.work * len(records) / window_s
        out['return_map_p95_ms'] = 1e3 * statistics.quantiles(
            lat, n=20, method='inclusive')[-1] if len(lat) > 1 \
            else 1e3 * lat[0]
    return out


def run(name, seed, seconds, traced, root, device='cuda', t_start=None,
        mix_overrides=None, limits=None, log=print):
    """Run cell ``name`` once.  Returns the result line's dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = Manifest(root)
    wl = man.workload(name)
    cfg = man.config(wl['config'])
    mix = {**man.traffic(wl['traffic']), **(mix_overrides or {})}
    limits = man.limits(name) if limits is None else limits
    cell = cells.make(cfg, mix, root, device)
    cuda = cell.device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    cell.setup(seed)
    t_warm = time.perf_counter()
    for _ in range(int(mix.get('warmup_requests', 1))):
        cell.request()
    log(f'[portbench] set-up: start to the cell {t_setup - t_start:.3f} s, '
        f'the cell {t_warm - t_setup:.3f} s, warm-up '
        f'{time.perf_counter() - t_warm:.3f} s')
    readers, probe = {}, None
    if traced:
        probe = instrument.Probe(cell.sync)
        for layer, targets in cfg.get('spans', {}).items():
            for target in targets:
                probe.span(layer, target)
        specs = {}
        for m in man.per_layer(name):
            readers[m['name']] = load_reader(m['name'])
            for spec in getattr(readers[m['name']], 'KERNELS', ()):
                specs.setdefault(spec.target, spec)
        for spec in specs.values():
            probe.kernel(spec)
        probe.mode = 'spans'
    cell.start_window()
    setup_s = time.perf_counter() - t_start
    log(f'[portbench] set-up {setup_s:.3f} s')
    records, lat, window_s = window(cell, seconds, probe)
    cell.sampling = False
    log(f'[portbench] window {window_s:.3f} s, {len(records)} requests')
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': torch.cuda.get_device_name() if cuda else 'cpu',
                   'count': 1, 'memory_peak_bytes': memory_peak,
                   'power': card_info() if cuda else None}
    result = {}
    if traced:
        probe.mode = None
        t0 = time.perf_counter()
        summary = profiled(cell, probe, int(mix.get('profile_requests', 1)))
        probe.restore()
        log(f'[portbench] profiled sub-window and its trace '
            f'{time.perf_counter() - t0:.3f} s')
        ctx = Context(cell, probe, window_s, summary)
        metrics = {}
        for m in man.per_layer(name):
            v = readers[m['name']].read(ctx)
            if v is not None and math.isfinite(v):
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        for note in ctx.notes:
            log(f'[trace] {note}')
        if summary is not None:
            device_info['busy_s'] = summary.busy_s
            device_info['window_s'] = summary.window_s
            result['breakdown'] = summary.breakdown()
    else:
        metrics = {k: {'value': v, 'unit': u} for k, v, u in (
            (m['name'], end_to_end(mix, records, lat, window_s, setup_s,
                                   cell).get(m['name']), m['unit'])
            for m in man.end_to_end(name)) if v is not None}
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = cell.judge(records)
    log(f'[portbench] judge {time.perf_counter() - t0:.3f} s')
    worst = {k: max(n[k] for n in numbers) for k in limits}
    failed = sum(any(not n[k] <= limits[k] for k in limits)
                 for n in numbers)
    correct = bool(numbers) and failed == 0
    checks = {k: {'value': worst[k] if math.isfinite(worst[k]) else None,
                  'limit': limits[k]} for k in limits}
    result = {'correct': correct, 'attempted': len(records),
              'failed': failed,
              'metrics': metrics, 'device': device_info, **result,
              'checks': checks}
    return result


def emit(result):
    """The last lines: each number compared beside its limit on standard
    error, then the result line on standard output."""
    for k, c in result['checks'].items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
