"""Readings that set a cell's limits: the judge's numbers of the program
over many seeds in one process, or of the control (the reference a
precision below the configuration's, in the program's place).

    python3 portbench/study.py --workload <cell> --seeds 1 2 3 ...
        --requests <n> [--control | --fault <name>] [--out <file.jsonl>]

Each seed serves ``n`` requests of the cell's traffic at the cell's own
sizes (a return-map cell judges all ``n`` calls) and prints one JSON line
of the numbers of each request.  ``--fault linear_solve_skipped`` (any
``fault_<name>`` of ``tests/test_portbench_harness.py``) plants that
fault in the program first.  The benchmark's runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--requests', type=int, default=1)
    p.add_argument('--control', action='store_true')
    p.add_argument('--fault')
    p.add_argument('--out')
    args = p.parse_args(argv)
    if args.fault:
        import pytest
        sys.path.insert(0, str(BENCH / 'tests'))
        import test_portbench_harness as faults
        getattr(faults, f'fault_{args.fault}')(pytest.MonkeyPatch(),
                                               args.workload)

    import torch
    from harness import cells
    from harness.manifest import Manifest
    torch.set_num_threads(1)
    man = Manifest(ROOT)
    wl = man.workload(args.workload)
    mix = man.traffic(wl['traffic'])
    cfg = man.config(wl['config'])
    if mix['kind'] == 'return_map':
        mix['sample'] = args.requests
    cell = cells.make(cfg, mix, ROOT, 'cuda')
    out = open(args.out, 'a') if args.out else None
    if not args.control:
        cell.setup(args.seeds[0])
        cell.request()
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.control:
            records = cell.control(seed, args.requests)
        else:
            cell.reseed(seed)
            cell.start_window()
            records = [cell.request() for _ in range(args.requests)]
        numbers = cell.judge(records)
        line = json.dumps({'workload': args.workload, 'seed': seed,
                           'control': args.control, 'fault': args.fault,
                           'numbers': numbers,
                           'seconds': time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + '\n')
            out.flush()
        if args.control:
            del records
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
