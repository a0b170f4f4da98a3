"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics with the device's busy time.
The run needs a CUDA card and exits non-zero without one; it never falls
back to the CPU.  Build and kernel caches stay inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / '.portbench_cache'
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton'), ('CUDA_CACHE_PATH', 'nv')):
    os.environ[var] = str(CACHE / sub)
for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ.setdefault(var, '1')
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from harness.manifest import Manifest
    from harness import runner

    chips = Manifest(ROOT).workload(args.workload)['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: {args.workload} needs {chips} CUDA card(s), '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ' visible', file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = runner.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), ROOT, device='cuda',
                        t_start=T_START,
                        log=lambda m: print(m, file=sys.stderr, flush=True))
    bad = runner.forbidden_modules()
    if bad:
        print(f'portbench: the run loaded {", ".join(bad)}', file=sys.stderr)
        return 3
    runner.emit(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
