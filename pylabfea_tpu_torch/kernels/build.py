"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and are compiled with ``nvcc`` into
one shared library, loaded with ``ctypes`` (pointers and the CUDA stream
pass as ``c_void_p``; every entry point returns ``cudaGetLastError()``
after its launch).  The build runs at first use and is keyed on a hash of
the sources and flags, so a fresh checkout builds once and later processes
reuse the library from ``pylabfea_tpu_torch/build/`` (listed in
``.gitignore``).  Nothing here runs at import.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / 'build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    'pylabfea_svc_fgrad_f32': (_P, _P, _P, _L, _I, _I, ctypes.c_float,
                               ctypes.c_float, _P, _P, _I, _P),
    'pylabfea_svc_fgrad_f64': (_P, _P, _P, _L, _I, _I, ctypes.c_double,
                               ctypes.c_double, _P, _P, _I, _P),
    'pylabfea_kapply2d_f32': (_P, _P, _P, _P, _P, _I, _I, _P),
    'pylabfea_kapply2d_f64': (_P, _P, _P, _P, _P, _I, _I, _P),
}


@dataclass
class Built:
    """The loaded kernel library and how it was obtained."""
    lib: ctypes.CDLL
    path: Path
    seconds: float      # wall time of the nvcc build (0 when reused)
    log: str            # nvcc output (ptxas register/shared-memory report)


def _nvcc():
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cand = Path(home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on '
                           'PATH): the CUDA kernels cannot be built')
    return found


def _sources():
    srcs = sorted(CSRC_DIR.glob('*.cu'))
    if not srcs:
        raise RuntimeError(f'no CUDA sources under {CSRC_DIR}')
    return srcs


def _key(srcs):
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def load() -> Built:
    """Build (if needed) and load the kernel library; cached per process."""
    srcs = _sources()
    so = BUILD_DIR / f'libpylabfea_kernels_{_key(srcs)}.so'
    seconds, log = 0., ''
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, srcs)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f'nvcc failed ({res.returncode}):\n{log}')
        os.replace(tmp, so)     # atomic: concurrent builders race safely
    lib = ctypes.CDLL(str(so))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return Built(lib=lib, path=so, seconds=seconds, log=log)


def check(err: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with cudaError_t '
                           f'{err}')
