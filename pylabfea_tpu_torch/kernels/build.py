"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled by its own ``nvcc``
into its own shared library; the compilers run in parallel.  The libraries
are loaded with ``ctypes`` (pointers and the CUDA stream pass as
``c_void_p``; every entry point returns ``cudaGetLastError()`` after its
launch).  A build runs at first use and is keyed on a hash of its source
and the flags, so a fresh checkout builds once and later processes reuse
the libraries from ``pylabfea_tpu_torch/build/`` (listed in
``.gitignore``); the hash covers the ``csrc/*.cuh`` headers a source
includes, so a change to a shared header rebuilds every kernel that uses
it.  Nothing here runs at import.
"""
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
import types
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
_D = ctypes.c_double

#: C entry points ``pylabfea_<source stem>_<f32|f64>``: name -> argtypes
#: (every one returns a cudaError_t as int)
SIGNATURES = {
    'pylabfea_svc_fgrad_f32': (_P, _P, _P, _L, _I, _I, ctypes.c_float,
                               ctypes.c_float, _P, _P, _I, _P),
    'pylabfea_svc_fgrad_f64': (_P, _P, _P, _L, _I, _I, _D, _D, _P, _P, _I,
                               _P),
    'pylabfea_svc_decision_f32': (_P, _P, _P, _L, _I, _I, ctypes.c_float,
                                  ctypes.c_float, _P, _P),
    'pylabfea_svc_decision_f64': (_P, _P, _P, _L, _I, _I, _D, _D, _P, _P),
    'pylabfea_svc_fgrad_mm_f32': (_P, _P, _P, _L, _I, _I, ctypes.c_float,
                                  ctypes.c_float, _P, _P, _P),
    'pylabfea_svc_fgrad_mm_f64': (_P, _P, _P, _L, _I, _I, _D, _D, _P, _P,
                                  _P),
    'pylabfea_brent_step_f32': (_L, *(_P,) * 11, ctypes.c_float,
                                ctypes.c_float, _P),
    'pylabfea_brent_step_f64': (_L, *(_P,) * 11, _D, _D, _P),
    'pylabfea_yf_root_f32': (_P, _I, *(_P,) * 7, _L, _I, _I,
                             *(ctypes.c_float,) * 3, _I, _I, _I, _I,
                             ctypes.c_float, ctypes.c_float, *(_P,) * 4),
    'pylabfea_yf_root_f64': (_P, _I, *(_P,) * 7, _L, _I, _I, _D, _D, _D, _I,
                             _I, _I, _I, _D, _D, *(_P,) * 4),
    'pylabfea_kapply2d_f32': (_P, _P, _P, _P, _P, _I, _I, _P),
    'pylabfea_kapply2d_f64': (_P, _P, _P, _P, _P, _I, _I, _P),
    'pylabfea_kapply3d_f32': (*(_P,) * 7, _I, _I, _I, _D, _D, _D, _I, _P),
    'pylabfea_kapply3d_f64': (*(_P,) * 7, _I, _I, _I, _D, _D, _D, _I, _P),
}


@dataclass
class Built:
    """The loaded kernel libraries and how they were obtained."""
    lib: types.SimpleNamespace   # every entry point of SIGNATURES
    paths: list                  # one shared library per source
    seconds: float      # wall time of the parallel nvcc builds (0: reused)
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _headers(src, seen=None):
    """The ``csrc`` headers that ``src`` includes, directly or through
    another header, in the order first met."""
    seen = [] if seen is None else seen
    for name in _INCLUDE.findall(src.read_bytes()):
        hdr = src.parent / name.decode()
        if hdr.exists() and hdr not in seen:
            seen.append(hdr)
            _headers(hdr, seen)
    return seen


def _key(srcs):
    """Hash of the sources, every header they include and the flags."""
    h = hashlib.sha256()
    for s in srcs:
        for f in (s, *_headers(s)):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _library(src):
    return BUILD_DIR / f'lib{src.stem}_{_key([src])}.so'


@functools.lru_cache(maxsize=1)
def load() -> Built:
    """Build what is missing (one nvcc per source, all started together)
    and load every kernel library; cached per process."""
    srcs = _sources()
    todo = [s for s in srcs if not _library(s).exists()]
    seconds, log = 0., ''
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = []
        for s in todo:
            tmp = _library(s).with_suffix(f'.{os.getpid()}.tmp')
            jobs.append((s, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for s, tmp, proc in jobs:
            out = proc.communicate()[0]
            log += f'--- {s.name}\n{out}'
            if proc.returncode != 0:
                failed.append(f'{s.name} ({proc.returncode})')
            else:
                os.replace(tmp, _library(s))   # atomic: builders race safely
        seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f'nvcc failed for {", ".join(failed)}:\n{log}')
    libs = {s.stem: ctypes.CDLL(str(_library(s))) for s in srcs}
    fns = {}
    for name, args in SIGNATURES.items():
        fn = getattr(libs[name[len('pylabfea_'):-len('_f32')]], name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        fns[name] = fn
    return Built(lib=types.SimpleNamespace(**fns),
                 paths=[_library(s) for s in srcs], seconds=seconds, log=log)


def check(err: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with cudaError_t '
                           f'{err}')
