"""ctypes binding to the native (C++) SVC constitutive kernel.

The shared library ``libmlumat.so`` implements the ML-flow-rule material
update with the UMAT parameter contract (same ``props`` layout that
``Material.export_MLparam`` writes and that Abaqus consumes); see
``native/ml_umat.cpp`` at the repository root.  Built on demand with g++
into the package's ignored ``build/`` directory (the port's copy of
``pylabfea_tpu.utils.native``, which builds into ``native/``).
"""
import ctypes
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), 'native', 'ml_umat.cpp')
_LIB = os.path.join(_PKG, 'build', 'libmlumat.so')

_lib = None


def build(force=False):
    """Compile the native library if needed; returns the library path."""
    if force or (not os.path.exists(_LIB)) or \
            os.path.getmtime(_SRC) > os.path.getmtime(_LIB):
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        tmp = f'{_LIB}.{os.getpid()}'
        subprocess.check_call(['g++', '-O3', '-shared', '-fPIC', '-std=c++17',
                               _SRC, '-o', tmp])
        os.replace(tmp, _LIB)   # atomic: concurrent builders never see half
    return _LIB


def load():
    """Load (building if necessary) and configure the library."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(_LIB)
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.mlumat_fsvc.restype = ctypes.c_double
    lib.mlumat_fsvc.argtypes = [dptr, dptr]
    lib.mlumat_grad_fsvc.restype = None
    lib.mlumat_grad_fsvc.argtypes = [dptr, dptr, dptr]
    lib.mlumat_fsvc_wh.restype = ctypes.c_double
    lib.mlumat_fsvc_wh.argtypes = [dptr, dptr, dptr]
    lib.mlumat_grad_fsvc_wh.restype = ctypes.c_double
    lib.mlumat_grad_fsvc_wh.argtypes = [dptr, dptr, dptr, dptr]
    lib.mlumat_step.restype = ctypes.c_double
    lib.mlumat_step.argtypes = [dptr, dptr, dptr, dptr, dptr, ctypes.c_int]
    lib.mlumat_step_abaqus.restype = ctypes.c_double
    lib.mlumat_step_abaqus.argtypes = [dptr, dptr, dptr, dptr, dptr,
                                       ctypes.c_int]
    lib.umat_.restype = None  # Fortran-ABI Abaqus entry point
    _lib = lib
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeMLMaterial:
    """Native constitutive kernel driven by an exported parameter file
    (``<name>-svm.csv`` as written by ``Material.export_MLparam``) or a raw
    props array."""

    def __init__(self, props):
        if isinstance(props, str):
            props = np.loadtxt(props, delimiter=',').ravel()
        self.props = np.ascontiguousarray(props, dtype=np.float64)
        self.lib = load()

    def fsvc(self, sig):
        sig = np.ascontiguousarray(sig, dtype=np.float64)
        return self.lib.mlumat_fsvc(_dp(self.props), _dp(sig))

    def grad_fsvc(self, sig):
        sig = np.ascontiguousarray(sig, dtype=np.float64)
        out = np.zeros(6)
        self.lib.mlumat_grad_fsvc(_dp(self.props), _dp(sig), _dp(out))
        return out

    def fsvc_wh(self, sig, epl):
        """Decision function with plastic-strain (work-hardening) features
        (reference UMAT calcFSVC with nsd > 6)."""
        sig = np.ascontiguousarray(sig, dtype=np.float64)
        epl = np.ascontiguousarray(epl, dtype=np.float64)
        return self.lib.mlumat_fsvc_wh(_dp(self.props), _dp(sig), _dp(epl))

    def grad_fsvc_wh(self, sig, epl):
        """Stress gradient + extracted hardening modulus for
        work-hardening parameter sets; returns (grad (6,), khard)."""
        sig = np.ascontiguousarray(sig, dtype=np.float64)
        epl = np.ascontiguousarray(epl, dtype=np.float64)
        out = np.zeros(6)
        kh = self.lib.mlumat_grad_fsvc_wh(_dp(self.props), _dp(sig),
                                          _dp(epl), _dp(out))
        return out, kh

    def umat(self, stress, statev, dstran, sse=0., spd=0., nstatv=14):
        """One increment through the Fortran-ABI ``umat_`` symbol — the
        exact entry point an Abaqus build links (full Abaqus argument list,
        CHARACTER*80 hidden length included).  Abaqus component convention.
        Returns (stress, statev, ddsdde (6, 6), sse, spd)."""
        c = ctypes
        stress = np.ascontiguousarray(stress, dtype=np.float64).copy()
        statev = np.ascontiguousarray(statev, dtype=np.float64).copy()
        dstran = np.ascontiguousarray(dstran, dtype=np.float64)
        dd = np.zeros(36)
        z6 = np.zeros(6)
        z9 = np.zeros(9)
        d = c.c_double
        i = c.c_int
        sse_ = d(sse)
        spd_ = d(spd)
        scd_ = d(0.)
        rpl = d(0.)
        drpldt = d(0.)
        dtime = d(1.)
        temp = d(0.)
        dtemp = d(0.)
        pnewdt = d(1.)
        celent = d(1.)
        time = np.zeros(2)
        cmname = c.create_string_buffer(b'MLUMAT'.ljust(80), 80)
        self.lib.umat_(
            _dp(stress), _dp(statev), _dp(dd), c.byref(sse_), c.byref(spd_),
            c.byref(scd_), c.byref(rpl), _dp(z6), _dp(z6), c.byref(drpldt),
            _dp(z6), _dp(dstran), _dp(time), c.byref(dtime), c.byref(temp),
            c.byref(dtemp), _dp(z6), _dp(z6), cmname, c.byref(i(3)),
            c.byref(i(3)), c.byref(i(6)), c.byref(i(nstatv)),
            _dp(self.props), c.byref(i(len(self.props))), _dp(z6), _dp(z9),
            c.byref(pnewdt), c.byref(celent), _dp(z9), _dp(z9),
            c.byref(i(1)), c.byref(i(1)), c.byref(i(1)), c.byref(i(1)),
            c.byref(i(1)), c.byref(i(1)), c.c_size_t(80))
        return stress, statev, dd.reshape(6, 6).T, sse_.value, spd_.value

    def step(self, stress, statev, dstran, max_substeps=20, abaqus=False):
        """One constitutive update.  Returns (fy, stress, statev, ddsdde)."""
        stress = np.ascontiguousarray(stress, dtype=np.float64).copy()
        statev = np.ascontiguousarray(statev, dtype=np.float64).copy()
        dstran = np.ascontiguousarray(dstran, dtype=np.float64)
        dd = np.zeros(36)
        fn = self.lib.mlumat_step_abaqus if abaqus else self.lib.mlumat_step
        fy = fn(_dp(self.props), _dp(stress), _dp(statev), _dp(dstran),
                _dp(dd), max_substeps)
        return fy, stress, statev, dd.reshape(6, 6)
