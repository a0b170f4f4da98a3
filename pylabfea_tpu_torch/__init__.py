"""PyTorch/CUDA port of pylabfea_tpu.

A second package beside the JAX reference ``pylabfea_tpu``: the same
structured-grid 2-D elastoplastic load step with a trained SVC yield
function, written in PyTorch, with the hot kernels hand-written in CUDA C++
for Hopper (``csrc/``), and the reference's host API (``Material``,
``Model``, ``Data``, the tensor functions: the host profile, numpy/scipy as
in the JAX package), so ``import pylabfea_tpu_torch as FE`` runs the
reference's scripts on a machine with neither JAX nor scikit-learn.  It
imports ``torch`` and never ``jax``.

Module names mirror the JAX package (``ops/jtensors``, ``ops/constitutive``,
``ops/fe_kernels``, ``ops/multigrid``, ``materials``, ``femodel``) so each
function's reference is easy to find.
"""
from pylabfea_tpu_torch import config  # noqa: F401  (sets the TF32 policy)

from pylabfea_tpu_torch.core.tensors import (  # noqa: F401
    Strain, Stress, a_vec, b_vec, yf_tolerance,
    eps_eq, sig_polar_ang, sig_princ2cyl,
    sig_eq_j2, sig_cyl2princ, sig_cyl2voigt, sig_princ,
    pickle2mat, sig_dev, sig_spherical_to_cartesian,
    seq_J2, sprinc, sp_cart, svoigt, s_cyl, sdev, polar_ang,
)

__version__ = "0.1.0"
#: reference-compatible alias (pylabfea exposes ``version``)
version = __version__
__all__ = [
    "config",
    "Strain", "Stress", "a_vec", "b_vec", "yf_tolerance",
    "eps_eq", "sig_polar_ang", "sig_princ2cyl",
    "sig_eq_j2", "sig_cyl2princ", "sig_cyl2voigt", "sig_princ",
    "pickle2mat", "sig_dev", "sig_spherical_to_cartesian",
    "Model", "Material", "Data",
    "find_transition_index", "get_elastic_coefficients",
    "load_cases", "training_score", "create_test_sig",
]

_DATAIO = ("Data", "find_transition_index", "get_elastic_coefficients",
           "ln_strain", "eng_strain", "interpolate_stress")
_TRAINING = ("load_cases", "training_score", "create_test_sig",
             "uniform_hypersphere", "int_sin_m", "primes")


def __getattr__(name):
    # lazy imports keep ``import pylabfea_tpu_torch`` light
    if name == "Model":
        from pylabfea_tpu_torch.femodel import Model
        return Model
    if name == "Material":
        from pylabfea_tpu_torch.materials import Material
        return Material
    if name in _DATAIO:
        from pylabfea_tpu_torch import dataio
        return getattr(dataio, name)
    if name in _TRAINING:
        from pylabfea_tpu_torch import training
        return getattr(training, name)
    if name in ("bridge", "dataio", "training"):
        import importlib
        return importlib.import_module(f"pylabfea_tpu_torch.{name}")
    if name in ("fit_svc_jax", "train_svc_jax"):
        # the card's trainer under the names of the JAX API
        from pylabfea_tpu_torch import ml_train
        return getattr(ml_train, name)
    raise AttributeError(
        f"module 'pylabfea_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_DATAIO) | set(_TRAINING) | {
        "Model", "Material", "bridge", "dataio", "training", "fit_svc_jax",
        "train_svc_jax"})
