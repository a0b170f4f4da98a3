"""Device, dtype and precision policy of the PyTorch/CUDA port.

The port runs in two profiles that share one code base, as the JAX package
does:

* **parity** (CPU, float64): the plain PyTorch versions of every kernel,
  held against the JAX reference package by the CPU test suite.
* **performance** (CUDA, float32, ``DTYPE_DEVICE``): the hand-written CUDA
  kernels under ``csrc/`` on an NVIDIA Hopper card.

Every constructor takes a ``device`` and a ``dtype`` (default
``DTYPE_DEVICE``, as the JAX package's solver defaults to float32); every
later tensor follows the device and dtype of its inputs.  ``device=None``
means the card (``default_device``), and raises where no card is visible:
the CPU runs only when the caller asks for it with ``device='cpu'``, as the
parity tests do.

TF32 is switched off at import.  A float32 product in TF32 keeps about three
decimal digits; the JAX reference measured that reduced-precision SVC
distance terms move yield-onset stresses by percent
(``pylabfea_tpu/ops/constitutive.py`` ``_rbf_d2``), and TF32 is the same
hazard for every matmul of the port.
"""
import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')

#: Default dtype of the solver's constructors (the performance profile).
DTYPE_DEVICE = torch.float32

#: Plastic yielding is assumed when the yield function exceeds this
#: tolerance (the JAX package's ``core/tensors.py`` value and variable).
yf_tolerance = float(os.environ.get('PYLABFEA_YF_TOL', 5.e-3))


def default_device() -> torch.device:
    """The device of a constructor called without one: the CUDA card.
    Raises where no card is visible; it never returns the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError('pylabfea_tpu_torch: no CUDA device is visible; '
                           "pass device='cpu' to run on the CPU")
    return torch.device('cuda')


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``default_device()``."""
    return default_device() if device is None else torch.device(device)


def tf32_off() -> bool:
    """True when no float32 matmul or convolution may run in TF32."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == 'highest')
