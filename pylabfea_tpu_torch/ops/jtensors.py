"""Batched stress/strain helpers (subset of ``pylabfea_tpu.ops.jtensors``).

Batch-first tensors ``(N, 6)`` in Voigt order (11, 22, 33, 23, 13, 12).
The 3x3 eigensolver of the JAX module is not needed by the 6-D stress
feature path and is not ported yet.
"""
import torch


def safe_sqrt(x):
    """sqrt that is exactly 0 at x == 0 (value-identical to ``sqrt`` for
    x >= 0); the JAX twin also keeps the derivative finite there."""
    pos = x > 0.
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.)), 0.)


def seq_j2_voigt(sig):
    """J2 equivalent stress from full Voigt stresses (..., 6)."""
    d12 = sig[..., 0] - sig[..., 1]
    d23 = sig[..., 1] - sig[..., 2]
    d31 = sig[..., 2] - sig[..., 0]
    sh = sig[..., 3] ** 2 + sig[..., 4] ** 2 + sig[..., 5] ** 2
    return safe_sqrt(0.5 * (d12 ** 2 + d23 ** 2 + d31 ** 2) + 3. * sh)


def sig_dev(sig):
    """Deviatoric stress for Voigt (..., 6) or principal (..., 3) input."""
    p = torch.sum(sig[..., 0:3], dim=-1, keepdim=True) / 3.
    if sig.shape[-1] == 3:
        return sig - p
    return torch.cat([sig[..., 0:3] - p, sig[..., 3:]], dim=-1)


def eps_eq(eps):
    """Equivalent strain for Voigt (..., 6) or principal (..., 3) input."""
    if eps.shape[-1] == 6:
        return safe_sqrt(2. * (torch.sum(eps[..., 0:3] ** 2, dim=-1) +
                               0.5 * torch.sum(eps[..., 3:6] ** 2, dim=-1))
                         / 3.)
    return safe_sqrt(2. * torch.sum(eps[..., 0:3] ** 2, dim=-1) / 3.)
