"""RBF-SVC decision function and gradient on tensors (the plain versions of
``pylabfea_tpu.ops.svc`` ``decision_function_jax`` /
``decision_gradient_jax``).

A trained SVC is its support vectors ``sv`` (nsv, F), dual coefficients
``dc`` (nsv,), intercept ``rho`` and kernel width ``gamma``.  The return
map's hot path goes through the fused kernel in ``svc_kernels`` instead.
"""
import torch

from pylabfea_tpu_torch.ops.svc_kernels import rbf_d2


def decision_function(sv, dc, rho, gamma, x):
    """f(x) = sum_s dc_s exp(-gamma |x - sv_s|^2) + rho for x (N, F)."""
    return torch.exp(-gamma * rbf_d2(x, sv)) @ dc + rho


def decision_gradient(sv, dc, gamma, x):
    """df/dx (N, F) with direct differences x - sv_s."""
    diff = x[:, None, :] - sv[None, :, :]
    k = torch.exp(-gamma * torch.sum(diff * diff, dim=2))
    w = dc[None, :] * k
    return -2. * gamma * torch.einsum('ns,nsd->nd', w, diff)
