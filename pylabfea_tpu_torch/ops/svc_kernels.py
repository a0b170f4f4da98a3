"""Kernel A: fused SVC decision function + feature gradient.

``svc_f_grad`` is the wrapper of the CUDA kernel ``csrc/svc_fgrad.cu``
(the port of the TPU kernel ``pallas_kernels.svc_f_grad_pallas``).  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain PyTorch
version ``svc_f_grad_plain``, which follows the JAX package's
``constitutive.svc_decision_and_gradient`` (matmul-expansion distances
``rbf_d2``, the JAX ``_rbf_d2``).
"""
import torch

from pylabfea_tpu_torch.kernels import build

#: the feature counts the kernel is instantiated for (6-D stress features)
KERNEL_NFEAT = (6,)


def rbf_d2(x, sv):
    """Pairwise squared distances |x|^2 + |sv|^2 - 2 x @ sv.T, clipped at
    0 (the matmul expansion of the JAX ``constitutive._rbf_d2``; the CUDA
    kernel uses exact subtract-square distances instead)."""
    d2 = (torch.sum(x * x, dim=-1)[:, None]
          + torch.sum(sv * sv, dim=-1)[None, :]
          - 2. * (x @ sv.T))
    return torch.clamp(d2, min=0.)


def svc_f_grad_plain(x, sv, dc, gamma, rho, with_grad=True):
    """Plain PyTorch f (N,) and g (N, F) (g is None without ``with_grad``);
    writes the (N, nsv) kernel matrix."""
    k = torch.exp(-gamma * rbf_d2(x, sv))
    f = k @ dc + rho
    if not with_grad:
        return f, None
    w = dc[None, :] * k
    g = -2. * gamma * (torch.sum(w, dim=-1)[:, None] * x - w @ sv)
    return f, g


def _check(x, sv, dc):
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'svc_f_grad: dtype {x.dtype} not supported')
    for name, t in (('sv', sv), ('dc', dc)):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f'svc_f_grad: {name} is {t.dtype} on {t.device},'
                            f' x is {x.dtype} on {x.device}')
        if not t.is_contiguous():
            raise ValueError(f'svc_f_grad: {name} must be contiguous')
    if not x.is_contiguous():
        raise ValueError('svc_f_grad: x must be contiguous')
    if x.dim() != 2 or sv.dim() != 2 or dc.dim() != 1 \
            or sv.shape[1] != x.shape[1] or dc.shape[0] != sv.shape[0]:
        raise ValueError(f'svc_f_grad: shapes x {tuple(x.shape)}, sv '
                         f'{tuple(sv.shape)}, dc {tuple(dc.shape)}')
    if x.shape[1] not in KERNEL_NFEAT:
        raise ValueError(f'svc_f_grad: kernel built for {KERNEL_NFEAT} '
                         f'features, got {x.shape[1]}')
    if sv.shape[0] == 0:
        raise ValueError('svc_f_grad: no support vectors')


def svc_f_grad(x, sv, dc, gamma: float, rho: float, with_grad=True):
    """f(x) = sum_s dc_s exp(-gamma |x - sv_s|^2) + rho and its gradient.

    x (N, F), sv (nsv, F), dc (nsv,) on one device, float32 or float64;
    ``gamma``/``rho`` host floats.  Returns (f (N,), g (N, F) or None)."""
    if x.device.type == 'cpu':
        return svc_f_grad_plain(x, sv, dc, gamma, rho, with_grad)
    if x.device.type != 'cuda':
        raise TypeError(f'svc_f_grad: device {x.device} not supported')
    _check(x, sv, dc)
    n, nfeat = x.shape
    f = torch.empty(n, dtype=x.dtype, device=x.device)
    g = torch.empty_like(x) if with_grad else None
    if n == 0:
        return f, g
    lib = build.load().lib
    fn = lib.pylabfea_svc_fgrad_f32 if x.dtype == torch.float32 \
        else lib.pylabfea_svc_fgrad_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), sv.data_ptr(), dc.data_ptr(), n, sv.shape[0],
                 nfeat, float(gamma), float(rho), f.data_ptr(),
                 g.data_ptr() if with_grad else None, int(with_grad), stream)
    build.check(err, 'svc_f_grad')
    svc_f_grad.launches += 1
    return f, g


#: kernel launches since the last reset (a plain integer; set it to 0)
svc_f_grad.launches = 0
