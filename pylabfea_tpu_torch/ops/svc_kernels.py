"""The SVC kernels: A (fused decision function + feature gradient, exact
distances), D (decision function alone) and E (decision function +
gradient, matmul-expansion distances).

Each wrapper launches its CUDA kernel on a CUDA tensor or raises; a CPU
tensor takes the plain PyTorch version, which follows the JAX package's
``constitutive`` SVC functions (matmul-expansion distances ``rbf_d2``, the
JAX ``_rbf_d2``):

* ``svc_f_grad`` -> ``csrc/svc_fgrad.cu``, the port of
  ``pallas_kernels.svc_f_grad_pallas`` (the fast return map);
* ``svc_decision`` -> ``csrc/svc_decision.cu``, the port of
  ``pallas_kernels.svc_decision_pallas`` (the yield function and the
  yield-locus distance of the faithful return map);
* ``svc_f_grad_mm`` -> ``csrc/svc_fgrad_mm.cu``, the port of
  ``pallas_kernels.svc_f_grad_pallas_mxu`` (the faithful flow rule).
"""
import torch

from pylabfea_tpu_torch.kernels import build

#: the feature counts the kernels are instantiated for (6-D stress features)
KERNEL_NFEAT = (6,)


def rbf_d2(x, sv):
    """Pairwise squared distances |x|^2 + |sv|^2 - 2 x @ sv.T, clipped at
    0 (the matmul expansion of the JAX ``constitutive._rbf_d2``; kernel A
    uses exact subtract-square distances instead)."""
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


def _check(what, x, sv, dc):
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{what}: dtype {x.dtype} not supported')
    for name, t in (('sv', sv), ('dc', dc)):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f'{what}: {name} is {t.dtype} on {t.device}, '
                            f'x is {x.dtype} on {x.device}')
        if not t.is_contiguous():
            raise ValueError(f'{what}: {name} must be contiguous')
    if not x.is_contiguous():
        raise ValueError(f'{what}: x must be contiguous')
    if x.dim() != 2 or sv.dim() != 2 or dc.dim() != 1 \
            or sv.shape[1] != x.shape[1] or dc.shape[0] != sv.shape[0]:
        raise ValueError(f'{what}: shapes x {tuple(x.shape)}, sv '
                         f'{tuple(sv.shape)}, dc {tuple(dc.shape)}')
    if x.shape[1] not in KERNEL_NFEAT:
        raise ValueError(f'{what}: kernel built for {KERNEL_NFEAT} '
                         f'features, got {x.shape[1]}')
    if sv.shape[0] == 0:
        raise ValueError(f'{what}: no support vectors')


def _launch(what, stem, x, sv, dc, gamma, rho, *outs):
    """Check the inputs, launch ``pylabfea_<stem>_<dtype>`` on the current
    stream with the trailing arguments ``outs`` (a tensor passes its
    pointer, None a null pointer, an int itself), and raise on a launch
    error."""
    _check(what, x, sv, dc)
    lib = build.load().lib
    fn = getattr(lib, f'pylabfea_{stem}_'
                      f'{"f32" if x.dtype == torch.float32 else "f64"}')
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), sv.data_ptr(), dc.data_ptr(), x.shape[0],
                 sv.shape[0], x.shape[1], float(gamma), float(rho),
                 *(o if o is None or isinstance(o, int) else o.data_ptr()
                   for o in outs), stream)
    build.check(err, what)


def _device_ok(what, x):
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if x.device.type == 'cpu':
        return False
    if x.device.type != 'cuda':
        raise TypeError(f'{what}: device {x.device} not supported')
    return True


def svc_f_grad(x, sv, dc, gamma: float, rho: float, with_grad=True):
    """Kernel A: f(x) = sum_s dc_s exp(-gamma |x - sv_s|^2) + rho and its
    gradient.

    x (N, F), sv (nsv, F), dc (nsv,) on one device, float32 or float64;
    ``gamma``/``rho`` host floats.  Returns (f (N,), g (N, F) or None)."""
    if not _device_ok('svc_f_grad', x):
        return svc_f_grad_plain(x, sv, dc, gamma, rho, with_grad)
    f = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    g = torch.empty_like(x) if with_grad else None
    if x.shape[0] == 0:
        _check('svc_f_grad', x, sv, dc)
        return f, g
    _launch('svc_f_grad', 'svc_fgrad', x, sv, dc, gamma, rho, f, g,
            int(with_grad))
    svc_f_grad.launches += 1
    return f, g


def svc_decision(x, sv, dc, gamma: float, rho: float):
    """Kernel D: the decision function alone with matmul-expansion
    distances, f(x) = sum_s dc_s exp(-gamma max(|x|^2 + |sv_s|^2 -
    2 x.sv_s, 0)) + rho.  Arguments as ``svc_f_grad``; returns f (N,)."""
    if not _device_ok('svc_decision', x):
        return svc_f_grad_plain(x, sv, dc, gamma, rho, with_grad=False)[0]
    f = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        _check('svc_decision', x, sv, dc)
        return f
    _launch('svc_decision', 'svc_decision', x, sv, dc, gamma, rho, f)
    svc_decision.launches += 1
    return f


def svc_f_grad_mm(x, sv, dc, gamma: float, rho: float):
    """Kernel E: f and its gradient g = -2 gamma (ws x - w @ sv) with
    matmul-expansion distances (the arithmetic of ``svc_f_grad_plain``).
    Arguments as ``svc_f_grad``; returns (f (N,), g (N, F))."""
    if not _device_ok('svc_f_grad_mm', x):
        return svc_f_grad_plain(x, sv, dc, gamma, rho)
    f = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    g = torch.empty_like(x)
    if x.shape[0] == 0:
        _check('svc_f_grad_mm', x, sv, dc)
        return f, g
    _launch('svc_f_grad_mm', 'svc_fgrad_mm', x, sv, dc, gamma, rho, f, g)
    svc_f_grad_mm.launches += 1
    return f, g


#: kernel launches since the last reset (plain integers; set them to 0)
svc_f_grad.launches = 0
svc_decision.launches = 0
svc_f_grad_mm.launches = 0
