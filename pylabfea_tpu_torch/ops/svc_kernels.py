"""The SVC kernels: A (fused decision function + feature gradient, exact
distances), D (decision function alone), E (decision function +
gradient, matmul-expansion distances) and G (the yield-locus root finder
of ``constitutive.ml_yf_dist``, on D's body).

Each wrapper launches its CUDA kernel on a CUDA tensor or raises; a CPU
tensor takes the plain PyTorch version, which follows the JAX package's
``constitutive`` SVC functions (matmul-expansion distances ``rbf_d2``, the
JAX ``_rbf_d2``).  The kernels take F = 1 .. ``MAX_NFEAT`` features per
point: compiled for 2, 6 and 15 (the cylindrical, stress and
work-hardening layouts), and for every other width (texture layouts,
6 + tdim or 15 + tdim) with F a launch argument.  Each wrapper counts
its launches in ``launches`` and, by feature count, in
``launches_by_nfeat``:

* ``svc_f_grad`` -> ``csrc/svc_fgrad.cu``, the port of
  ``pallas_kernels.svc_f_grad_pallas`` (the fast return map);
* ``svc_decision`` -> ``csrc/svc_decision.cu``, the port of
  ``pallas_kernels.svc_decision_pallas`` (the yield function);
* ``svc_f_grad_mm`` -> ``csrc/svc_fgrad_mm.cu``, the port of
  ``pallas_kernels.svc_f_grad_pallas_mxu`` (the faithful flow rule);
* ``svc_yf_root`` -> ``csrc/yf_root.cu``, the marching while_loops and
  ``rootfind.brent_jax`` of the JAX ``ml_yf_dist`` over
  ``svc_decision_pallas``, one launch per call (its plain version
  ``svc_yf_root_plain`` composes them from ``svc_f_grad_plain`` and
  ``rootfind.brent``), with the features of ``x * su`` that a
  ``FeatureMap`` describes.
"""
from collections import Counter
from dataclasses import dataclass

import torch

from pylabfea_tpu_torch.kernels import build
from pylabfea_tpu_torch.ops import jtensors as jt
from pylabfea_tpu_torch.ops import rootfind

#: the most features a point may have in the kernels (their runtime-F
#: forms keep a point's features in arrays of at most this many values)
MAX_NFEAT = 256


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


def _check_svc(what, x, sv, dc):
    """Raise unless sv (nsv, F) and dc (nsv,) are contiguous, of ``x``'s
    dtype and device, with 1 <= F <= ``MAX_NFEAT`` and nsv > 0."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{what}: dtype {x.dtype} not supported')
    for name, t in (('sv', sv), ('dc', dc)):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f'{what}: {name} is {t.dtype} on {t.device}, '
                            f'x is {x.dtype} on {x.device}')
        if not t.is_contiguous():
            raise ValueError(f'{what}: {name} must be contiguous')
    if sv.dim() != 2 or dc.dim() != 1 or dc.shape[0] != sv.shape[0]:
        raise ValueError(f'{what}: shapes sv {tuple(sv.shape)}, dc '
                         f'{tuple(dc.shape)}')
    if not 1 <= sv.shape[1] <= MAX_NFEAT:
        raise ValueError(f'{what}: the kernels take 1 to {MAX_NFEAT} '
                         f'features, got {sv.shape[1]}')
    if sv.shape[0] == 0:
        raise ValueError(f'{what}: no support vectors')


def _check(what, x, sv, dc):
    """``_check_svc`` and x (N, F) contiguous."""
    _check_svc(what, x, sv, dc)
    if not x.is_contiguous():
        raise ValueError(f'{what}: x must be contiguous')
    if x.dim() != 2 or x.shape[1] != sv.shape[1]:
        raise ValueError(f'{what}: shapes x {tuple(x.shape)}, sv '
                         f'{tuple(sv.shape)}')


def _count(wrapper, nfeat):
    wrapper.launches += 1
    wrapper.launches_by_nfeat[nfeat] += 1


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
    _count(svc_f_grad, x.shape[1])
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
    _count(svc_decision, x.shape[1])
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
    _count(svc_f_grad_mm, x.shape[1])
    return f, g


#: most bracket-marching steps per direction of the yield-locus root find
MAXMARCH = 400
#: most Brent iterations of the yield-locus root find
MAXITER = 100


def _march(f_of, x, fac, active_of, maxmarch=MAXMARCH):
    """Geometric bracket marching: scale the active lanes' abscissae by
    ``fac`` until no lane is active or ``maxmarch`` steps have run.  The
    inactive lanes are frozen, so reading the active flag on the host
    every ``rootfind.check_every(x)`` steps gives the JAX while_loop's
    result."""
    f = f_of(x)
    it, every = 0, rootfind.check_every(x)
    while it < maxmarch:
        act = active_of(x, f)
        if it % every == 0 and not bool(act.any()):
            break
        x = torch.where(act, x * fac, x)
        f = f_of(x)
        it += 1
    return x


@dataclass
class FeatureMap:
    """The features of the stress rows ``s = x su`` of a yield-locus root
    find (``constitutive._features`` along a ray): the leading features
    from ``s`` and then ``extra``, features that stay fixed while the
    stress scales.  The leading ones are seq_J2(s) / scale_seq - 1 (one
    feature, ``cyl``: the cylindrical layout, s Voigt (N, 6) or principal
    (N, 3)) or the six stress components, deviatoric if ``dev_only``,
    over ``scale_seq`` or, with a texture scaler, (s_k - mean_k) /
    scale_k."""
    scale_seq: float
    dev_only: bool = False
    cyl: bool = False
    mean: torch.Tensor = None    # (6,) texture scaler of the stress block
    scale: torch.Tensor = None
    extra: torch.Tensor = None   # (N, F - lead) per-lane constant features

    @property
    def lead(self):
        """The count of leading, stress-derived features."""
        return 1 if self.cyl else 6

    def __call__(self, s):
        """Feature rows (N, F) of stress rows ``s`` (the plain version)."""
        if self.cyl:
            seq = jt.seq_j2_voigt(s) if s.shape[-1] == 6 \
                else jt.seq_j2_princ(s)
            head = (seq / self.scale_seq - 1.)[:, None]
        else:
            if self.dev_only:
                s = jt.sig_dev(s)
            head = s / self.scale_seq if self.mean is None \
                else (s - self.mean) / self.scale
        return head if self.extra is None \
            else torch.cat([head, self.extra], dim=-1)


def svc_yf_root_plain(su, start, top, sv, dc, gamma: float, rho: float,
                      fmap: FeatureMap, xtol=1.e-5, rtol=rootfind._RTOL,
                      maxmarch=MAXMARCH):
    """Plain PyTorch version of ``svc_yf_root``: the two marching loops and
    ``rootfind.brent`` (its plain step) over the plain decision function,
    on whole tensors with a host read of the active flags."""
    def f_of(x):
        return svc_f_grad_plain(fmap(x[:, None] * su), sv, dc, gamma, rho,
                                with_grad=False)[0]

    x0 = _march(f_of, start, 0.98, lambda x, f: (f >= 0.) & (x > 0.01),
                maxmarch)
    x1 = _march(f_of, start, 1.02, lambda x, f: (f < 0.) & (x < top),
                maxmarch)
    return rootfind.brent(f_of, x0, x1, xtol=xtol, rtol=rtol,
                          maxiter=MAXITER, step=rootfind.brent_step_plain)


def _check_fmap(su, sv, fmap: FeatureMap):
    """Raise on a feature map kernel G would misread."""
    N, F = su.shape[0], sv.shape[1]
    if su.shape[1] != 6 and not (fmap.cyl and su.shape[1] == 3):
        raise ValueError(f'svc_yf_root: su must be (N, 6), or (N, 3) for '
                         f'cylindrical features, got {tuple(su.shape)}')
    if F < fmap.lead or (fmap.cyl and fmap.mean is not None):
        raise ValueError(f'svc_yf_root: {F} features, {fmap.lead} from the '
                         'stress' + (' (no texture scaler in the cylindrical '
                                     'layout)' if fmap.cyl else ''))
    want = {'extra': (N, F - fmap.lead) if F > fmap.lead else None,
            'mean': (6,) if fmap.mean is not None else None,
            'scale': (6,) if fmap.mean is not None else None}
    for name, shape in want.items():
        t = getattr(fmap, name)
        if (t is None) != (shape is None):
            raise ValueError(f'svc_yf_root: FeatureMap.{name} must be '
                             f'{"None" if shape is None else shape}')
        if t is None:
            continue
        if t.dtype != su.dtype or t.device != su.device:
            raise TypeError(f'svc_yf_root: FeatureMap.{name} is {t.dtype} '
                            f'on {t.device}, su is {su.dtype} on {su.device}')
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'svc_yf_root: FeatureMap.{name} must be a '
                             f'contiguous {shape} tensor, got '
                             f'{tuple(t.shape)}')


def svc_yf_root(su, start, top, sv, dc, gamma: float, rho: float,
                fmap: FeatureMap, xtol=1.e-5, rtol=rootfind._RTOL,
                evals=None, maxmarch=MAXMARCH):
    """Kernel G: per lane i the root x of f(x) = decision function of the
    features ``fmap`` forms of ``x * su[i]``: march down from ``start``
    (x *= 0.98 while f >= 0 and x > 0.01), march up from ``start`` (x *=
    1.02 while f < 0 and x < ``top``), each at most ``maxmarch`` steps,
    then Brent on the bracket (at most ``MAXITER`` iterations).  su (N, 6)
    (or (N, 3), cylindrical), start and top (N,), sv and dc as
    ``svc_f_grad``.  Returns (xs (N,), ok (N,) bool): the root where
    Brent converged, else its last abscissa.  ``evals``, an (N,) int32
    tensor on the card, receives each lane's evaluation count."""
    if not _device_ok('svc_yf_root', su):
        if evals is not None:
            raise ValueError('svc_yf_root: evals is counted by the kernel '
                             'only')
        return svc_yf_root_plain(su, start, top, sv, dc, gamma, rho, fmap,
                                 xtol, rtol, maxmarch)
    _check_svc('svc_yf_root', su, sv, dc)
    if su.dim() != 2 or not su.is_contiguous():
        raise ValueError('svc_yf_root: su must be a contiguous matrix')
    _check_fmap(su, sv, fmap)
    N = su.shape[0]
    for name, t in (('start', start), ('top', top)):
        if t.dtype != su.dtype or t.device != su.device:
            raise TypeError(f'svc_yf_root: {name} is {t.dtype} on '
                            f'{t.device}, su is {su.dtype} on {su.device}')
        if t.shape != (N,) or not t.is_contiguous():
            raise ValueError(f'svc_yf_root: {name} must be a contiguous '
                             f'({N},) vector, got {tuple(t.shape)}')
    if evals is not None and (evals.dtype != torch.int32
                              or evals.device != su.device
                              or evals.shape != (N,)
                              or not evals.is_contiguous()):
        raise ValueError(f'svc_yf_root: evals must be a contiguous ({N},) '
                         f'int32 vector on {su.device}')
    xs = torch.empty(N, dtype=su.dtype, device=su.device)
    ok = torch.empty(N, dtype=torch.bool, device=su.device)
    if N == 0:
        return xs, ok

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.load().lib
    fn = lib.pylabfea_yf_root_f32 if su.dtype == torch.float32 \
        else lib.pylabfea_yf_root_f64
    with torch.cuda.device(su.device):
        stream = torch.cuda.current_stream(su.device).cuda_stream
        err = fn(su.data_ptr(), su.shape[1], ptr(fmap.extra), ptr(fmap.mean),
                 ptr(fmap.scale), start.data_ptr(), top.data_ptr(),
                 sv.data_ptr(), dc.data_ptr(), N, sv.shape[0], sv.shape[1],
                 float(gamma), float(rho), float(fmap.scale_seq),
                 int(fmap.dev_only), int(fmap.cyl), int(maxmarch), MAXITER,
                 float(xtol), float(rtol), xs.data_ptr(), ok.data_ptr(),
                 ptr(evals), stream)
    build.check(err, 'svc_yf_root')
    _count(svc_yf_root, sv.shape[1])
    return xs, ok


#: kernel launches since the last reset (plain integers; set them to 0
#: with ``reset_launches``)
KERNELS = (svc_f_grad, svc_decision, svc_f_grad_mm, svc_yf_root)


def reset_launches():
    """Set every SVC kernel's launch counts to 0."""
    for k in KERNELS:
        k.launches = 0
        k.launches_by_nfeat = Counter()


reset_launches()
