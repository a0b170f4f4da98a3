"""Kernel B: matrix-free stiffness apply on structured 2-D grids.

``k_apply`` is the wrapper of the CUDA kernel ``csrc/kapply2d.cu`` (the
port of the TPU kernel ``stencil_pallas.k_apply_stencil``).  A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain PyTorch version
``k_apply_plain``: gather the 8 element dof planes, contract with the
stiffness planes, scatter-add to the nodes (``fe_kernels.py:347-375`` of
the JAX package).  The plane helpers accept leading batch dimensions.
"""
import torch

from pylabfea_tpu_torch.kernels import build

#: element corners (dx, dy) in element dof order: dof j = 2 * corner + comp
CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def gather_planes(v, NX, NY):
    """Nodal planes (ux, uy) -> tuple of 8 (..., NX, NY) element dof planes
    (corner-major, component-minor) by shifted slices."""
    out = []
    for dx, dy in CORNERS:
        out.append(v[0][..., dx:dx + NX, dy:dy + NY])
        out.append(v[1][..., dx:dx + NX, dy:dy + NY])
    return tuple(out)


def contract_planes(Kp, up):
    """fp_i = sum_j Kp[i, j] * up_j."""
    return tuple(sum(Kp[i, j] * up[j] for j in range(8)) for i in range(8))


def scatter_planes(fp, NX, NY):
    """Tuple of 8 element dof planes -> nodal planes (scatter-add)."""
    shape = fp[0].shape[:-2] + (NX + 1, NY + 1)
    out = [fp[0].new_zeros(shape), fp[0].new_zeros(shape)]
    for a, (dx, dy) in enumerate(CORNERS):
        out[0][..., dx:dx + NX, dy:dy + NY] += fp[2 * a]
        out[1][..., dx:dx + NX, dy:dy + NY] += fp[2 * a + 1]
    return (out[0], out[1])


def k_apply_plain(Kp, u0, u1):
    """Plain PyTorch K u: (out0, out1) nodal planes, no boundary rows."""
    NX, NY = Kp.shape[2], Kp.shape[3]
    return scatter_planes(
        contract_planes(Kp, gather_planes((u0, u1), NX, NY)), NX, NY)


def _check(Kp, u0, u1):
    if Kp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'k_apply: dtype {Kp.dtype} not supported')
    if Kp.dim() != 4 or tuple(Kp.shape[:2]) != (8, 8):
        raise ValueError(f'k_apply: Kp must be (8, 8, NX, NY), got '
                         f'{tuple(Kp.shape)}')
    nn = (Kp.shape[2] + 1, Kp.shape[3] + 1)
    for name, t in (('Kp', Kp), ('u0', u0), ('u1', u1)):
        if t.dtype != Kp.dtype or t.device != Kp.device:
            raise TypeError(f'k_apply: {name} is {t.dtype} on {t.device}, '
                            f'Kp is {Kp.dtype} on {Kp.device}')
        if not t.is_contiguous():
            raise ValueError(f'k_apply: {name} must be contiguous')
    for name, t in (('u0', u0), ('u1', u1)):
        if tuple(t.shape) != nn:
            raise ValueError(f'k_apply: {name} must be {nn}, got '
                             f'{tuple(t.shape)}')


def k_apply(Kp, u0, u1):
    """K u on a structured grid (callers mask fixed dofs).

    Kp (8, 8, NX, NY) element stiffness planes, u0/u1 (NX+1, NY+1)
    displacement planes, float32 or float64.  Returns (out0, out1)."""
    if Kp.device.type == 'cpu':
        return k_apply_plain(Kp, u0, u1)
    if Kp.device.type != 'cuda':
        raise TypeError(f'k_apply: device {Kp.device} not supported')
    _check(Kp, u0, u1)
    NX, NY = Kp.shape[2], Kp.shape[3]
    o0 = torch.empty_like(u0)
    o1 = torch.empty_like(u1)
    lib = build.load().lib
    fn = lib.pylabfea_kapply2d_f32 if Kp.dtype == torch.float32 \
        else lib.pylabfea_kapply2d_f64
    with torch.cuda.device(Kp.device):
        stream = torch.cuda.current_stream(Kp.device).cuda_stream
        err = fn(Kp.data_ptr(), u0.data_ptr(), u1.data_ptr(), o0.data_ptr(),
                 o1.data_ptr(), NX, NY, stream)
    build.check(err, 'k_apply')
    k_apply.launches += 1
    return o0, o1


#: kernel launches since the last reset (a plain integer; set it to 0)
k_apply.launches = 0
