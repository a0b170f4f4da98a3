"""Kernel C: matrix-free stiffness apply on structured 3-D hex8 grids.

``k_apply3`` is the wrapper of the CUDA kernel ``csrc/kapply3d.cu`` (the
port of the TPU kernel ``volume_pallas.k_apply3_stencil``).  A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain PyTorch version
``k_apply3_plain``, which follows the 8-Gauss-point partial assembly of the
JAX package's ``fe3d._k_apply3_fori``: gather the 24 element dof volumes,
strain, tangent, B^T, scatter-add to the nodes.  The volume helpers accept
leading batch dimensions.
"""
import numpy as np
import torch

from pylabfea_tpu_torch.kernels import build

#: element corners (dx, dy, dz), z fastest: element dof i = 3 * corner + c
CORNERS3 = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                 for dz in (0, 1))


def hex_B(lx, ly, lz, dtype=np.float64):
    """B matrices (8, 6, 24) of the trilinear hex8 at the 8 Gauss points:
    strain rows in Voigt order (11, 22, 33, 23, 13, 12) with engineering
    shears, element dofs corner-major, component-minor."""
    cpos = np.sqrt(1. / 3.)
    L = (lx, ly, lz)
    Bs = np.zeros((8, 6, 24), dtype=dtype)
    for g, gc in enumerate(CORNERS3):
        xi = np.array([(2 * c - 1) * cpos for c in gc])
        for a, cn in enumerate(CORNERS3):
            s = np.array([2. * c - 1. for c in cn])
            f = 0.5 * (1. + s * xi)
            dN = np.empty(3)
            for d in range(3):
                prod = 0.5 * s[d] * 2. / L[d]
                for e in range(3):
                    if e != d:
                        prod *= f[e]
                dN[d] = prod
            B = Bs[g]
            ix, iy, iz = 3 * a, 3 * a + 1, 3 * a + 2
            B[0, ix] = dN[0]
            B[1, iy] = dN[1]
            B[2, iz] = dN[2]
            B[3, iy] = dN[2]
            B[3, iz] = dN[1]
            B[4, ix] = dN[2]
            B[4, iz] = dN[0]
            B[5, ix] = dN[1]
            B[5, iy] = dN[0]
    return Bs


_B1 = hex_B(1., 1., 1.)[0]
#: static sparsity of the hex8 B rows (the same at every Gauss point):
#: strain row a touches these element dofs ...
ROW_DOFS = tuple(tuple(i for i in range(24) if _B1[a, i]) for a in range(6))
#: ... and element dof i enters these strain rows
COL_ROWS = tuple(tuple(a for a in range(6) if _B1[a, i]) for i in range(24))


def gather_vols(v, NX, NY, NZ):
    """Nodal volumes (u0, u1, u2) -> list of 24 (..., NX, NY, NZ) element
    dof volumes (corner-major, component-minor) by shifted slices."""
    return [v[c][..., dx:dx + NX, dy:dy + NY, dz:dz + NZ]
            for dx, dy, dz in CORNERS3 for c in range(3)]


def scatter_vols(f24, NX, NY, NZ):
    """24 element dof volumes -> nodal volume tuple (scatter-add in corner
    order)."""
    shape = f24[0].shape[:-3] + (NX + 1, NY + 1, NZ + 1)
    out = [f24[0].new_zeros(shape) for _ in range(3)]
    for a, (dx, dy, dz) in enumerate(CORNERS3):
        for c in range(3):
            out[c][..., dx:dx + NX, dy:dy + NY, dz:dz + NZ] += f24[3 * a + c]
    return tuple(out)


def k_apply3_plain(Cp, u0, u1, u2, lx, ly, lz):
    """Plain PyTorch K u: (o0, o1, o2) nodal volumes, no boundary rows.
    Sums over the 8 Gauss points: strain from the gathered corner values,
    tangent, B^T, scatter-add, as ``fe3d._k_apply3_fori`` does."""
    NX, NY, NZ = Cp.shape[1:]
    npdt = np.float32 if Cp.dtype == torch.float32 else np.float64
    B = hex_B(lx, ly, lz).astype(npdt).tolist()
    up = gather_vols((u0, u1, u2), NX, NY, NZ)
    acc = None
    for g in range(8):
        Bg = B[g]
        eps = [sum(up[i] * Bg[a][i] for i in ROW_DOFS[a]) for a in range(6)]
        sig = [sum(Cp[6 * a + b] * eps[b] for b in range(6))
               for a in range(6)]
        f24 = [sum(sig[a] * Bg[a][i] for a in COL_ROWS[i])
               for i in range(24)]
        fg = scatter_vols(f24, NX, NY, NZ)
        acc = fg if acc is None else tuple(x + y for x, y in zip(acc, fg))
    jacw = lx * ly * lz / 8.
    return tuple(jacw * a for a in acc)


def _check(Cp, u0, u1, u2):
    if Cp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'k_apply3: dtype {Cp.dtype} not supported')
    if Cp.dim() != 4 or Cp.shape[0] != 36:
        raise ValueError(f'k_apply3: Cp must be (36, NX, NY, NZ), got '
                         f'{tuple(Cp.shape)}')
    nn = tuple(n + 1 for n in Cp.shape[1:])
    for name, t in (('Cp', Cp), ('u0', u0), ('u1', u1), ('u2', u2)):
        if t.dtype != Cp.dtype or t.device != Cp.device:
            raise TypeError(f'k_apply3: {name} is {t.dtype} on {t.device}, '
                            f'Cp is {Cp.dtype} on {Cp.device}')
        if not t.is_contiguous():
            raise ValueError(f'k_apply3: {name} must be contiguous')
        if name != 'Cp' and (tuple(t.shape[-3:]) != nn
                             or t.shape != u0.shape):
            raise ValueError(f'k_apply3: {name} must be (..., *{nn}) like '
                             f'u0, got {tuple(t.shape)}')


def k_apply3(Cp, u0, u1, u2, lx, ly, lz):
    """K u on a structured hex8 grid (callers mask fixed dofs).

    Cp (36, NX, NY, NZ) tangent volumes, u0/u1/u2 (..., NX+1, NY+1, NZ+1)
    displacement volumes, float32 or float64, with the same leading batch
    dimensions (one launch a batch item on the card); lx, ly, lz the
    element edge lengths.  Returns (o0, o1, o2)."""
    if Cp.device.type not in ('cpu', 'cuda'):
        raise TypeError(f'k_apply3: device {Cp.device} not supported')
    # checked on the CPU too, so the CPU tests hold callers to the layout
    # the kernel takes
    _check(Cp, u0, u1, u2)
    if Cp.device.type == 'cpu':
        return k_apply3_plain(Cp, u0, u1, u2, lx, ly, lz)
    NX, NY, NZ = Cp.shape[1:]
    out = tuple(torch.empty_like(u0) for _ in range(3))
    lib = build.load().lib
    fn = lib.pylabfea_kapply3d_f32 if Cp.dtype == torch.float32 \
        else lib.pylabfea_kapply3d_f64
    nn = u0.shape[-3:]
    items = list(zip(*(t.reshape((-1,) + nn) for t in (u0, u1, u2) + out)))
    with torch.cuda.device(Cp.device):
        stream = torch.cuda.current_stream(Cp.device).cuda_stream
        for v in items:
            # x_chunk 0: the kernel picks the node layers a block marches
            # over
            err = fn(Cp.data_ptr(), *(t.data_ptr() for t in v), NX, NY, NZ,
                     float(lx), float(ly), float(lz), 0, stream)
            build.check(err, 'k_apply3')
            k_apply3.launches += 1
    return out


#: kernel launches since the last reset (a plain integer; set it to 0)
k_apply3.launches = 0
