"""PyTorch port: the 3-D hex8 stiffness apply (kernel C's plain version and
the arithmetic of its CUDA kernel) against the JAX reference on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylabfea_tpu.ops import fe3d as jfe3d
from pylabfea_tpu.ops import volume_pallas as vp
from pylabfea_tpu_torch.ops import fe3d as tfe3d
from pylabfea_tpu_torch.ops import volume

# One torch thread: the suite runs several test processes at once, and
# torch's default one-thread-per-core pool oversubscribes the cores that the
# JAX tests' 8-device collectives need (their rendezvous then stalls).
torch.set_num_threads(1)

SHAPES = [(8, 8, 8), (6, 4, 10)]
L = (1., 1.3, 0.7)


def _inputs(NX, NY, NZ, seed=3):
    """Random symmetric positive tangent volumes and nodal volumes."""
    rng = np.random.default_rng(seed)
    C6 = rng.normal(size=(6, 6, NX, NY, NZ))
    C6 = 0.5 * (C6 + C6.transpose(1, 0, 2, 3, 4)) \
        + 6. * np.eye(6)[:, :, None, None, None]
    u = [rng.normal(size=(NX + 1, NY + 1, NZ + 1)) for _ in range(3)]
    return C6.reshape(36, NX, NY, NZ), u


def _edges(NX, NY, NZ):
    return L[0] / NX, L[1] / NY, L[2] / NZ


def _jax_mesh(NX, NY, NZ, dtype):
    return jfe3d.box_mesh(NX, NY, NZ, LX=L[0], LY=L[1], LZ=L[2], uniax='z',
                          eps_tot=0.001, dtype=dtype)


def test_hex_B_and_modes_bitwise_f64():
    lx, ly, lz = 0.7, 1.3, 2.1
    np.testing.assert_array_equal(tfe3d._hex_B(lx, ly, lz),
                                  np.asarray(jfe3d._hex_B(lx, ly, lz)))
    tm, jm = tfe3d._hex_B_modes(lx, ly, lz), jfe3d._hex_B_modes(lx, ly, lz)
    assert len(tm) == len(jm) == 7
    for (Bt, wt, rt), (Bj, wj, rj) in zip(tm, jm):
        np.testing.assert_array_equal(np.asarray(Bt), np.asarray(Bj))
        assert (wt, rt) == (wj, rj)
    assert volume.CORNERS3 == jfe3d._CORNERS3
    assert (volume.ROW_DOFS, volume.COL_ROWS) == (jfe3d._ROW_DOFS,
                                                  jfe3d._COL_ROWS)


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_matches_jax_fori_f64(shape):
    """The plain version against the JAX package's CPU path, 1e-12."""
    Cp, u = _inputs(*shape)
    md = _jax_mesh(*shape, jnp.float64)
    ref = jfe3d._k_apply3_fori(md, jnp.asarray(Cp),
                               tuple(jnp.asarray(x) for x in u))
    out = volume.k_apply3_plain(torch.tensor(Cp), *map(torch.tensor, u),
                                *md.grid[3:6])
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert np.abs(o.numpy() - r).max() <= 1e-12 * np.abs(r).max()


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_matches_pallas_kernel_f32(shape):
    """The plain version against the TPU kernel in interpret mode, in f32,
    at the tolerance of the JAX package's own parity test (3e-6 scale)."""
    Cp, u = _inputs(*shape)
    lx, ly, lz = _edges(*shape)
    f32 = jnp.float32
    ref = vp.k_apply3_stencil(jnp.asarray(Cp, f32),
                              *(jnp.asarray(x, f32) for x in u), lx, ly, lz,
                              interpret=True)
    out = volume.k_apply3_plain(
        torch.tensor(Cp, dtype=torch.float32),
        *(torch.tensor(x, dtype=torch.float32) for x in u), lx, ly, lz)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert np.abs(o.numpy() - r).max() <= 3e-6 * np.abs(r).max()


def _element_forces(Cp, H, lx, ly, lz):
    """numpy mirror of the element arithmetic of ``csrc/kapply3d.cu`` on
    any block of elements: Cp (36, ...) tangents and H[c][a] (...) corner
    values (transformed in place) -> the rounded corner forces S[a][c]
    (...): the Walsh-Hadamard transform of the corner values, the 7 parity
    modes, the transposed transform, times jacw."""
    bit = (4, 2, 1)

    def voigt(c, d):
        return c if c == d else 6 - c - d

    def wht(V, inverse):
        for b in (1, 2, 4):
            for a in range(8):
                if a & b:
                    continue
                lo, hi = V[a], V[a | b]
                V[a], V[a | b] = (lo - hi, lo + hi) if inverse \
                    else (hi + lo, hi - lo)

    g = [0.25 / x for x in (lx, ly, lz)]
    for c in range(3):
        wht(H[c], False)
    T = [[np.zeros(Cp.shape[1:]) for _ in range(8)] for _ in range(3)]
    for p in range(7):
        w = 8. / 3. ** bin(p).count('1')
        eps = [np.zeros(Cp.shape[1:]) for _ in range(6)]
        act = [False] * 6
        for c in range(3):
            for d in range(3):
                if not p & bit[d]:
                    eps[voigt(c, d)] = eps[voigt(c, d)] \
                        + g[d] * H[c][p | bit[d]]
                    act[voigt(c, d)] = True
        sig = [sum(Cp[6 * r + b] * eps[b] for b in range(6) if act[b])
               if act[r] else 0. for r in range(6)]
        for c in range(3):
            for d in range(3):
                if not p & bit[d]:
                    T[c][p | bit[d]] = T[c][p | bit[d]] \
                        + w * g[d] * sig[voigt(c, d)]
    for c in range(3):
        wht(T[c], True)
    jacw = lx * ly * lz / 8.
    return [[jacw * T[c][a] for c in range(3)] for a in range(8)]


def _two_pass(Cp, u, lx, ly, lz):
    """Every element's forces over the whole grid, then the scatter in
    corner order: the summation the tiled kernel has to reproduce."""
    NX, NY, NZ = Cp.shape[1:]
    H = [[u[c][(a >> 2):(a >> 2) + NX, ((a >> 1) & 1):((a >> 1) & 1) + NY,
               (a & 1):(a & 1) + NZ].copy() for a in range(8)]
         for c in range(3)]
    S = _element_forces(Cp, H, lx, ly, lz)
    return volume.scatter_vols([torch.tensor(S[a][c]) for a in range(8)
                                for c in range(3)], NX, NY, NZ)


def _kernel_arithmetic(Cp, u, lx, ly, lz, x_chunk, ty, tz):
    """numpy mirror of ``csrc/kapply3d.cu``'s tiling: a block per ty x tz
    node tile in y-z and x_chunk node layers in x marches layer by layer;
    per layer ex it computes the forces of its (ty+1) x (tz+1) element slab
    (halo elements included) into B (corners 0..3) and A[ex & 1] (corners
    4..7), then sums every node of layer ex in corner order from B and
    A[(ex - 1) & 1].  Absent slab entries are NaN, so a read of one
    shows."""
    NX, NY, NZ = Cp.shape[1:]
    EY, EZ = ty + 1, tz + 1
    out = [np.full((NX + 1, NY + 1, NZ + 1), np.nan) for _ in range(3)]
    for X0 in range(0, NX + 1, x_chunk):
        for J0 in range(0, NY + 1, ty):
            for K0 in range(0, NZ + 1, tz):
                A = [None, None]
                for ex in range(X0 - 1, min(X0 + x_chunk, NX + 1)):
                    B = None
                    if 0 <= ex < NX:
                        y0, y1 = max(J0 - 1, 0), min(J0 + ty - 1, NY - 1)
                        z0, z1 = max(K0 - 1, 0), min(K0 + tz - 1, NZ - 1)
                        H = [[u[c][ex + (a >> 2),
                                   y0 + ((a >> 1) & 1):y1 + 1 + ((a >> 1) & 1),
                                   z0 + (a & 1):z1 + 1 + (a & 1)].copy()
                              for a in range(8)] for c in range(3)]
                        S = _element_forces(
                            Cp[:, ex, y0:y1 + 1, z0:z1 + 1], H, lx, ly, lz)
                        slab = np.full((8, 3, EY, EZ), np.nan)
                        slab[:, :, y0 - J0 + 1:y1 - J0 + 2,
                             z0 - K0 + 1:z1 - K0 + 2] = S
                        B, A[ex & 1] = slab[:4], slab[4:]
                    if ex < X0:
                        continue
                    nJ = min(ty, NY + 1 - J0)
                    nK = min(tz, NZ + 1 - K0)
                    acc = np.zeros((3, nJ, nK))
                    J = J0 + np.arange(nJ)[:, None]
                    K = K0 + np.arange(nK)[None, :]
                    for a in range(8):
                        dx, dy, dz = a >> 2, (a >> 1) & 1, a & 1
                        if not 0 <= ex - dx < NX:
                            continue
                        src = A[(ex - 1) & 1] if dx else B
                        have = (J - dy >= 0) & (J - dy < NY) \
                            & (K - dz >= 0) & (K - dz < NZ)
                        v = src[a & 3][:, 1 - dy:1 - dy + nJ,
                                       1 - dz:1 - dz + nK]
                        acc = np.where(have, acc + v, acc)
                    for c in range(3):
                        out[c][ex, J0:J0 + nJ, K0:K0 + nK] = acc[c]
    return tuple(torch.tensor(o) for o in out)


#: (x_chunk, ty, tz): the card's 7 x 31 node tile, and small tiles that
#: divide none of the shapes, so every tile edge and chunk start is met
TILES = [(3, 7, 31), (2, 2, 4)]


@pytest.mark.parametrize('tiles', TILES)
@pytest.mark.parametrize('shape', SHAPES + [(1, 1, 1), (5, 3, 7)])
def test_kernel_arithmetic_matches_plain_f64(shape, tiles):
    """The CUDA kernel's arithmetic and tiling (mirrored in numpy) equals
    the 8-Gauss-point plain version to round-off, and, node by node, the
    bits of summing every element's forces in corner order (the scatter
    of the two-pass design it replaced)."""
    Cp, u = _inputs(*shape, seed=4)
    lx, ly, lz = _edges(*shape)
    out = _kernel_arithmetic(Cp, u, lx, ly, lz, *tiles)
    ref = volume.k_apply3_plain(torch.tensor(Cp), *map(torch.tensor, u),
                                lx, ly, lz)
    for o, r, t in zip(out, ref, _two_pass(Cp, u, lx, ly, lz)):
        assert torch.equal(o, t)
        assert float((o - r).abs().max()) <= 1e-12 * float(r.abs().max())


def test_wrapper_dispatch_on_the_cpu_and_other_devices():
    """A CPU tensor takes the plain version without a launch; any other
    device than CPU or CUDA raises."""
    Cp, u = _inputs(3, 2, 4)
    args = (torch.tensor(Cp), *map(torch.tensor, u), 0.5, 0.5, 0.25)
    n0 = volume.k_apply3.launches
    for a, b in zip(volume.k_apply3(*args), volume.k_apply3_plain(*args)):
        assert torch.equal(a, b)
    assert volume.k_apply3.launches == n0
    meta = dict(device='meta')
    with pytest.raises(TypeError):
        volume.k_apply3(torch.empty(36, 3, 2, 4, **meta),
                        *(torch.empty(4, 3, 5, **meta) for _ in range(3)),
                        0.5, 0.5, 0.25)
