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


def _kernel_arithmetic(Cp, u, lx, ly, lz):
    """numpy mirror of ``csrc/kapply3d.cu``: per element, the Walsh-Hadamard
    transform of the corner values, the 7 parity modes, the transposed
    transform into a (24, NX, NY, NZ) scratch; then the node pass summing
    adjacent elements in corner order."""
    NX, NY, NZ = Cp.shape[1:]
    bit = (4, 2, 1)

    def voigt(c, d):
        return c if c == d else 6 - c - d

    def wht(H, inverse):
        for b in (1, 2, 4):
            for a in range(8):
                if a & b:
                    continue
                lo, hi = H[a], H[a | b]
                H[a], H[a | b] = (lo - hi, lo + hi) if inverse \
                    else (hi + lo, hi - lo)

    g = [0.25 / x for x in (lx, ly, lz)]
    H = [[u[c][(a >> 2):(a >> 2) + NX, ((a >> 1) & 1):((a >> 1) & 1) + NY,
               (a & 1):(a & 1) + NZ].copy() for a in range(8)]
         for c in range(3)]
    for c in range(3):
        wht(H[c], False)
    T = [[np.zeros((NX, NY, NZ)) for _ in range(8)] for _ in range(3)]
    for p in range(7):
        w = 8. / 3. ** bin(p).count('1')
        eps = [np.zeros((NX, NY, NZ)) for _ in range(6)]
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
    S = [jacw * T[c][a] for a in range(8) for c in range(3)]
    return volume.scatter_vols([torch.tensor(s) for s in S], NX, NY, NZ)


@pytest.mark.parametrize('shape', SHAPES + [(1, 1, 1)])
def test_kernel_arithmetic_matches_plain_f64(shape):
    """The mode-factorized Walsh-Hadamard arithmetic of the CUDA kernel
    (mirrored in numpy) equals the 8-Gauss-point plain version to
    round-off."""
    Cp, u = _inputs(*shape, seed=4)
    lx, ly, lz = _edges(*shape)
    out = _kernel_arithmetic(Cp, u, lx, ly, lz)
    ref = volume.k_apply3_plain(torch.tensor(Cp), *map(torch.tensor, u),
                                lx, ly, lz)
    for o, r in zip(out, ref):
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
