// Matrix-free stiffness apply K u on a structured NX x NY x NZ trilinear
// hex8 grid (no boundary rows: the caller masks fixed dofs around the call).
//
// Replaces the TPU kernel pylabfea_tpu/ops/volume_pallas.py
// k_apply3_stencil (_kapply3_kernel).  Every CG apply, Chebyshev sweep,
// V-cycle residual, power-iteration step and boundary right-hand side of
// the 3-D multigrid solve goes through it, at every grid level.
//
// Layout (the JAX package's volumes layout): Cp (36, NX, NY, NZ) tangent
// volumes, entry 6*a + b for Voigt rows (11, 22, 33, 23, 13, 12) with
// engineering shears; u0, u1, u2, o0, o1, o2 are (NX+1, NY+1, NZ+1) nodal
// volumes, row-major (z fastest).  Element corner a = 4 dx + 2 dy + dz and
// element dof i = 3 a + c, the order of fe3d._CORNERS3.
//
// Arithmetic: the exact 7-parity-mode factorization of the 8-point Gauss
// sum (fe3d._hex_B_modes): K_e = jacw sum_p w_p B_p^T C B_p, w_p =
// 8 (1/3)^|p|.  Every mode matrix entry is +-g_d (g_d = 0.25 / L_d) times a
// product of corner signs, so B_p u is a Walsh-Hadamard transform of the
// corner values: with H_c[q] = sum_a u[a][c] chi_q(a) (chi_q(a) = product
// over the bits k of q of s_k(a) = +-1), the displacement gradient of mode
// p is G(c, d) = g_d H_c[p | bit(d)] for every d with bit(d) not in p.
// B_p^T sigma_p gathers the same way into T_c[q], and the corner forces are
// the transposed transform of T_c.  That is 138 tangent multiply-adds per
// element instead of the 8-point loop's 8 x 36.  The scratch pass costs
// 2 x 24 values per element of extra traffic (about 2x the single-pass
// bound); fusing it away is later work.
//
// What bounds it: memory.  The element pass reads the 36 tangent volumes
// once (302 MB in f32 at 128^3) and does about 612 flops per element
// (4 per byte read), far below the card's ~20 f32 flops per byte of memory
// bandwidth.
//
// Design: element-centric, two passes, no atomics.  sigma is per element
// and shared by its 8 nodes, so the node-centric gather of the 2-D kernel
// would repeat the mode work 8 times.  Pass 1 runs one thread per element
// (ez fastest, so the Cp reads coalesce) and writes the element's 24 dof
// forces to a (24, NX, NY, NZ) scratch that the wrapper allocates.  Pass 2
// runs one thread per node and sums the <= 8 adjacent elements' entries in
// corner order 0..7, the order of the plain version's scatter.  The
// summation order is fixed, so every run gives the same bits.  The TPU
// kernel's carry of the +x corner contributions across sequential grid
// steps has no counterpart: CUDA blocks run in no order.  Both launches go
// on the caller's stream; nothing is allocated here.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Consts {
  T g[3];       // 0.25 / L_d: the magnitude of every mode-matrix entry
  T wg[8][3];   // w_p * g_d for parity mode p (p = 7 is empty)
  T jacw;       // Gauss weight * |J| = lx ly lz / 8
};

// bit of axis d in a corner or mode index (x = 4, y = 2, z = 1)
__host__ __device__ constexpr int axis_bit(int d) { return 4 >> d; }

// Voigt row of the displacement-gradient entry (c, d)
__host__ __device__ constexpr int voigt(int c, int d) {
  return c == d ? c : 6 - c - d;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
kapply3d_elem(const T* __restrict__ Cp, const T* __restrict__ u0,
              const T* __restrict__ u1, const T* __restrict__ u2,
              T* __restrict__ S, int NX, int NY, int NZ, Consts<T> k) {
  const long long nel = (long long)NX * NY * NZ;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nel) return;
  const int ez = (int)(e % NZ);
  const long long exy = e / NZ;
  const int ey = (int)(exy % NY);
  const int ex = (int)(exy / NY);
  const long long nnY = NY + 1, nnZ = NZ + 1;
  const T* u[3] = {u0, u1, u2};

  // corner values, then their Walsh-Hadamard transform in place
  T H[3][8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const long long nd =
        ((long long)(ex + (a >> 2)) * nnY + ey + ((a >> 1) & 1)) * nnZ +
        ez + (a & 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) H[c][a] = u[c][nd];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int bit = 1 << ax;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        if (a & bit) continue;
        const T lo = H[c][a], hi = H[c][a | bit];
        H[c][a] = hi + lo;
        H[c][a | bit] = hi - lo;
      }
    }
  }

  T C[36];
#pragma unroll
  for (int i = 0; i < 36; ++i) C[i] = Cp[i * nel + e];

  T Tq[3][8];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int q = 0; q < 8; ++q) Tq[c][q] = T(0);
  }

#pragma unroll
  for (int p = 0; p < 7; ++p) {
    // strain of mode p: eps[voigt(c, d)] += g_d H_c[p | bit(d)]
    T eps[6];
    bool act[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      eps[r] = T(0);
      act[r] = false;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (p & axis_bit(d)) continue;
        eps[voigt(c, d)] += k.g[d] * H[c][p | axis_bit(d)];
        act[voigt(c, d)] = true;
      }
    }
    // sigma = C eps on the mode's active rows
    T sig[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      sig[r] = T(0);
      if (!act[r]) continue;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        if (act[b]) sig[r] += C[6 * r + b] * eps[b];
      }
    }
    // B_p^T sigma, weighted: T_c[p | bit(d)] += w_p g_d sigma[voigt(c, d)]
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (p & axis_bit(d)) continue;
        Tq[c][p | axis_bit(d)] += k.wg[p][d] * sig[voigt(c, d)];
      }
    }
  }

  // corner forces f[a][c] = jacw sum_q T_c[q] chi_q(a): the transposed
  // transform, one butterfly per axis
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int bit = 1 << ax;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        if (a & bit) continue;
        const T lo = Tq[c][a], hi = Tq[c][a | bit];
        Tq[c][a] = lo - hi;
        Tq[c][a | bit] = lo + hi;
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) S[(3 * a + c) * nel + e] = k.jacw * Tq[c][a];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
kapply3d_node(const T* __restrict__ S, T* __restrict__ o0,
              T* __restrict__ o1, T* __restrict__ o2, int NX, int NY,
              int NZ) {
  const int nnY = NY + 1, nnZ = NZ + 1;
  const long long nn = (long long)(NX + 1) * nnY * nnZ;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nn) return;
  const int K = (int)(idx % nnZ);
  const long long ij = idx / nnZ;
  const int J = (int)(ij % nnY);
  const int I = (int)(ij / nnY);
  const long long nel = (long long)NX * NY * NZ;
  T acc[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int ex = I - (a >> 2), ey = J - ((a >> 1) & 1), ez = K - (a & 1);
    if (ex < 0 || ex >= NX || ey < 0 || ey >= NY || ez < 0 || ez >= NZ)
      continue;
    const long long e = ((long long)ex * NY + ey) * NZ + ez;
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += S[(3 * a + c) * nel + e];
  }
  o0[idx] = acc[0];
  o1[idx] = acc[1];
  o2[idx] = acc[2];
}

template <typename T>
int launch(const T* Cp, const T* u0, const T* u1, const T* u2, T* S, T* o0,
           T* o1, T* o2, int NX, int NY, int NZ, double lx, double ly,
           double lz, void* stream) {
  if (NX <= 0 || NY <= 0 || NZ <= 0 || !(lx > 0.) || !(ly > 0.) ||
      !(lz > 0.))
    return (int)cudaErrorInvalidValue;
  Consts<T> k;
  const double L[3] = {lx, ly, lz};
  for (int d = 0; d < 3; ++d) {
    const double g = 0.25 / L[d];
    k.g[d] = (T)g;
    for (int p = 0; p < 8; ++p) {
      const int np = (p & 1) + ((p >> 1) & 1) + ((p >> 2) & 1);
      double w = 8.;
      for (int i = 0; i < np; ++i) w /= 3.;
      k.wg[p][d] = (T)(w * g);
    }
  }
  k.jacw = (T)(lx * ly * lz / 8.);
  cudaStream_t s = (cudaStream_t)stream;
  const long long nel = (long long)NX * NY * NZ;
  const long long nn = (long long)(NX + 1) * (NY + 1) * (NZ + 1);
  kapply3d_elem<T><<<(unsigned)((nel + THREADS - 1) / THREADS), THREADS, 0,
                     s>>>(Cp, u0, u1, u2, S, NX, NY, NZ, k);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  kapply3d_node<T><<<(unsigned)((nn + THREADS - 1) / THREADS), THREADS, 0,
                     s>>>(S, o0, o1, o2, NX, NY, NZ);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pylabfea_kapply3d_f32(const float* Cp, const float* u0,
                                     const float* u1, const float* u2,
                                     float* scratch, float* o0, float* o1,
                                     float* o2, int NX, int NY, int NZ,
                                     double lx, double ly, double lz,
                                     void* stream) {
  return launch<float>(Cp, u0, u1, u2, scratch, o0, o1, o2, NX, NY, NZ, lx,
                       ly, lz, stream);
}

extern "C" int pylabfea_kapply3d_f64(const double* Cp, const double* u0,
                                     const double* u1, const double* u2,
                                     double* scratch, double* o0, double* o1,
                                     double* o2, int NX, int NY, int NZ,
                                     double lx, double ly, double lz,
                                     void* stream) {
  return launch<double>(Cp, u0, u1, u2, scratch, o0, o1, o2, NX, NY, NZ, lx,
                        ly, lz, stream);
}
