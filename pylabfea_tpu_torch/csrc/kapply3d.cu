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
// jacw times the transposed transform of T_c.  That is 138 tangent
// multiply-adds per element instead of the 8-point loop's 8 x 36.  Every
// node sums its <= 8 elements' corner forces in corner order 0..7, the
// order of the plain version's scatter.
//
// What bounds it: memory.  The 36 tangent volumes are read once (302 MB
// in f32 at 128^3) for about 612 flops per element (4 per byte read), far
// below the card's ~20 f32 flops per byte of memory bandwidth.
//
// Design: one launch, no scratch in device memory, no atomics.  A block
// owns a tile of TY x TZ = 7 x 31 nodes in y-z and a chunk of x_chunk node
// layers along x, and marches through the chunk one x layer at a time
// (the loop takes the place of the TPU kernel's sequential grid axis,
// whose +x corner carry it keeps in shared memory).  Per layer ex, each of
// its 256 threads owns one element of the EY x EZ = 8 x 32 slab that
// touches the tile (ez fastest): it takes the element's 36 tangents from
// shared memory and its 24 corner values from registers, computes its 24
// corner forces and writes corners 0..3 (dx = 0) to B and 4..7 to
// A[ex & 1]; after a barrier every node of layer ex sums corners 0..3
// from B and 4..7 from A[(ex - 1) & 1] (the previous layer's), in corner
// order, while the next layer's corner values load into registers.  While
// a layer computes, cp.async copies the next layer's tangents (4 bytes a
// copy: the rows start anywhere) into shared memory.  The slab's edge
// elements are computed by both neighbouring tiles (8 x 32 elements for
// 7 x 31 nodes), the layer before a chunk by both neighbouring chunks.
// Each force is rounded (jacw * T) before the node sum, so the result has
// the bits of the two-pass kernel that wrote the forces to a (24, NX, NY,
// NZ) scratch and summed them in a second launch, on every grid and
// tiling, and every launch gives the same bits.  In float32 the launch
// bounds keep a thread at <= 128 registers, so two blocks (16 warps) share
// an SM; the tangent loads are what the time waits on.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// element slab of a block's x layer (one element a thread, ez fastest),
// and the node tile it completes
constexpr int EY = 8, EZ = 32, NE = EY * EZ;
constexpr int TY = EY - 1, TZ = EZ - 1;
// shared values: Cs (36 x NE), B (12 x NE), A[2] (2 x 12 x NE)
constexpr int SMEM_VALUES = 72 * NE;
static_assert(NE == THREADS && THREADS % EZ == 0, "slab layout");

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

// a product rounded on its own, never contracted into a later sum
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// asynchronous copy of one value to shared memory (cp.async through L1),
// the commit of this thread's copies as a group, and the wait for all
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
}
__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The 8 corner values of element (ex, ey, ez) (node nd0 = its corner 0),
// three components each, from device memory.
template <typename T>
__device__ __forceinline__ void corner_values(T (&H)[3][8],
                                              const T* __restrict__ u0,
                                              const T* __restrict__ u1,
                                              const T* __restrict__ u2,
                                              long long nd0, long long sx,
                                              int sy) {
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const long long nd = nd0 + (a >> 2) * sx + ((a >> 1) & 1) * sy + (a & 1);
    H[0][a] = u0[nd];
    H[1][a] = u1[nd];
    H[2][a] = u2[nd];
  }
}

// Start copying the 36 tangents of this thread's element e into its
// column of Cs.
template <typename T>
__device__ __forceinline__ void stage_tangents(T* Cs,
                                               const T* __restrict__ Cp,
                                               long long e, long long nel) {
  const T* src = Cp + e;
#pragma unroll
  for (int i = 0; i < 36; ++i, src += nel)
    copy_async(Cs + i * NE + threadIdx.x, src);
}

// The 24 corner forces of one element from its tangents C and corner
// values H (transformed in place), rounded, to B (corners 0..3) and Ahi
// (corners 4..7) at slab index threadIdx.x.
template <typename T>
__device__ __forceinline__ void element_forces(const T (&C)[36],
                                               T (&H)[3][8], T* B, T* Ahi,
                                               Consts<T> k) {
  // Walsh-Hadamard transform of the corner values
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
    for (int a = 0; a < 4; ++a) {
      B[(3 * a + c) * NE + threadIdx.x] = mul_rn(k.jacw, Tq[c][a]);
      Ahi[(3 * a + c) * NE + threadIdx.x] = mul_rn(k.jacw, Tq[c][a + 4]);
    }
  }
}


// float32: two blocks an SM (2 x 72 KB of shared memory, <= 128
// registers); float64 takes 144 KB, one block
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 2 : 1)
kapply3d_kernel(const T* __restrict__ Cp, const T* __restrict__ u0,
                const T* __restrict__ u1, const T* __restrict__ u2,
                T* __restrict__ o0, T* __restrict__ o1, T* __restrict__ o2,
                int NX, int NY, int NZ, int x_chunk, Consts<T> k) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Cs = reinterpret_cast<T*>(smem);
  T* B = Cs + 36 * NE;
  T* A = B + 12 * NE;          // A[s] = A + s * 12 * NE
  const int K0 = blockIdx.x * TZ, J0 = blockIdx.y * TY;
  const int X0 = blockIdx.z * x_chunk;
  const int X1 = min(X0 + x_chunk, NX + 1);   // node layers [X0, X1)
  const int XE = min(X1, NX);                 // element layers < XE
  const long long nel = (long long)NX * NY * NZ;
  const long long lay = (long long)NY * NZ;   // elements a layer
  const int ly = threadIdx.x / EZ, lz = threadIdx.x % EZ;
  // this thread's element (ex, ey, ez) of every layer, and its node
  // (I, J, K) of every node layer I
  const int ey = J0 - 1 + ly, ez = K0 - 1 + lz;
  const bool elem = ey >= 0 && ey < NY && ez >= 0 && ez < NZ;
  const long long e0 = (long long)ey * NZ + ez;   // + ex * lay
  const long long sx = (long long)(NY + 1) * (NZ + 1);   // nodes a layer
  const int sy = NZ + 1;
  const long long n0 = (long long)ey * sy + ez;   // + ex * sx
  const int J = J0 + ly, K = K0 + lz;
  const bool node = ly < TY && lz < TZ && J <= NY && K <= NZ;

  // prologue: the tangents and corner values of layer X0 - 1
  T H[3][8];
  if (X0 >= 1 && elem) {
    stage_tangents(Cs, Cp, (X0 - 1) * lay + e0, nel);
    corner_values(H, u0, u1, u2, (X0 - 1) * sx + n0, sx, sy);
  }
  commit_async();
  wait_async();
  __syncthreads();
  for (int ex = X0 - 1; ex < X1; ++ex) {
    // element layer ex (the layer before the chunk feeds its corners 4..7
    // to the chunk's first node layer): its tangents into registers
    const bool live = elem && ex >= 0 && ex < NX;
    T C[36];
    if (live) {
#pragma unroll
      for (int i = 0; i < 36; ++i) C[i] = Cs[i * NE + threadIdx.x];
    }
    __syncthreads();
    // start copying layer ex + 1's tangents while this layer computes
    if (ex + 1 < XE && elem)
      stage_tangents(Cs, Cp, (ex + 1) * lay + e0, nel);
    commit_async();
    if (live) element_forces(C, H, B, A + (ex & 1) * 12 * NE, k);
    __syncthreads();
    // the next layer's corner values, in flight during the node sums
    if (ex + 1 >= 0 && ex + 1 < XE && elem)
      corner_values(H, u0, u1, u2, (ex + 1) * sx + n0, sx, sy);
    // node layer I = ex: corners 0..3 from element layer ex (B), 4..7 from
    // layer ex - 1 (A[(ex - 1) & 1]), in corner order, absent ones skipped
    const int I = ex;
    if (I >= X0 && node) {
      const T* Alo = A + ((ex - 1) & 1) * 12 * NE;
      T acc[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int dx = a >> 2, dy = (a >> 1) & 1, dz = a & 1;
        if (I - dx < 0 || I - dx >= NX || J - dy < 0 || J - dy >= NY ||
            K - dz < 0 || K - dz >= NZ)
          continue;
        const T* src = dx ? Alo : B;
        const int le = (ly + 1 - dy) * EZ + lz + 1 - dz;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[c] += src[(3 * (a & 3) + c) * NE + le];
      }
      const long long nd = I * sx + (long long)J * sy + K;
      o0[nd] = acc[0];
      o1[nd] = acc[1];
      o2[nd] = acc[2];
    }
    wait_async();
    __syncthreads();
  }
}

template <typename T>
int launch(const T* Cp, const T* u0, const T* u1, const T* u2, T* o0, T* o1,
           T* o2, int NX, int NY, int NZ, double lx, double ly, double lz,
           int x_chunk, void* stream) {
  if (NX <= 0 || NY <= 0 || NZ <= 0 || !(lx > 0.) || !(ly > 0.) ||
      !(lz > 0.) || x_chunk < 0)
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

  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tz = (NZ + TZ) / TZ, ty = (NY + TY) / TY;   // ceil((N+1)/T)
  if (tz > 2147483647LL || ty > 65535)
    return (int)cudaErrorInvalidValue;
  if (x_chunk == 0) {
    // at least 8 chunks (each recomputes one element layer) and two
    // blocks per SM
    long long chunks = (2LL * sms + tz * ty - 1) / (tz * ty);
    chunks = chunks < 8 ? 8 : chunks;
    chunks = chunks > NX + 1 ? NX + 1 : chunks;
    x_chunk = (int)((NX + chunks) / chunks);                  // ceil
  }
  const long long nxc = (NX + x_chunk) / x_chunk;             // ceil
  if (nxc > 65535) return (int)cudaErrorInvalidValue;

  const size_t smem = sizeof(T) * SMEM_VALUES;
  int err = (int)cudaFuncSetAttribute(
      kapply3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != 0) return err;
  const dim3 grid((unsigned)tz, (unsigned)ty, (unsigned)nxc);
  kapply3d_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      Cp, u0, u1, u2, o0, o1, o2, NX, NY, NZ, x_chunk, k);
  return (int)cudaGetLastError();
}

}  // namespace

// x_chunk: node layers along x per block, 0 for the launch's own choice
extern "C" int pylabfea_kapply3d_f32(const float* Cp, const float* u0,
                                     const float* u1, const float* u2,
                                     float* o0, float* o1, float* o2, int NX,
                                     int NY, int NZ, double lx, double ly,
                                     double lz, int x_chunk, void* stream) {
  return launch<float>(Cp, u0, u1, u2, o0, o1, o2, NX, NY, NZ, lx, ly, lz,
                       x_chunk, stream);
}

extern "C" int pylabfea_kapply3d_f64(const double* Cp, const double* u0,
                                     const double* u1, const double* u2,
                                     double* o0, double* o1, double* o2,
                                     int NX, int NY, int NZ, double lx,
                                     double ly, double lz, int x_chunk,
                                     void* stream) {
  return launch<double>(Cp, u0, u1, u2, o0, o1, o2, NX, NY, NZ, lx, ly, lz,
                        x_chunk, stream);
}
