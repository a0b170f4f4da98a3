// Matrix-free stiffness apply K u on a structured NX x NY bilinear-quad grid
// (no boundary rows: the caller masks fixed dofs around the call).
//
// Replaces the TPU kernel pylabfea_tpu/ops/stencil_pallas.py
// k_apply_stencil (_kapply_kernel).  Every CG apply, Jacobi sweep and
// V-cycle residual of the multigrid solve goes through it.
//
// Layout (the JAX package's planes layout): Kp (8, 8, NX, NY) element
// stiffness planes, element dof j = 2*b + c for corner b of
// ((0,0), (0,1), (1,0), (1,1)) and component c; u0, u1, out0, out1 are
// (NX+1, NY+1) nodal planes, row-major.
//
// What bounds it: memory.  Each apply streams the 64 stiffness planes once
// (256 MB in f32 at 1024^2) against 2 flops per loaded value.
//
// Design: a node-centric gather, because CUDA blocks run in no order (the
// TPU kernel carried element-row contributions across its sequential grid
// steps, which has no counterpart here).  One thread per node (I, J), with
// neighbouring threads on neighbouring J so the Kp reads coalesce.  For each
// of its <= 4 adjacent elements e = (I - dx, J - dy), the node sits at corner
// b = (dx, dy) of e, and the thread accumulates rows 2b and 2b+1 of Ke(e)
// times e's 8 gathered dofs.  Every Ke entry is read by exactly one thread,
// so there are no atomics and the summation order is fixed (corner order,
// then dof order, as in the plain gather-contract-scatter version).  Ragged
// edges are masked in the kernel; nothing is allocated; the launch goes on
// the caller's stream.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
kapply2d_kernel(const T* __restrict__ Kp, const T* __restrict__ u0,
                const T* __restrict__ u1, T* __restrict__ o0,
                T* __restrict__ o1, int NX, int NY) {
  const int nnY = NY + 1;
  const long long nn = (long long)(NX + 1) * nnY;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nn) return;
  const int I = (int)(idx / nnY);
  const int J = (int)(idx - (long long)I * nnY);
  const long long plane = (long long)NX * NY;
  T acc0 = T(0), acc1 = T(0);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ex = I - (a >> 1);
    const int ey = J - (a & 1);
    if (ex < 0 || ex >= NX || ey < 0 || ey >= NY) continue;
    const long long e = (long long)ex * NY + ey;
    T ue[8];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long nd = (long long)(ex + (b >> 1)) * nnY + ey + (b & 1);
      ue[2 * b] = u0[nd];
      ue[2 * b + 1] = u1[nd];
    }
    const T* k0 = Kp + (long long)(2 * a) * 8 * plane + e;
    const T* k1 = k0 + 8 * plane;
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s0 += k0[j * plane] * ue[j];
      s1 += k1[j * plane] * ue[j];
    }
    acc0 += s0;
    acc1 += s1;
  }
  o0[idx] = acc0;
  o1[idx] = acc1;
}

template <typename T>
int launch(const T* Kp, const T* u0, const T* u1, T* o0, T* o1, int NX,
           int NY, void* stream) {
  if (NX <= 0 || NY <= 0) return (int)cudaErrorInvalidValue;
  const long long nn = (long long)(NX + 1) * (NY + 1);
  const unsigned blocks = (unsigned)((nn + THREADS - 1) / THREADS);
  kapply2d_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      Kp, u0, u1, o0, o1, NX, NY);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pylabfea_kapply2d_f32(const float* Kp, const float* u0,
                                     const float* u1, float* o0, float* o1,
                                     int NX, int NY, void* stream) {
  return launch<float>(Kp, u0, u1, o0, o1, NX, NY, stream);
}

extern "C" int pylabfea_kapply2d_f64(const double* Kp, const double* u0,
                                     const double* u1, double* o0,
                                     double* o1, int NX, int NY,
                                     void* stream) {
  return launch<double>(Kp, u0, u1, o0, o1, NX, NY, stream);
}
