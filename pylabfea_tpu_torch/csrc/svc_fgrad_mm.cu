// RBF-SVC decision function and feature-space gradient, matmul-expansion
// distances.
//
//   d2_s = max(|x|^2 + |sv_s|^2 - 2 x.sv_s, 0),  w_s = dc_s exp(-gamma d2_s)
//   f(x) = sum_s w_s + rho
//   g(x) = -2 gamma (ws x - sum_s w_s sv_s),  ws = sum_s w_s
//
// Replaces the TPU kernel pylabfea_tpu/ops/pallas_kernels.py
// svc_f_grad_pallas_mxu (_fgrad_kernel_mxu): the same arithmetic as the JAX
// package's constitutive.svc_decision_and_gradient, which the
// reference-faithful return map's flow rule (_flow_tan) evaluates once per
// substep.  Kernel A (svc_fgrad.cu) stays the fast path's kernel; it uses
// exact subtract-square distances.
//
// What bounds it: per point-SV pair F multiply-adds of the cross term, the
// distance, the gamma product, one exp, the dc product, the sum and F
// multiply-adds of w@sv, against 2F + 1 values moved per point:
// compute-bound.  The plain PyTorch version writes the (N, nsv) kernel and
// weight matrices to device memory; this kernel writes neither.
//
// Design: one thread per evaluation point, its F features and |x|^2 in
// registers, ws and gs_f = sum_s w_s sv_{s,f} accumulated in registers.
// The block stages the support vectors and dual coefficients in chunks of
// SV_CHUNK in shared memory and computes the chunk's |sv_s|^2 once per
// block.  The two products of the TPU kernel stay separate steps here, the
// cross term X SV^T of a chunk and the weighted sum W SV, each a chain of
// full-precision FMAs (never TF32), so a later version can move both to
// tensor-core tiles in an FP32-exact split form without changing the
// elementwise middle.  F is a template parameter (6: the 6-D stress
// features); the dtype is float or double.  The kernel allocates nothing
// and launches on the caller's stream.
#include <cuda_runtime.h>

namespace {

constexpr int SV_CHUNK = 256;
constexpr int THREADS = 256;

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int F>
__global__ void __launch_bounds__(THREADS)
svc_fgrad_mm_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                    const T* __restrict__ dc, long long n, int nsv, T gamma,
                    T rho, T* __restrict__ f, T* __restrict__ g) {
  __shared__ T s_sv[SV_CHUNK * F];
  __shared__ T s_s2[SV_CHUNK];
  __shared__ T s_dc[SV_CHUNK];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  T xr[F];
  T x2 = T(0);
#pragma unroll
  for (int k = 0; k < F; ++k) {
    xr[k] = live ? x[i * F + k] : T(0);
    x2 += xr[k] * xr[k];
  }
  T ws = T(0);
  T gs[F];
#pragma unroll
  for (int k = 0; k < F; ++k) gs[k] = T(0);

  for (int s0 = 0; s0 < nsv; s0 += SV_CHUNK) {
    const int m = min(SV_CHUNK, nsv - s0);
    __syncthreads();  // previous chunk fully consumed
    for (int k = threadIdx.x; k < m * F; k += blockDim.x)
      s_sv[k] = sv[(long long)s0 * F + k];
    for (int k = threadIdx.x; k < m; k += blockDim.x) s_dc[k] = dc[s0 + k];
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      T q = T(0);
#pragma unroll
      for (int j = 0; j < F; ++j) q += s_sv[k * F + j] * s_sv[k * F + j];
      s_s2[k] = q;
    }
    __syncthreads();
    for (int s = 0; s < m; ++s) {
      T cross = T(0);
#pragma unroll
      for (int k = 0; k < F; ++k)
        cross = fma_t(xr[k], s_sv[s * F + k], cross);
      T d2 = x2 + s_s2[s] - T(2) * cross;
      d2 = d2 > T(0) ? d2 : T(0);
      const T w = s_dc[s] * exp_t(-gamma * d2);
      ws += w;
#pragma unroll
      for (int k = 0; k < F; ++k) gs[k] = fma_t(w, s_sv[s * F + k], gs[k]);
    }
  }
  if (!live) return;
  f[i] = ws + rho;
#pragma unroll
  for (int k = 0; k < F; ++k)
    g[i * F + k] = T(-2) * gamma * (ws * xr[k] - gs[k]);
}

template <typename T>
int launch(const T* x, const T* sv, const T* dc, long long n, int nsv,
           int nfeat, T gamma, T rho, T* f, T* g, void* stream) {
  if (nfeat != 6 || n <= 0 || nsv <= 0 || g == nullptr)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  svc_fgrad_mm_kernel<T, 6><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, sv, dc, n, nsv, gamma, rho, f, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pylabfea_svc_fgrad_mm_f32(const float* x, const float* sv,
                                         const float* dc, long long n,
                                         int nsv, int nfeat, float gamma,
                                         float rho, float* f, float* g,
                                         void* stream) {
  return launch<float>(x, sv, dc, n, nsv, nfeat, gamma, rho, f, g, stream);
}

extern "C" int pylabfea_svc_fgrad_mm_f64(const double* x, const double* sv,
                                         const double* dc, long long n,
                                         int nsv, int nfeat, double gamma,
                                         double rho, double* f, double* g,
                                         void* stream) {
  return launch<double>(x, sv, dc, n, nsv, nfeat, gamma, rho, f, g, stream);
}
