// Fused RBF-SVC decision function and feature-space gradient.
//
//   f(x) = sum_s dc_s exp(-gamma |x - sv_s|^2) + rho
//   g(x) = -2 gamma (ws x - sum_s w_s sv_s)
//   with w_s = dc_s exp(-gamma |x - sv_s|^2) and ws = sum_s w_s
//
// Replaces the TPU kernel pylabfea_tpu/ops/pallas_kernels.py
// svc_f_grad_pallas (_fgrad_kernel), including its with_grad=False form.
// The return map calls it once per Newton trip over every Gauss point.
//
// What bounds it: each point-SV pair costs about 3F+4 flops and one exp
// against F loads per point, so it is compute-bound (at 2^20 points x 135
// SVs about 1.4e8 exps per call).  The plain PyTorch version writes the
// (N, nsv) kernel matrix to device memory (566 MB in f32 at 2^20 x 135);
// this kernel writes none.
//
// Design: one thread per evaluation point, its F features in registers.
// The block stages the support vectors in chunks of SV_CHUNK in shared
// memory (every thread then reads the same address: a broadcast) and each
// thread accumulates ws and gs_f = sum_s w_s sv_{s,f} in registers.
// Distances are exact subtract-square, as in _fgrad_kernel (no matmul
// expansion, so no cancellation).  F is a template parameter (6: the 6-D
// stress features); the dtype is float (the card's main path) or double.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>

namespace {

constexpr int SV_CHUNK = 256;
constexpr int THREADS = 256;

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

template <typename T, int F, bool WITH_GRAD>
__global__ void __launch_bounds__(THREADS)
svc_fgrad_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                 const T* __restrict__ dc, long long n, int nsv, T gamma,
                 T rho, T* __restrict__ f, T* __restrict__ g) {
  __shared__ T s_sv[SV_CHUNK * F];
  __shared__ T s_dc[SV_CHUNK];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  T xr[F];
#pragma unroll
  for (int k = 0; k < F; ++k) xr[k] = live ? x[i * F + k] : T(0);
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
    for (int s = 0; s < m; ++s) {
      T d2 = T(0);
#pragma unroll
      for (int k = 0; k < F; ++k) {
        const T d = xr[k] - s_sv[s * F + k];
        d2 += d * d;
      }
      const T w = s_dc[s] * exp_t(-gamma * d2);
      ws += w;
      if (WITH_GRAD) {
#pragma unroll
        for (int k = 0; k < F; ++k) gs[k] += w * s_sv[s * F + k];
      }
    }
  }
  if (!live) return;
  f[i] = ws + rho;
  if (WITH_GRAD) {
#pragma unroll
    for (int k = 0; k < F; ++k)
      g[i * F + k] = T(-2) * gamma * (ws * xr[k] - gs[k]);
  }
}

template <typename T>
int launch(const T* x, const T* sv, const T* dc, long long n, int nsv,
           int nfeat, T gamma, T rho, T* f, T* g, int with_grad,
           void* stream) {
  if (nfeat != 6 || n <= 0 || nsv <= 0 || (with_grad && g == nullptr))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (with_grad)
    svc_fgrad_kernel<T, 6, true><<<blocks, THREADS, 0, st>>>(
        x, sv, dc, n, nsv, gamma, rho, f, g);
  else
    svc_fgrad_kernel<T, 6, false><<<blocks, THREADS, 0, st>>>(
        x, sv, dc, n, nsv, gamma, rho, f, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pylabfea_svc_fgrad_f32(const float* x, const float* sv,
                                      const float* dc, long long n, int nsv,
                                      int nfeat, float gamma, float rho,
                                      float* f, float* g, int with_grad,
                                      void* stream) {
  return launch<float>(x, sv, dc, n, nsv, nfeat, gamma, rho, f, g, with_grad,
                       stream);
}

extern "C" int pylabfea_svc_fgrad_f64(const double* x, const double* sv,
                                      const double* dc, long long n, int nsv,
                                      int nfeat, double gamma, double rho,
                                      double* f, double* g, int with_grad,
                                      void* stream) {
  return launch<double>(x, sv, dc, n, nsv, nfeat, gamma, rho, f, g,
                        with_grad, stream);
}
