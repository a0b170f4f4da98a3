// RBF-SVC decision function alone, matmul-expansion distances.
//
//   f(x) = sum_s dc_s exp(-gamma max(|x|^2 + |sv_s|^2 - 2 x.sv_s, 0)) + rho
//
// Replaces the TPU kernel pylabfea_tpu/ops/pallas_kernels.py
// svc_decision_pallas (_kernel).  The reference-faithful return map calls it
// for the yield function and for every bracket-marching and Brent
// evaluation of the yield-locus distance (hundreds of calls per response).
//
// What bounds it: each point-SV pair costs F multiply-adds of the cross
// term, three flops of the distance, the gamma product, one exp and one
// multiply-add of the sum, against F + 1 loads per point: compute-bound.
// The plain PyTorch version writes the (N, nsv) kernel matrix to device
// memory; this kernel writes none.
//
// Design: one thread per evaluation point, its F features and |x|^2 in
// registers.  The block stages the support vectors and dual coefficients
// in chunks of SV_CHUNK in shared memory (every thread then reads the same
// address: a broadcast) and computes |sv_s|^2 of the staged chunk itself
// (nsv F multiply-adds per block, well under 1 % of its work), so no
// caller keeps a per-material cache and no extra launch is needed.  The
// cross term is a chain of full-precision FMAs (float or double; never
// TF32: the yield-locus root marching amplifies the decision function's
// error, see pylabfea_tpu/ops/constitutive.py _rbf_d2).  F is a template
// parameter (6: the 6-D stress features).  The kernel allocates nothing and
// launches on the caller's stream.
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
svc_decision_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                    const T* __restrict__ dc, long long n, int nsv, T gamma,
                    T rho, T* __restrict__ f) {
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
  T acc = T(0);
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
      acc = fma_t(s_dc[s], exp_t(-gamma * d2), acc);
    }
  }
  if (live) f[i] = acc + rho;
}

template <typename T>
int launch(const T* x, const T* sv, const T* dc, long long n, int nsv,
           int nfeat, T gamma, T rho, T* f, void* stream) {
  if (nfeat != 6 || n <= 0 || nsv <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  svc_decision_kernel<T, 6><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, sv, dc, n, nsv, gamma, rho, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pylabfea_svc_decision_f32(const float* x, const float* sv,
                                         const float* dc, long long n,
                                         int nsv, int nfeat, float gamma,
                                         float rho, float* f, void* stream) {
  return launch<float>(x, sv, dc, n, nsv, nfeat, gamma, rho, f, stream);
}

extern "C" int pylabfea_svc_decision_f64(const double* x, const double* sv,
                                         const double* dc, long long n,
                                         int nsv, int nfeat, double gamma,
                                         double rho, double* f,
                                         void* stream) {
  return launch<double>(x, sv, dc, n, nsv, nfeat, gamma, rho, f, stream);
}
