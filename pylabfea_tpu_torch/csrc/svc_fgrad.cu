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
// What bounds it: per point-SV pair 5F + 4 flops (F subtracts and F
// multiply-adds of the distance, the gamma product, the exp, the dc
// product, the sum and F multiply-adds of g) against F loads per point:
// operations.  In instructions that is about 30 a pair, 8 of them expf's
// range reduction and ex2 (1.4e8 pairs at 2^20 points x 135 SVs).  The
// plain PyTorch version writes the (N, nsv) kernel matrix to device
// memory (566 MB in f32 at 2^20 x 135); this kernel writes none.
//
// Design: a thread owns P points (P = 4, 2 or 1, chosen at launch as in
// kernel D, so that the grid still fills the card), their features and
// sums in registers.  The block stages the support vectors as D's packed
// 8-value records (svc_eval.cuh; the |sv|^2 slot is not used here): one
// record is two 128-bit shared loads in float32, a broadcast to the warp,
// and serves all P points; the record loop is unrolled twice.  Distances
// are exact subtract-square, as in _fgrad_kernel (no matmul expansion, so
// no cancellation).  Each point's arithmetic is that of the earlier
// one-point-a-thread kernel, operation for operation in the same order
// (d_k = x_k - sv_k, d2 over k = 0..5, w = dc exp(-gamma d2), ws += w,
// gs_k += w sv_k over the records in SV order, g = -2 gamma (ws x - gs)),
// and the results keep its bits: in float32 the faithful path's branches
// follow the last bit of f (PERF.md section 6), and the fast phase of every
// faithful solve runs on this kernel.  The exponential stays expf / exp.
// F = 6 (the 6-D stress features); the dtype is float (the card's main
// path) or double.  The kernel allocates nothing and launches on the
// caller's stream.
#include <cuda_runtime.h>

#include "svc_eval.cuh"

namespace {

using pylabfea::SVC_NFEAT;
using pylabfea::SVC_STAGE;
using pylabfea::SvcRecord;

constexpr int THREADS = 256;

template <typename T, int P, bool WITH_GRAD>
__global__ void __launch_bounds__(THREADS)
svc_fgrad_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                 const T* __restrict__ dc, long long n, int nsv, T gamma,
                 T rho, T* __restrict__ f, T* __restrict__ g) {
  constexpr int F = SVC_NFEAT;
  __shared__ SvcRecord<T> rec[SVC_STAGE];
  const long long base = (long long)blockIdx.x * (THREADS * P) + threadIdx.x;
  T xr[P][F], ws[P], gs[P][F];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = base + (long long)p * THREADS;
#pragma unroll
    for (int k = 0; k < F; ++k) {
      xr[p][k] = i < n ? x[i * F + k] : T(0);
      gs[p][k] = T(0);
    }
    ws[p] = T(0);
  }

  for (int s0 = 0; s0 < nsv; s0 += SVC_STAGE) {
    const int m = min(SVC_STAGE, nsv - s0);
    __syncthreads();  // previous chunk fully consumed
    pylabfea::svc_stage(rec, sv, dc, s0, m);
    __syncthreads();
#pragma unroll 2
    for (int s = 0; s < m; ++s) {
      T r[8];
      pylabfea::svc_load(rec[s], r);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        T d2 = T(0);
#pragma unroll
        for (int k = 0; k < F; ++k) {
          const T d = xr[p][k] - r[k];
          d2 += d * d;
        }
        const T w = r[7] * pylabfea::exp_t(-gamma * d2);
        ws[p] += w;
        if (WITH_GRAD) {
#pragma unroll
          for (int k = 0; k < F; ++k) gs[p][k] += w * r[k];
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = base + (long long)p * THREADS;
    if (i >= n) continue;
    f[i] = ws[p] + rho;
    if (WITH_GRAD) {
#pragma unroll
      for (int k = 0; k < F; ++k)
        g[i * F + k] = T(-2) * gamma * (ws[p] * xr[p][k] - gs[p][k]);
    }
  }
}

template <typename T, int P>
void launch_p(const T* x, const T* sv, const T* dc, long long n, int nsv,
              T gamma, T rho, T* f, T* g, bool with_grad,
              cudaStream_t stream) {
  const long long per_block = (long long)THREADS * P;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  if (with_grad)
    svc_fgrad_kernel<T, P, true><<<blocks, THREADS, 0, stream>>>(
        x, sv, dc, n, nsv, gamma, rho, f, g);
  else
    svc_fgrad_kernel<T, P, false><<<blocks, THREADS, 0, stream>>>(
        x, sv, dc, n, nsv, gamma, rho, f, g);
}

template <typename T>
int launch(const T* x, const T* sv, const T* dc, long long n, int nsv,
           int nfeat, T gamma, T rho, T* f, T* g, int with_grad,
           void* stream) {
  if (nfeat != SVC_NFEAT || n <= 0 || nsv <= 0 || (with_grad && g == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool wg = with_grad != 0;
  // P points a thread while the threads still number at least 1024 per SM
  const long long fill = (long long)pylabfea::sm_count() * 1024;
  if (n >= 4 * fill)
    launch_p<T, 4>(x, sv, dc, n, nsv, gamma, rho, f, g, wg, s);
  else if (n >= 2 * fill)
    launch_p<T, 2>(x, sv, dc, n, nsv, gamma, rho, f, g, wg, s);
  else
    launch_p<T, 1>(x, sv, dc, n, nsv, gamma, rho, f, g, wg, s);
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
