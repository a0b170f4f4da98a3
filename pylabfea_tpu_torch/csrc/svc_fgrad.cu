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
// records (svc_eval.cuh; the |sv|^2 slot is not used here): with 6
// features one record is two 128-bit shared loads in float32, a broadcast
// to the warp, and serves all P points; the record loop is unrolled
// twice.  Distances
// are exact subtract-square, as in _fgrad_kernel (no matmul expansion, so
// no cancellation).  Each point's arithmetic is that of the earlier
// one-point-a-thread kernel, operation for operation in the same order
// (d_k = x_k - sv_k, d2 over k = 0..5, w = dc exp(-gamma d2), ws += w,
// gs_k += w sv_k over the records in SV order, g = -2 gamma (ws x - gs)),
// and the results keep its bits: in float32 the faithful path's branches
// follow the last bit of f (PERF.md section 6), and the fast phase of every
// faithful solve runs on this kernel.  The exponential stays expf / exp.
// Any F from 1 to SVC_MAX_NFEAT (svc_eval.cuh's feature policies).  A
// thread keeps 2 P F values of its points (features and gradient sums):
// with 15 features P is at most MAX_P15 so that they stay in registers,
// and with F a launch argument P is 1.  The dtype is float (the card's
// main path) or double.  The kernel allocates nothing and launches on the
// caller's stream.
#include <cuda_runtime.h>

#include "svc_eval.cuh"

namespace {

using pylabfea::for_features;
using pylabfea::SVC_STAGE_VALUES;

constexpr int THREADS = 256;
// the most points a thread owns with 15 features
constexpr int MAX_P15 = 2;

template <typename T, class FM, int P, bool WITH_GRAD>
__global__ void __launch_bounds__(THREADS)
svc_fgrad_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                 const T* __restrict__ dc, long long n, int nsv, T gamma,
                 T rho, T* __restrict__ f, T* __restrict__ g, FM fm) {
  constexpr int F = FM::CAP;
  __shared__ __align__(16) T buf[SVC_STAGE_VALUES];
  const int nf = fm.n();
  const int stage = pylabfea::svc_stage_records(fm);
  const long long base = (long long)blockIdx.x * (THREADS * P) + threadIdx.x;
  T xr[P][F], ws[P], gs[P][F];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = base + (long long)p * THREADS;
    for_features(fm, [&](int k) {
      xr[p][k] = i < n ? x[i * nf + k] : T(0);
      gs[p][k] = T(0);
    });
    ws[p] = T(0);
  }

  for (int s0 = 0; s0 < nsv; s0 += stage) {
    const int m = min(stage, nsv - s0);
    __syncthreads();  // previous chunk fully consumed
    pylabfea::svc_stage(buf, fm, sv, dc, s0, m);
    __syncthreads();
#pragma unroll 2
    for (int s = 0; s < m; ++s) {
      pylabfea::SvcRec<T, FM> r;
      pylabfea::svc_load(buf, s, fm, r);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        T d2 = T(0);
        for_features(fm, [&](int k) {
          const T d = xr[p][k] - r.sv(k);
          d2 += d * d;
        });
        const T w = r.dc * pylabfea::exp_t(-gamma * d2);
        ws[p] += w;
        if (WITH_GRAD)
          for_features(fm, [&](int k) { gs[p][k] += w * r.sv(k); });
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = base + (long long)p * THREADS;
    if (i >= n) continue;
    f[i] = ws[p] + rho;
    if (WITH_GRAD)
      for_features(fm, [&](int k) {
        g[i * nf + k] = T(-2) * gamma * (ws[p] * xr[p][k] - gs[p][k]);
      });
  }
}

template <typename T, int P, class FM>
void launch_p(const T* x, const T* sv, const T* dc, long long n, int nsv,
              T gamma, T rho, T* f, T* g, bool with_grad, FM fm,
              cudaStream_t stream) {
  const long long per_block = (long long)THREADS * P;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  if (with_grad)
    svc_fgrad_kernel<T, FM, P, true><<<blocks, THREADS, 0, stream>>>(
        x, sv, dc, n, nsv, gamma, rho, f, g, fm);
  else
    svc_fgrad_kernel<T, FM, P, false><<<blocks, THREADS, 0, stream>>>(
        x, sv, dc, n, nsv, gamma, rho, f, g, fm);
}

template <typename T>
int launch(const T* x, const T* sv, const T* dc, long long n, int nsv,
           int nfeat, T gamma, T rho, T* f, T* g, int with_grad,
           void* stream) {
  if (n <= 0 || nsv <= 0 || (with_grad && g == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool wg = with_grad != 0;
  // P points a thread while the threads still number at least 1024 per SM
  const long long fill = (long long)pylabfea::sm_count() * 1024;
  const bool ok = pylabfea::with_features(nfeat, [&](auto fm) {
    using FM = decltype(fm);
    constexpr int PMAX = !FM::FIXED ? 1 : FM::CAP == 15 ? MAX_P15 : 4;
    if constexpr (PMAX >= 4) {
      if (n >= 4 * fill) {
        launch_p<T, 4>(x, sv, dc, n, nsv, gamma, rho, f, g, wg, fm, s);
        return;
      }
    }
    if constexpr (PMAX >= 2) {
      if (n >= 2 * fill) {
        launch_p<T, 2>(x, sv, dc, n, nsv, gamma, rho, f, g, wg, fm, s);
        return;
      }
    }
    launch_p<T, 1>(x, sv, dc, n, nsv, gamma, rho, f, g, wg, fm, s);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
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
