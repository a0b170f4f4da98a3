// RBF-SVC decision function alone, matmul-expansion distances.
//
//   f(x) = sum_s dc_s exp(-gamma max(|x|^2 + |sv_s|^2 - 2 x.sv_s, 0)) + rho
//
// Replaces the TPU kernel pylabfea_tpu/ops/pallas_kernels.py
// svc_decision_pallas (_kernel).  It serves the yield function yf: three
// launches per 2-D load step, one per faithful return map `response` and
// one per substep of its flow rule.  The yield-locus distance, which
// evaluates the same function at every marching and Brent abscissa, runs in
// kernel G (yf_root.cu) on the same body (svc_eval.cuh).
//
// What bounds it: per point-SV pair 2F + 7 float32 operations (F FMAs of
// the cross term, an add and an FMA of the distance, the gamma product, the
// exponential, an FMA into the sum) against F + 1 values moved per point:
// compute-bound, at every feature count.  At 2^20 points x 512 SVs the flop bound is 0.152 ms
// (H100 SXM data sheet at its 700 W limit: 67 TFLOP/s float32); the SFU
// ceiling beside it, one ex2 per pair at 16 per clock per SM (132 SMs at
// 1.98 GHz), is 0.129 ms, and expf adds its range reduction to the FP32
// pipe (see svc_eval.cuh for why float32 keeps expf).  The plain PyTorch version writes the (N, nsv) kernel matrix to
// device memory; this kernel writes none.
//
// Design: a thread owns P points (P = 4, 2 or 1, chosen at launch so that
// the grid still fills the card; 1 when F is a launch argument), their
// features and |x|^2 in registers; the block stages packed SV records in
// shared memory (svc_eval.cuh) and every record loaded serves P points.
// Every thread of a warp reads the same record: a broadcast.  Any F from 1
// to SVC_MAX_NFEAT (svc_eval.cuh's feature policies).  The kernel
// allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>

#include "svc_eval.cuh"

namespace {

using pylabfea::for_features;
using pylabfea::SVC_STAGE_VALUES;

constexpr int THREADS = 256;

template <typename T, class FM, int P>
__global__ void __launch_bounds__(THREADS)
svc_decision_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                    const T* __restrict__ dc, long long n, int nsv, T gamma,
                    T rho, T* __restrict__ f, FM fm) {
  __shared__ __align__(16) T buf[SVC_STAGE_VALUES];
  const int nf = fm.n();
  const int stage = pylabfea::svc_stage_records(fm);
  const long long base = (long long)blockIdx.x * (THREADS * P) + threadIdx.x;
  T xr[P][FM::CAP], x2[P], acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = base + (long long)p * THREADS;
    for_features(fm, [&](int k) { xr[p][k] = i < n ? x[i * nf + k] : T(0); });
    x2[p] = pylabfea::svc_norm2(xr[p], fm);
    acc[p] = T(0);
  }
  for (int s0 = 0; s0 < nsv; s0 += stage) {
    const int m = min(stage, nsv - s0);
    __syncthreads();  // previous chunk fully consumed
    pylabfea::svc_stage(buf, fm, sv, dc, s0, m);
    __syncthreads();
    pylabfea::svc_accumulate<T, FM, P>(buf, m, fm, xr, x2, gamma, acc);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = base + (long long)p * THREADS;
    if (i < n) f[i] = acc[p] + rho;
  }
}

template <typename T, int P, class FM>
void launch_p(const T* x, const T* sv, const T* dc, long long n, int nsv,
              T gamma, T rho, T* f, FM fm, cudaStream_t stream) {
  const long long per_block = (long long)THREADS * P;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  svc_decision_kernel<T, FM, P><<<blocks, THREADS, 0, stream>>>(
      x, sv, dc, n, nsv, gamma, rho, f, fm);
}

template <typename T>
int launch(const T* x, const T* sv, const T* dc, long long n, int nsv,
           int nfeat, T gamma, T rho, T* f, void* stream) {
  if (n <= 0 || nsv <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // P points a thread while the threads still number at least 1024 per SM
  const long long fill = (long long)pylabfea::sm_count() * 1024;
  const bool ok = pylabfea::with_features(nfeat, [&](auto fm) {
    using FM = decltype(fm);
    if constexpr (FM::FIXED) {
      if (n >= 4 * fill)
        launch_p<T, 4>(x, sv, dc, n, nsv, gamma, rho, f, fm, s);
      else if (n >= 2 * fill)
        launch_p<T, 2>(x, sv, dc, n, nsv, gamma, rho, f, fm, s);
      else
        launch_p<T, 1>(x, sv, dc, n, nsv, gamma, rho, f, fm, s);
    } else {
      launch_p<T, 1>(x, sv, dc, n, nsv, gamma, rho, f, fm, s);
    }
  });
  if (!ok) return (int)cudaErrorInvalidValue;
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
