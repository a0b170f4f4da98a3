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
// compute-bound at many points.  At the REF_SOLVE shape (1024 points, 135
// SVs) one thread a point fills 4 blocks of 132 SMs, and each point's 135
// pairs run as one dependent chain: latency-bound.  The plain
// PyTorch version writes the (N, nsv) kernel and weight matrices to device
// memory; this kernel writes neither.
//
// Every output keeps the bits of the earlier one-thread-a-point form of
// this kernel, whatever the launch form: per pair the cross term as a
// chain of F full-precision FMAs (never TF32), the distance and the
// exponential of svc_eval.cuh's svc_term, then svc_grad_fold: w = dc e
// rounded, ws += w and gs_k = fma(w, sv_k, gs_k), each sum over the
// records in SV order; |x|^2 as a chain of FMAs and g_k = -2 gamma
// fma(ws, x_k, -gs_k), as the compiler had contracted them there (found by
// comparing bits with every contraction written out: the parent's |x|^2,
// |sv|^2 and ws x_k - gs_k were FMAs, its ws += dc e was not).  In float32
// the faithful path's branches follow the last bit of f (PERF.md section
// 6), so no sum is split or reordered.  The exponential stays expf / exp.
//
// Design: the support vectors are staged as svc_eval.cuh's packed records
// [sv_0 .. sv_{F-1}, |sv|^2, dc], a stage at a time (so the SV count is
// unlimited), two 128-bit shared loads a record of 6 features in float32.
// The launch form follows N:
//
//  * few points: a group of GT = 32, 16 or 8 threads serves one point (up
//    to 8, 16 or 64 points an SM: 1056, 2112, 8448 on 132 SMs).  In each
//    round thread b of the group computes w of record base + b; threads
//    0 .. 6 own the seven sums (ws, gs_0 .. gs_5), and each folds the
//    round's GT values of w, taken by __shfl_sync, in record order (with F
//    features threads 0 .. F own the F + 1 sums, so a group has at least
//    F + 1 threads: 16 or 32 with 15 features, none past 31): every
//    sum is the same chain of operations as one thread a point would run,
//    only the w values come from the group (no tree or butterfly, which
//    would change the bits).  Thread 0 writes f; ws is broadcast to the
//    owners of the gs_k, which write g_k.  The fold is replicated on all GT
//    threads, so more groups an SM only queue it, and the limits are where
//    the next form was faster (python -m pylabfea_tpu_torch.sweep_e): at
//    1024 x 135 a group of 32 takes 0.0041 ms a launch, one thread a point
//    0.0110 ms (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
//    Groups of fewer than eight threads, each owning several sums, lost
//    to one thread a point in an earlier form and were dropped.
//  * many points: a thread owns P points (P = 1, 2 or 4, as kernels A and
//    D choose; with 15 features at most MAX_P15, and 1 with F a launch
//    argument), their features and sums in registers; one record serves
//    all P points, and the record loop is unrolled four times.
//
// Any F from 1 to SVC_MAX_NFEAT (svc_eval.cuh's feature policies); the
// dtype is float or double.  The kernel allocates nothing and launches on
// the caller's stream.
#include <cuda_runtime.h>

#include "svc_eval.cuh"

namespace {

using pylabfea::for_features;
using pylabfea::fma_t;
using pylabfea::SVC_STAGE_VALUES;

constexpr int THREADS = 256;
// the most points a thread owns with 15 features
constexpr int MAX_P15 = 2;

// g_k = -2 gamma (ws x_k - gs_k), with ws x_k - gs_k one FMA.
template <typename T>
__device__ __forceinline__ T grad_component(T gamma, T ws, T xk, T gsk) {
  return pylabfea::mul_rn(pylabfea::mul_rn(T(-2), gamma),
                          fma_t(ws, xk, -gsk));
}

template <typename T, class FM>
__device__ __forceinline__ void load_point(const T* __restrict__ x,
                                           long long i, long long n,
                                           const FM& fm, T (&xr)[FM::CAP]) {
  const int nf = fm.n();
  for_features(fm, [&](int k) { xr[k] = i < n ? x[i * nf + k] : T(0); });
}

// One thread owns P points.
template <typename T, class FM, int P>
__global__ void __launch_bounds__(THREADS)
svc_fgrad_mm_points(const T* __restrict__ x, const T* __restrict__ sv,
                    const T* __restrict__ dc, long long n, int nsv, T gamma,
                    T rho, T* __restrict__ f, T* __restrict__ g, FM fm) {
  constexpr int F = FM::CAP;
  __shared__ __align__(16) T buf[SVC_STAGE_VALUES];
  const int nf = fm.n();
  const int stage = pylabfea::svc_stage_records(fm);
  const long long base = (long long)blockIdx.x * (THREADS * P) + threadIdx.x;
  T xr[P][F], x2[P], ws[P], gs[P][F];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    load_point(x, base + (long long)p * THREADS, n, fm, xr[p]);
    x2[p] = pylabfea::svc_norm2(xr[p], fm);
    ws[p] = T(0);
    for_features(fm, [&](int k) { gs[p][k] = T(0); });
  }
  for (int s0 = 0; s0 < nsv; s0 += stage) {
    const int m = min(stage, nsv - s0);
    __syncthreads();  // previous chunk fully consumed
    pylabfea::svc_stage(buf, fm, sv, dc, s0, m);
    __syncthreads();
    pylabfea::svc_grad_accumulate<T, FM, P>(buf, m, fm, xr, x2, gamma, ws,
                                            gs);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = base + (long long)p * THREADS;
    if (i >= n) continue;
    f[i] = ws[p] + rho;
    for_features(fm, [&](int k) {
      g[i * nf + k] = grad_component(gamma, ws[p], xr[p][k], gs[p][k]);
    });
  }
}

// A group of GT threads owns one point; thread c <= F of the group owns
// sum c (0: ws, k + 1: gs_k), the other threads fold into a sum nobody
// reads.  The launch keeps GT > F.
template <typename T, class FM, int GT>
__global__ void __launch_bounds__(THREADS)
svc_fgrad_mm_group(const T* __restrict__ x, const T* __restrict__ sv,
                   const T* __restrict__ dc, long long n, int nsv, T gamma,
                   T rho, T* __restrict__ f, T* __restrict__ g, FM fm) {
  static_assert(GT <= 32 && THREADS % GT == 0, "group");
  __shared__ __align__(16) T buf[SVC_STAGE_VALUES];
  const int nf = fm.n(), rs = pylabfea::svc_rstride(nf);
  const int stage = pylabfea::svc_stage_records(fm);
  const long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) / GT;
  const int c = threadIdx.x % GT;
  T xr[FM::CAP];
  load_point(x, i, n, fm, xr);
  const T x2 = pylabfea::svc_norm2(xr, fm);
  // ws folds w as fma(w, 1, ws), which is the rounded ws + w; gs_k folds
  // fma(w, sv_k, gs_k), sv_k from record slot k
  const bool is_ws = c == 0;
  const int slot = c > 0 && c <= nf ? c - 1 : 0;
  T acc = T(0);
  // every thread of the warp runs every shuffle (a group past N computes
  // on zero features and writes nothing), so the full mask holds
  for (int s0 = 0; s0 < nsv; s0 += stage) {
    const int m = min(stage, nsv - s0);
    __syncthreads();  // previous chunk fully consumed
    pylabfea::svc_stage(buf, fm, sv, dc, s0, m);
    __syncthreads();
    for (int base = 0; base < m; base += GT) {
      // a round past the last record computes on the last record and
      // keeps its sums (a select, not a branch)
      const int last = m - 1 - base;
      pylabfea::SvcRec<T, FM> r;
      pylabfea::svc_load(buf, base + min(c, last), fm, r);
      // w = dc exp(-gamma d2) of record base + c, rounded
      const T w = pylabfea::mul_rn(r.dc,
                                   pylabfea::svc_term(r, xr, x2, gamma, fm));
#pragma unroll
      for (int b = 0; b < GT; ++b) {
        const T wb = __shfl_sync(0xffffffffu, w, b, GT);
        const T v = is_ws ? T(1) : buf[(base + min(b, last)) * rs + slot];
        const T a = fma_t(wb, v, acc);
        acc = b <= last ? a : acc;
      }
    }
  }
  const T ws = __shfl_sync(0xffffffffu, acc, 0, GT);
  if (i >= n) return;
  if (is_ws) f[i] = ws + rho;
  for_features(fm, [&](int k) {
    if (c == k + 1) g[i * nf + k] = grad_component(gamma, ws, xr[k], acc);
  });
}

template <typename T, int P, class FM>
void launch_points(const T* x, const T* sv, const T* dc, long long n,
                   int nsv, T gamma, T rho, T* f, T* g, FM fm,
                   cudaStream_t stream) {
  const long long per_block = (long long)THREADS * P;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  svc_fgrad_mm_points<T, FM, P><<<blocks, THREADS, 0, stream>>>(
      x, sv, dc, n, nsv, gamma, rho, f, g, fm);
}

template <typename T, int GT, class FM>
void launch_group(const T* x, const T* sv, const T* dc, long long n, int nsv,
                  T gamma, T rho, T* f, T* g, FM fm, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n * GT + THREADS - 1) / THREADS);
  svc_fgrad_mm_group<T, FM, GT><<<blocks, THREADS, 0, stream>>>(
      x, sv, dc, n, nsv, gamma, rho, f, g, fm);
}

template <typename T>
int launch(const T* x, const T* sv, const T* dc, long long n, int nsv,
           int nfeat, T gamma, T rho, T* f, T* g, void* stream) {
  if (n <= 0 || nsv <= 0 || g == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // a group of 32, 16 or 8 threads a point up to 8, 16 or 64 points an SM
  // (the fastest form at 64 .. 135168 points in python -m
  // pylabfea_tpu_torch.sweep_e), a larger group where F + 1 sums need it
  // and one point a thread past 31 features; past 64 points an SM P
  // points a thread, P = 4 or 2 while the threads still number at least
  // 1024 an SM
  const long long sms = pylabfea::sm_count();
  const bool ok = pylabfea::with_features(nfeat, [&](auto fm) {
    using FM = decltype(fm);
    constexpr int PMAX = !FM::FIXED ? 1 : FM::CAP == 15 ? MAX_P15 : 4;
    const int chains = fm.n() + 1;
    int gt = n <= sms * 8 ? 32 : n <= sms * 16 ? 16 : n <= sms * 64 ? 8 : 0;
    if (gt > 0 && gt < chains) gt = chains <= 16 ? 16 : 32;
    if (gt > 0 && chains > 32) gt = 0;
    if (gt == 32)
      launch_group<T, 32>(x, sv, dc, n, nsv, gamma, rho, f, g, fm, s);
    else if (gt == 16)
      launch_group<T, 16>(x, sv, dc, n, nsv, gamma, rho, f, g, fm, s);
    else if (gt == 8)
      launch_group<T, 8>(x, sv, dc, n, nsv, gamma, rho, f, g, fm, s);
    else if (PMAX >= 4 && n >= sms * 4096)
      launch_points<T, PMAX >= 4 ? 4 : 1>(x, sv, dc, n, nsv, gamma, rho, f,
                                          g, fm, s);
    else if (PMAX >= 2 && n >= sms * 2048)
      launch_points<T, PMAX >= 2 ? 2 : 1>(x, sv, dc, n, nsv, gamma, rho, f,
                                          g, fm, s);
    else
      launch_points<T, 1>(x, sv, dc, n, nsv, gamma, rho, f, g, fm, s);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
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
