// The RBF-SVC decision-function body with matmul-expansion distances,
//
//   f(x) = sum_s dc_s exp(-gamma max(|x|^2 + |sv_s|^2 - 2 x.sv_s, 0)) + rho,
//
// the formula of pylabfea_tpu/ops/pallas_kernels.py _kernel, shared by
// kernel D (svc_decision.cu: f at N points) and kernel G (yf_root.cu: f at
// every marching and Brent abscissa of a per-lane root find), and its
// terms, staging and records for kernel E (svc_fgrad_mm.cu: f and its
// gradient, with E's own fold of a pair, svc_grad_fold).
//
// Support vectors are staged in shared memory as packed 8-value records
// [sv_0 .. sv_5, |sv|^2, dc], SVC_STAGE of them at a time (16 KB in float32,
// 32 KB in float64; larger sets are staged in chunks, so the SV count is
// unlimited).  One record costs two 128-bit shared loads in float32 (four
// in float64) and serves every point a thread owns.  The staging block
// computes |sv|^2 itself, so no caller keeps a per-material cache.
//
// Every point's sum runs over the records in order, one FMA a record, so
// every kernel on this body gives the same bits for the same features.
// Per point-SV pair: the cross term as a chain of F full-precision FMAs
// (never TF32: the yield-locus root marching amplifies the decision
// function's error, see pylabfea_tpu/ops/constitutive.py _rbf_d2), one add
// and one FMA of the distance, the max(d2, 0) clamp, the exponent's
// product, the exponential and the FMA into the sum.  The exponential is
// expf / exp, as in the plain version.  A float32 exp2 on the prescaled
// argument (one SFU ex2 a pair, no range reduction) took D to 50 % of its
// bound, but it moved enough float32 Brent lanes of the faithful return
// map between root and fallback that 47 of chip_smoke.py phase 4's 64
// lanes agreed with the CPU, below its bound of 48 (NVIDIA H100 80GB HBM3,
// 700.00 W), so float32 keeps expf.
#pragma once
#include <cuda_runtime.h>

#include "fp_ops.cuh"

namespace pylabfea {

// features per point (6-D stress features)
constexpr int SVC_NFEAT = 6;
// support-vector records staged in shared memory at a time
constexpr int SVC_STAGE = 512;

template <typename T>
struct alignas(8 * sizeof(T)) SvcRecord {
  T v[8];  // sv_0 .. sv_5, |sv|^2, dc
};

// Streaming multiprocessors of the current device (cached per device; 132
// on an H100 SXM), for the launch shapes.
inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// Stage records [s0, s0 + m) of (sv, dc) into rec, with the whole block;
// |sv|^2 is a chain of FMAs in feature order.
template <typename T>
__device__ __forceinline__ void svc_stage(SvcRecord<T>* rec,
                                          const T* __restrict__ sv,
                                          const T* __restrict__ dc, int s0,
                                          int m) {
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const T* p = sv + (long long)(s0 + k) * SVC_NFEAT;
    SvcRecord<T> r;
    T q = T(0);
#pragma unroll
    for (int j = 0; j < SVC_NFEAT; ++j) {
      r.v[j] = p[j];
      q = fma_t(r.v[j], r.v[j], q);
    }
    r.v[6] = q;
    r.v[7] = dc[s0 + k];
    rec[k] = r;
  }
}

__device__ __forceinline__ void svc_load(const SvcRecord<float>& r,
                                         float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(r.v)[0];
  const float4 b = reinterpret_cast<const float4*>(r.v)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void svc_load(const SvcRecord<double>& r,
                                         double (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double2 a = reinterpret_cast<const double2*>(r.v)[k];
    v[2 * k] = a.x;
    v[2 * k + 1] = a.y;
  }
}

// |x|^2 of a point's features, a chain of FMAs in feature order (as
// |sv|^2 in svc_stage; the form nvcc had contracted q += x * x into).
template <typename T>
__device__ __forceinline__ T svc_norm2(const T (&x)[SVC_NFEAT]) {
  T q = T(0);
#pragma unroll
  for (int k = 0; k < SVC_NFEAT; ++k) q = fma_t(x[k], x[k], q);
  return q;
}

// exp(-gamma max(|x|^2 + |sv|^2 - 2 x.sv, 0)) of one point and one record.
template <typename T>
__device__ __forceinline__ T svc_term(const T (&r)[8],
                                      const T (&x)[SVC_NFEAT], T x2,
                                      T gamma) {
  T cross = T(0);
#pragma unroll
  for (int k = 0; k < SVC_NFEAT; ++k) cross = fma_t(x[k], r[k], cross);
  T d2 = x2 + r[6] - T(2) * cross;
  d2 = d2 > T(0) ? d2 : T(0);
  return exp_t(-gamma * d2);
}

// acc[p] += sum over the staged records [0, m), in order, of
// dc_s exp(-gamma d2(x_p, sv_s)), for the P points a thread owns.
template <typename T, int P>
__device__ __forceinline__ void svc_accumulate(const SvcRecord<T>* rec,
                                               int m,
                                               const T (&x)[P][SVC_NFEAT],
                                               const T (&x2)[P], T gamma,
                                               T (&acc)[P]) {
#pragma unroll 2
  for (int s = 0; s < m; ++s) {
    T r[8];
    svc_load(rec[s], r);
#pragma unroll
    for (int p = 0; p < P; ++p)
      acc[p] = fma_t(r[7], svc_term(r, x[p], x2[p], gamma), acc[p]);
  }
}

// Kernel E's fold of one point-SV pair into its value and gradient sums
// (svc_fgrad_mm.cu), given the pair's exponential e = svc_term(...):
// w = dc e, rounded; ws += w; gs_k = fma(w, sv_k, gs_k).  Each operation
// is written out, so that no contraction the compiler may choose changes
// the bits.
template <typename T>
__device__ __forceinline__ void svc_grad_fold(const T (&r)[8], T e, T& ws,
                                              T (&gs)[SVC_NFEAT]) {
  const T w = mul_rn(r[7], e);
  ws = add_rn(ws, w);
#pragma unroll
  for (int k = 0; k < SVC_NFEAT; ++k) gs[k] = fma_t(w, r[k], gs[k]);
}

// ws[p] and gs[p] += the folds of the staged records [0, m), in order, for
// the P points a thread owns (kernel E's sums; svc_accumulate's loop,
// unrolled four times: python -m pylabfea_tpu_torch.sweep_e).
template <typename T, int P>
__device__ __forceinline__ void svc_grad_accumulate(
    const SvcRecord<T>* rec, int m, const T (&x)[P][SVC_NFEAT],
    const T (&x2)[P], T gamma, T (&ws)[P], T (&gs)[P][SVC_NFEAT]) {
#pragma unroll 4
  for (int s = 0; s < m; ++s) {
    T r[8];
    svc_load(rec[s], r);
#pragma unroll
    for (int p = 0; p < P; ++p)
      svc_grad_fold(r, svc_term(r, x[p], x2[p], gamma), ws[p], gs[p]);
  }
}

}  // namespace pylabfea
