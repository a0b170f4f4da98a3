// The RBF-SVC decision-function body with matmul-expansion distances,
//
//   f(x) = sum_s dc_s exp(-gamma max(|x|^2 + |sv_s|^2 - 2 x.sv_s, 0)) + rho,
//
// the formula of pylabfea_tpu/ops/pallas_kernels.py _kernel, shared by
// kernel D (svc_decision.cu: f at N points) and kernel G (yf_root.cu: f at
// every marching and Brent abscissa of a per-lane root find), and its
// terms, staging and records for kernels A (svc_fgrad.cu) and E
// (svc_fgrad_mm.cu: f and its gradient, with E's own fold of a pair,
// svc_grad_fold).
//
// Feature counts.  A point has F features, 1 <= F <= SVC_MAX_NFEAT: 2 for
// the cylindrical layout (seq/scale - 1, theta/pi), 6 for 6-D stress, 15
// for stress + work hardening, 6 + tdim or 15 + tdim with a texture
// descriptor.  A kernel is a template on the feature policy FM: FixedF<F>
// for F = 2, 6 and 15 (every loop over the features unrolled, no
// predicate, a record in registers), RegF for any other F up to 32 (F a
// launch argument; loops unrolled over 32 in groups of 4 that stop after
// F, so a point's features stay in registers, and a record read from
// shared memory as the loops need it) and WideF up to SVC_MAX_NFEAT
// (loops of F trips, a point's arrays in local memory).  A loop over the
// features runs k = 0 .. F - 1 in order in every form (for_features), so
// the form changes no bit.
//
// Support vectors are staged in shared memory as packed records
// [sv_0 .. sv_{F-1}, |sv|^2, dc], svc_rstride(F) values each (F + 2
// rounded up to a multiple of 4: 8 for F = 6, 4 for F = 2, 20 for F =
// 15), SVC_STAGE_VALUES values at a time (16 KB in float32, 32 KB in
// float64; 512 records of 6 features, 204 of 15, fewer as F grows; larger
// sets are staged in chunks, so the SV count is unlimited).  With F fixed
// one record costs svc_rstride(F) / 4 128-bit shared loads in float32
// (twice as many in float64) and serves every point a thread owns.  The
// staging block computes |sv|^2 itself, so no caller keeps a per-material
// cache.
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

// the most features a point may have (svc_kernels.MAX_NFEAT)
constexpr int SVC_MAX_NFEAT = 256;
// the values of support-vector records staged in shared memory at a time
// (512 records of 6 features)
constexpr int SVC_STAGE_VALUES = 4096;

// The values of one record of F features: F + 2 rounded up to a multiple
// of 4, so that every record starts on a 16-byte boundary.
__host__ __device__ constexpr int svc_rstride(int nf) {
  return (nf + 2 + 3) / 4 * 4;
}

// Feature policies: CAP is the capacity of a point's feature arrays.
// FIXED: F is a compile-time constant; UNROLLED: the loops over the
// features are unrolled over CAP (so the arrays stay in registers).
template <int F>
struct FixedF {
  static constexpr int CAP = F;
  static constexpr bool UNROLLED = true;
  static constexpr bool FIXED = true;
  __host__ __device__ constexpr int n() const { return F; }
};

template <int CAP_, bool UNROLLED_>
struct RuntimeF {
  static constexpr int CAP = CAP_;
  static constexpr bool UNROLLED = UNROLLED_;
  static constexpr bool FIXED = false;
  int nf;
  __host__ __device__ int n() const { return nf; }
};
using RegF = RuntimeF<32, true>;
using WideF = RuntimeF<SVC_MAX_NFEAT, false>;

// body(k) for k = 0 .. F - 1, in order: fully unrolled with F fixed; with
// RegF unrolled over CAP in groups of 4 that stop after the group holding
// F - 1 (a branch every 4 features, uniform over the warp, and k < F as a
// predicate inside the last group); with WideF a loop of F trips.
template <class FM, class Body>
__device__ __forceinline__ void for_features(const FM& fm, Body&& body) {
  if constexpr (FM::FIXED) {
#pragma unroll
    for (int k = 0; k < FM::CAP; ++k) body(k);
  } else if constexpr (FM::UNROLLED) {
    const int nf = fm.n();
#pragma unroll
    for (int k0 = 0; k0 < FM::CAP; k0 += 4) {
      if (k0 >= nf) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + j < nf) body(k0 + j);
    }
  } else {
    for (int k = 0; k < fm.n(); ++k) body(k);
  }
}

// Call body(fm) with the policy for nfeat features: FixedF for 2, 6 and
// 15, else RegF or WideF.  Returns false for a count out of range.
template <class Body>
inline bool with_features(int nfeat, Body&& body) {
  switch (nfeat) {
    case 2: body(FixedF<2>{}); return true;
    case 6: body(FixedF<6>{}); return true;
    case 15: body(FixedF<15>{}); return true;
    default:
      if (nfeat < 1 || nfeat > SVC_MAX_NFEAT) return false;
      if (nfeat <= RegF::CAP) body(RegF{nfeat}); else body(WideF{nfeat});
      return true;
  }
}

// One support-vector record: with F fixed in registers (loaded with
// 128-bit loads), else read from its staged copy in shared memory as the
// loops need it (a broadcast load; it keeps CAP registers free).
template <typename T, class FM, bool = FM::FIXED>
struct SvcRec {
  T v[FM::CAP];
  T sq;  // |sv|^2
  T dc;
  __device__ __forceinline__ T sv(int k) const { return v[k]; }
};

template <typename T, class FM>
struct SvcRec<T, FM, false> {
  const T* p;
  T sq;
  T dc;
  __device__ __forceinline__ T sv(int k) const { return p[k]; }
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

// Records a stage holds.
template <class FM>
__device__ __forceinline__ int svc_stage_records(const FM& fm) {
  return SVC_STAGE_VALUES / svc_rstride(fm.n());
}

// Stage records [s0, s0 + m) of (sv, dc) into buf, with the whole block;
// |sv|^2 is a chain of FMAs in feature order.
template <typename T, class FM>
__device__ __forceinline__ void svc_stage(T* buf, const FM& fm,
                                          const T* __restrict__ sv,
                                          const T* __restrict__ dc, int s0,
                                          int m) {
  const int nf = fm.n(), rs = svc_rstride(nf);
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const T* p = sv + (long long)(s0 + k) * nf;
    T* r = buf + k * rs;
    T q = T(0);
    for_features(fm, [&](int j) {
      const T v = p[j];
      r[j] = v;
      q = fma_t(v, v, q);
    });
    r[nf] = q;
    r[nf + 1] = dc[s0 + k];
  }
}

// Load staged record s: with F fixed as 128-bit loads of the whole record.
template <typename T, class FM>
__device__ __forceinline__ void svc_load(const T* buf, int s, const FM& fm,
                                         SvcRec<T, FM>& r) {
  if constexpr (FM::FIXED) {
    constexpr int F = FM::CAP, RS = svc_rstride(F);
    T v[RS];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < RS / 4; ++k) {
        const float4 a = reinterpret_cast<const float4*>(buf + s * RS)[k];
        v[4 * k] = a.x; v[4 * k + 1] = a.y; v[4 * k + 2] = a.z;
        v[4 * k + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < RS / 2; ++k) {
        const double2 a = reinterpret_cast<const double2*>(buf + s * RS)[k];
        v[2 * k] = a.x; v[2 * k + 1] = a.y;
      }
    }
#pragma unroll
    for (int k = 0; k < F; ++k) r.v[k] = v[k];
    r.sq = v[F];
    r.dc = v[F + 1];
  } else {
    const int nf = fm.n();
    r.p = buf + s * svc_rstride(nf);
    r.sq = r.p[nf];
    r.dc = r.p[nf + 1];
  }
}

// |x|^2 of a point's features, a chain of FMAs in feature order (as
// |sv|^2 in svc_stage; the form nvcc had contracted q += x * x into).
template <typename T, class FM>
__device__ __forceinline__ T svc_norm2(const T (&x)[FM::CAP],
                                       const FM& fm) {
  T q = T(0);
  for_features(fm, [&](int k) { q = fma_t(x[k], x[k], q); });
  return q;
}

// exp(-gamma max(|x|^2 + |sv|^2 - 2 x.sv, 0)) of one point and one record.
template <typename T, class FM>
__device__ __forceinline__ T svc_term(const SvcRec<T, FM>& r,
                                      const T (&x)[FM::CAP], T x2, T gamma,
                                      const FM& fm) {
  T cross = T(0);
  for_features(fm, [&](int k) { cross = fma_t(x[k], r.sv(k), cross); });
  T d2 = x2 + r.sq - T(2) * cross;
  d2 = d2 > T(0) ? d2 : T(0);
  return exp_t(-gamma * d2);
}

// acc[p] += sum over the staged records [0, m), in order, of
// dc_s exp(-gamma d2(x_p, sv_s)), for the P points a thread owns.
template <typename T, class FM, int P>
__device__ __forceinline__ void svc_accumulate(const T* buf, int m,
                                               const FM& fm,
                                               const T (&x)[P][FM::CAP],
                                               const T (&x2)[P], T gamma,
                                               T (&acc)[P]) {
#pragma unroll 2
  for (int s = 0; s < m; ++s) {
    SvcRec<T, FM> r;
    svc_load(buf, s, fm, r);
#pragma unroll
    for (int p = 0; p < P; ++p)
      acc[p] = fma_t(r.dc, svc_term(r, x[p], x2[p], gamma, fm), acc[p]);
  }
}

// Kernel E's fold of one point-SV pair into its value and gradient sums
// (svc_fgrad_mm.cu), given the pair's exponential e = svc_term(...):
// w = dc e, rounded; ws += w; gs_k = fma(w, sv_k, gs_k).  Each operation
// is written out, so that no contraction the compiler may choose changes
// the bits.
template <typename T, class FM>
__device__ __forceinline__ void svc_grad_fold(const SvcRec<T, FM>& r, T e,
                                              T& ws, T (&gs)[FM::CAP],
                                              const FM& fm) {
  const T w = mul_rn(r.dc, e);
  ws = add_rn(ws, w);
  for_features(fm, [&](int k) { gs[k] = fma_t(w, r.sv(k), gs[k]); });
}

// ws[p] and gs[p] += the folds of the staged records [0, m), in order, for
// the P points a thread owns (kernel E's sums; svc_accumulate's loop,
// unrolled four times: python -m pylabfea_tpu_torch.sweep_e).
template <typename T, class FM, int P>
__device__ __forceinline__ void svc_grad_accumulate(
    const T* buf, int m, const FM& fm, const T (&x)[P][FM::CAP],
    const T (&x2)[P], T gamma, T (&ws)[P], T (&gs)[P][FM::CAP]) {
#pragma unroll 4
  for (int s = 0; s < m; ++s) {
    SvcRec<T, FM> r;
    svc_load(buf, s, fm, r);
#pragma unroll
    for (int p = 0; p < P; ++p)
      svc_grad_fold(r, svc_term(r, x[p], x2[p], gamma, fm), ws[p], gs[p],
                    fm);
  }
}

}  // namespace pylabfea
