// The yield-locus root finder of the SVC distance, one launch per call.
//
// For every lane i (a stress direction su_i, a start abscissa and a top),
// the root x of f(x) = svc_decision(features(x su_i)) with the rules of the
// port's constitutive.ml_yf_dist (the JAX ml_yf_dist):
//
//   1. march down from start: x *= 0.98 while f >= 0 and x > 0.01, at most
//      maxmarch steps; then march up from start: x *= 1.02 while f < 0 and
//      x < top, at most maxmarch steps;
//   2. Brent on [x_down, x_up] (rootfind.brent: the endpoint and zero-hit
//      set-up, at most maxiter iterations, xtol, rtol).
//
// Replaces the TPU's svc_decision_pallas (pylabfea_tpu/ops/pallas_kernels.py)
// inside the marching while_loops and brent_jax (pylabfea_tpu/ops/rootfind.py)
// of the JAX ml_yf_dist, which run on the TPU as compiled loops with no
// host in between.  As eager launches (kernel D per evaluation, kernel F per
// Brent iteration, a host read of the flags every 8 iterations) one call
// was hundreds of launches; here it is one, and nothing is read on the host.
//
// What bounds it: every evaluation costs nsv x (2F + 7) operations (the body
// of svc_eval.cuh); a lane runs 1 + m_down + m_up + b evaluations (b Brent
// iterations, up to 100 in float32 where roots of 128-256 MPa lie below
// xtol's float32 spacing).  The optional per-lane output nevals reports the
// count, from which the caller computes the bound.
//
// Design: each lane is a small state machine (march down, march up, Brent,
// done) in registers that asks for one evaluation at a time; the Brent
// iteration is brent_body.cuh's, one IEEE operation at a time.  The
// features are formed as the plain path's PyTorch operations form them on
// the card, one __*_rn operation each, and f is summed over the records in
// order, as kernel D sums it: every f, and so every marching step and
// Brent iterate, is bitwise that of the eager composition of D and F that
// this kernel replaces.  That matters in float32, where Brent meets its
// stopping test at roots of 128-256 MPa only where f is exactly 0, so the
// last bit of f decides per lane between the root and the 0.85 sflow
// fallback: the REF_SOLVE 32^2 float32 solve moved by 0.1-0.3 of its
// answer under a change of summation order or of the feature division
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).  A group of GT threads
// (GT = 1 .. 32, chosen at launch so that small lane counts still occupy
// the card) serves one lane and folds its terms in order
// (group_accumulate), so every thread of a group holds the same bits of f
// and takes the same branches.  With
// nsv <= SVC_STAGE the records are staged once and a finished lane stops
// evaluating, so a warp runs only as long as its slowest lane; larger SV
// sets are staged in chunks, every thread of the block taking part in each
// chunk's staging until no lane of the block is left.
#include <cuda_runtime.h>

#include "brent_body.cuh"
#include "svc_eval.cuh"

namespace {

using pylabfea::add_rn;
using pylabfea::BrentState;
using pylabfea::div_rn;
using pylabfea::mul_rn;
using pylabfea::sub_rn;
using pylabfea::SVC_NFEAT;
using pylabfea::SVC_STAGE;
using pylabfea::SvcRecord;

constexpr int THREADS = 256;

enum Stage : int { START, DOWN, UP, BRENT, DONE };

template <typename T>
struct Lane {
  int stage, it, nevals;
  T x;  // the abscissa of the next evaluation
  T start, top, fstart, xa, fa;
  BrentState<T> b;
};

// Take f at lane.x and move the lane on to its next abscissa (or to DONE).
template <typename T>
__device__ __forceinline__ void advance(Lane<T>& L, T f, int maxmarch,
                                        int maxiter, T xtol, T rtol) {
  ++L.nevals;
  if (L.stage == START) {  // f(start): both marches begin there
    L.fstart = f;
    L.stage = DOWN;
  }
  if (L.stage == DOWN) {
    if (L.it < maxmarch && f >= T(0) && L.x > T(0.01)) {
      L.x = mul_rn(L.x, T(0.98));
      ++L.it;
      return;
    }
    L.xa = L.x;
    L.fa = f;
    L.x = L.start;
    f = L.fstart;
    L.it = 0;
    L.stage = UP;
  }
  if (L.stage == UP) {
    if (L.it < maxmarch && f < T(0) && L.x < L.top) {
      L.x = mul_rn(L.x, T(1.02));
      ++L.it;
      return;
    }
    // Brent's set-up on [xa, x] (rootfind.brent): no sign change, or an
    // endpoint that is a zero, ends the lane at once
    const bool hit_pre = L.fa == T(0);
    const bool hit_cur = !hit_pre && f == T(0);
    L.b.done = mul_rn(L.fa, f) > T(0) || hit_pre || hit_cur;
    L.b.ok = hit_pre || hit_cur;
    L.b.root = hit_pre ? L.xa : L.x;
    L.b.xpre = L.xa;
    L.b.fpre = L.fa;
    L.b.xcur = L.x;
    L.b.fcur = f;
    L.b.xblk = L.b.fblk = L.b.spre = L.b.scur = T(0);
    L.it = 0;
    L.stage = BRENT;
  } else {  // BRENT: f is the value at xcur
    L.b.fcur = f;
  }
  if (!L.b.done && L.it < maxiter) {
    pylabfea::brent_iteration(L.b, xtol, rtol);
    ++L.it;
  }
  // the last iteration's abscissa needs no evaluation: the result is root
  // or xcur
  if (L.b.done || L.it == maxiter)
    L.stage = DONE;
  else
    L.x = L.b.xcur;
}

// The features of x su: x su, deviatoric if dev_only, over scale, each
// operation as the plain path's PyTorch operations compute it on the card
// (jtensors.sig_dev, constitutive._features), where a division by a host
// scalar is a product with the scalar's reciprocal: so the kernel's
// features, and with the in-order sum its f, are bitwise those of kernel D
// on the features PyTorch forms.
template <typename T>
__device__ __forceinline__ void features(T x, const T (&su)[SVC_NFEAT],
                                         T inv_scale, bool dev_only,
                                         T (&out)[SVC_NFEAT]) {
  T s[SVC_NFEAT];
#pragma unroll
  for (int k = 0; k < SVC_NFEAT; ++k) s[k] = mul_rn(x, su[k]);
  if (dev_only) {
    const T p = mul_rn(add_rn(add_rn(s[0], s[1]), s[2]), div_rn(T(1), T(3)));
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = sub_rn(s[k], p);
  }
#pragma unroll
  for (int k = 0; k < SVC_NFEAT; ++k) out[k] = mul_rn(s[k], inv_scale);
}

// acc + the sum over the staged records [0, m), in order, of dc_s
// exp(-gamma d2(x, sv_s)), by a group of GT threads: each thread computes
// the term of record base + g, and every thread of the group folds the GT
// terms of a round into its sum in record order, each term broadcast from
// the thread that computed it.  Every thread of the group thus runs kernel
// D's one in-order FMA chain and holds the same bits (a tree reduction
// would give other bits than D, a butterfly different bits in different
// threads, whose Brent iterates would then part).
template <int GT, typename T>
__device__ __forceinline__ T group_accumulate(const SvcRecord<T>* rec, int m,
                                              const T (&x)[SVC_NFEAT], T x2,
                                              T gamma, T acc) {
  if constexpr (GT == 1) {  // one thread a lane: kernel D's own loop
    T xs[1][SVC_NFEAT], x2s[1] = {x2}, accs[1] = {acc};
#pragma unroll
    for (int k = 0; k < SVC_NFEAT; ++k) xs[0][k] = x[k];
    pylabfea::svc_accumulate<T, 1>(rec, m, xs, x2s, gamma, accs);
    return accs[0];
  } else {
    constexpr int B = GT < 8 ? GT : 8;  // terms gathered before folding
    const int g = threadIdx.x % GT;
    const unsigned first = (threadIdx.x & 31u) & ~(unsigned)(GT - 1);
    const unsigned mask =
        GT == 32 ? 0xffffffffu : (((1u << GT) - 1u) << first);
    for (int base = 0; base < m; base += GT) {
      T e = T(0);
      if (base + g < m) {
        T r[8];
        pylabfea::svc_load(rec[base + g], r);
        e = pylabfea::svc_term(r, x, x2, gamma);
      }
      const int cnt = min(GT, m - base);
#pragma unroll
      for (int k0 = 0; k0 < GT; k0 += B) {
        T ek[B], dk[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          ek[b] = __shfl_sync(mask, e, k0 + b, GT);
          dk[b] = k0 + b < cnt ? rec[base + k0 + b].v[7] : T(0);
        }
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (k0 + b < cnt) acc = pylabfea::fma_t(dk[b], ek[b], acc);
      }
    }
    return acc;
  }
}

template <typename T, int GT>
__global__ void __launch_bounds__(THREADS)
yf_root_kernel(const T* __restrict__ su_, const T* __restrict__ start,
               const T* __restrict__ top, const T* __restrict__ sv,
               const T* __restrict__ dc, long long n, int nsv, T gamma, T rho,
               T scale, bool dev_only, int maxmarch, int maxiter, T xtol,
               T rtol, T* __restrict__ xs, bool* __restrict__ ok,
               int* __restrict__ nevals) {
  __shared__ SvcRecord<T> rec[SVC_STAGE];
  const T inv_scale = div_rn(T(1), scale);
  const long long lane = ((long long)blockIdx.x * THREADS + threadIdx.x) / GT;
  const int g = threadIdx.x % GT;
  const bool live = lane < n;
  T su[SVC_NFEAT];
  Lane<T> L;
  L.stage = START;
  L.it = L.nevals = 0;
  if (live) {
#pragma unroll
    for (int k = 0; k < SVC_NFEAT; ++k) su[k] = su_[lane * SVC_NFEAT + k];
    L.start = L.x = start[lane];
    L.top = top[lane];
  }
  if (nsv <= SVC_STAGE) {
    pylabfea::svc_stage(rec, sv, dc, 0, nsv);
    __syncthreads();
    if (live) {
      while (L.stage != DONE) {
        T x[SVC_NFEAT];
        features(L.x, su, inv_scale, dev_only, x);
        const T acc = group_accumulate<GT>(rec, nsv, x, pylabfea::svc_norm2(x),
                                           gamma, T(0));
        advance(L, acc + rho, maxmarch, maxiter, xtol, rtol);
      }
    }
  } else {
    bool active = live;
    while (__syncthreads_or(active)) {
      T x[SVC_NFEAT], x2 = T(0), acc = T(0);
      if (active) {
        features(L.x, su, inv_scale, dev_only, x);
        x2 = pylabfea::svc_norm2(x);
      }
      for (int s0 = 0; s0 < nsv; s0 += SVC_STAGE) {
        const int m = min(SVC_STAGE, nsv - s0);
        __syncthreads();  // previous chunk fully consumed
        pylabfea::svc_stage(rec, sv, dc, s0, m);
        __syncthreads();
        if (active) acc = group_accumulate<GT>(rec, m, x, x2, gamma, acc);
      }
      if (active) {
        advance(L, acc + rho, maxmarch, maxiter, xtol, rtol);
        active = L.stage != DONE;
      }
    }
  }
  if (live && g == 0) {
    xs[lane] = L.b.ok ? L.b.root : L.b.xcur;
    ok[lane] = L.b.ok;
    if (nevals != nullptr) nevals[lane] = L.nevals;
  }
}

template <typename T, int GT>
void launch_g(const T* su, const T* start, const T* top, const T* sv,
              const T* dc, long long n, int nsv, T gamma, T rho, T scale,
              bool dev_only, int maxmarch, int maxiter, T xtol, T rtol, T* xs,
              bool* ok, int* nevals, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n * GT + THREADS - 1) / THREADS);
  yf_root_kernel<T, GT><<<blocks, THREADS, 0, stream>>>(
      su, start, top, sv, dc, n, nsv, gamma, rho, scale, dev_only, maxmarch,
      maxiter, xtol, rtol, xs, ok, nevals);
}

template <typename T>
int launch(const T* su, const T* start, const T* top, const T* sv,
           const T* dc, long long n, int nsv, int nfeat, T gamma, T rho,
           T scale, int dev_only, int maxmarch, int maxiter, T xtol, T rtol,
           T* xs, bool* ok, int* nevals, void* stream) {
  if (nfeat != SVC_NFEAT || n <= 0 || nsv <= 0 || maxmarch < 0 ||
      maxiter < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // the group size: the largest power of two up to 32 with n * GT threads
  // still at most 1024 per SM
  const long long fill = (long long)pylabfea::sm_count() * 1024;
  int gt = 1;
  while (gt < 32 && n * gt * 2 <= fill) gt *= 2;
#define PYLABFEA_YF_ROOT(G)                                                  \
  launch_g<T, G>(su, start, top, sv, dc, n, nsv, gamma, rho, scale,          \
                 dev_only != 0, maxmarch, maxiter, xtol, rtol, xs, ok, nevals, \
                 s)
  switch (gt) {
    case 1: PYLABFEA_YF_ROOT(1); break;
    case 2: PYLABFEA_YF_ROOT(2); break;
    case 4: PYLABFEA_YF_ROOT(4); break;
    case 8: PYLABFEA_YF_ROOT(8); break;
    case 16: PYLABFEA_YF_ROOT(16); break;
    default: PYLABFEA_YF_ROOT(32); break;
  }
#undef PYLABFEA_YF_ROOT
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pylabfea_yf_root_f32(const float* su, const float* start,
                                    const float* top, const float* sv,
                                    const float* dc, long long n, int nsv,
                                    int nfeat, float gamma, float rho,
                                    float scale_seq, int dev_only,
                                    int maxmarch, int maxiter, float xtol,
                                    float rtol, float* xs, bool* ok,
                                    int* nevals, void* stream) {
  return launch<float>(su, start, top, sv, dc, n, nsv, nfeat, gamma, rho,
                       scale_seq, dev_only, maxmarch, maxiter, xtol, rtol, xs,
                       ok, nevals, stream);
}

extern "C" int pylabfea_yf_root_f64(const double* su, const double* start,
                                    const double* top, const double* sv,
                                    const double* dc, long long n, int nsv,
                                    int nfeat, double gamma, double rho,
                                    double scale_seq, int dev_only,
                                    int maxmarch, int maxiter, double xtol,
                                    double rtol, double* xs, bool* ok,
                                    int* nevals, void* stream) {
  return launch<double>(su, start, top, sv, dc, n, nsv, nfeat, gamma, rho,
                        scale_seq, dev_only, maxmarch, maxiter, xtol, rtol,
                        xs, ok, nevals, stream);
}
