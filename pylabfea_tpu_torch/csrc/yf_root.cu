// The yield-locus root finder of the SVC distance, one launch per call.
//
// For every lane i (a stress direction su_i, a start abscissa and a top),
// the root x of f(x) = svc_decision(features(x su_i)) with the rules of the
// port's constitutive.ml_yf_dist (the JAX ml_yf_dist), for every SVC
// feature layout (svc_kernels.FeatureMap):
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
// Features: the leading ones come from the stress s = x su_i, the others
// are per-lane constants the wrapper forms once (they stay fixed while the
// stress scales: the plastic-strain block and zero columns of work
// hardening, the standardized texture, theta/pi of the cylindrical
// layout).  The leading ones are the six stress components (deviatoric if
// dev_only) over scale_seq, or with a texture scaler (s_k - mean_k) /
// scale_k; for the cylindrical layout one, seq_J2(s) / scale_seq - 1 (s
// Voigt or principal).  The cylindrical kernel forms seq_J2 of x su_i in
// registers and keeps theta(su_i) as the lane's constant, where the JAX
// package re-runs its eigensolver on x su_i at every abscissa: the two
// agree in exact arithmetic (seq_J2 is 1-homogeneous, theta 0-homogeneous)
// and part by rounding, which chip_smoke.py holds to phase 4's rule.
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
using pylabfea::for_features;
using pylabfea::mul_rn;
using pylabfea::sub_rn;
using pylabfea::SVC_STAGE_VALUES;

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

// A lane's feature map: its direction su (nsu = 6 Voigt, or 3 principal
// values for the cylindrical layout), the texture scaler of the stress
// block (tex) and the per-lane constant features ext[k], k >= lead.
template <typename T, class FM>
struct RootMap {
  T su[6], mean[6], fsc[6], ext[FM::CAP];
  T inv_scale;
  int nsu;
  bool dev_only, cyl, tex;
};

// seq_J2 of the stress rows s (jtensors.seq_j2_voigt / seq_j2_princ), one
// IEEE operation at a time in their order.
template <typename T>
__device__ __forceinline__ T seq_j2(const T (&s)[6], bool voigt) {
  const T d12 = sub_rn(s[0], s[1]), d23 = sub_rn(s[1], s[2]),
          d31 = sub_rn(s[2], s[0]);
  T v = mul_rn(T(0.5), add_rn(add_rn(mul_rn(d12, d12), mul_rn(d23, d23)),
                              mul_rn(d31, d31)));
  if (voigt) {
    const T sh = add_rn(add_rn(mul_rn(s[3], s[3]), mul_rn(s[4], s[4])),
                        mul_rn(s[5], s[5]));
    v = add_rn(v, mul_rn(T(3), sh));
  }
  return v > T(0) ? pylabfea::sqrt_rn(v) : T(0);
}

// The features of x su, each operation as the plain path's PyTorch
// operations compute it on the card (svc_kernels.FeatureMap), where a
// division by a host scalar is a product with the scalar's reciprocal and
// one by a tensor a division: so the kernel's features, and with the
// in-order sum its f, are bitwise those of kernel D on the features
// PyTorch forms.
template <typename T, class FM>
__device__ __forceinline__ void features(T x, const RootMap<T, FM>& map,
                                         const FM& fm, T (&out)[FM::CAP]) {
  const int nf = fm.n();
  T s[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    s[k] = k < map.nsu ? mul_rn(x, map.su[k]) : T(0);
  int lead = 6;
  if (map.cyl) {
    lead = 1;
    out[0] = sub_rn(mul_rn(seq_j2(s, map.nsu == 6), map.inv_scale), T(1));
  } else {
    if (map.dev_only) {
      const T p = mul_rn(add_rn(add_rn(s[0], s[1]), s[2]),
                         div_rn(T(1), T(3)));
#pragma unroll
      for (int k = 0; k < 3; ++k) s[k] = sub_rn(s[k], p);
    }
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (k < FM::CAP && k < nf)
        out[k] = map.tex ? div_rn(sub_rn(s[k], map.mean[k]), map.fsc[k])
                         : mul_rn(s[k], map.inv_scale);
  }
  for_features(fm, [&](int k) {
    if (k >= lead) out[k] = map.ext[k];
  });
}

// acc + the sum over the staged records [0, m), in order, of dc_s
// exp(-gamma d2(x, sv_s)), by a group of GT threads: each thread computes
// the term of record base + g, and every thread of the group folds the GT
// terms of a round into its sum in record order, each term broadcast from
// the thread that computed it.  Every thread of the group thus runs kernel
// D's one in-order FMA chain and holds the same bits (a tree reduction
// would give other bits than D, a butterfly different bits in different
// threads, whose Brent iterates would then part).
template <int GT, typename T, class FM>
__device__ __forceinline__ T group_accumulate(const T* buf, int m,
                                              const FM& fm,
                                              const T (&x)[FM::CAP], T x2,
                                              T gamma, T acc) {
  if constexpr (GT == 1) {  // one thread a lane: kernel D's own loop
    T xs[1][FM::CAP], x2s[1] = {x2}, accs[1] = {acc};
    for_features(fm, [&](int k) { xs[0][k] = x[k]; });
    pylabfea::svc_accumulate<T, FM, 1>(buf, m, fm, xs, x2s, gamma, accs);
    return accs[0];
  } else {
    constexpr int B = GT < 8 ? GT : 8;  // terms gathered before folding
    const int rs = pylabfea::svc_rstride(fm.n());
    const int g = threadIdx.x % GT;
    const unsigned first = (threadIdx.x & 31u) & ~(unsigned)(GT - 1);
    const unsigned mask =
        GT == 32 ? 0xffffffffu : (((1u << GT) - 1u) << first);
    for (int base = 0; base < m; base += GT) {
      T e = T(0);
      if (base + g < m) {
        pylabfea::SvcRec<T, FM> r;
        pylabfea::svc_load(buf, base + g, fm, r);
        e = pylabfea::svc_term(r, x, x2, gamma, fm);
      }
      const int cnt = min(GT, m - base);
#pragma unroll
      for (int k0 = 0; k0 < GT; k0 += B) {
        T ek[B], dk[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          ek[b] = __shfl_sync(mask, e, k0 + b, GT);
          dk[b] = k0 + b < cnt ? buf[(base + k0 + b) * rs + fm.n() + 1]
                               : T(0);
        }
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (k0 + b < cnt) acc = pylabfea::fma_t(dk[b], ek[b], acc);
      }
    }
    return acc;
  }
}

template <typename T>
struct RootArgs {
  const T *su, *extra, *mean, *fscale, *start, *top, *sv, *dc;
  long long n;
  int nsu, nsv;
  T gamma, rho, scale;
  bool dev_only, cyl;
  int maxmarch, maxiter;
  T xtol, rtol;
  T* xs;
  bool* ok;
  int* nevals;
};

template <typename T, class FM, int GT>
__global__ void __launch_bounds__(THREADS)
yf_root_kernel(const RootArgs<T> a, FM fm) {
  __shared__ __align__(16) T buf[SVC_STAGE_VALUES];
  const int nf = fm.n(), nsv = a.nsv;
  const int stage = pylabfea::svc_stage_records(fm);
  const long long lane = ((long long)blockIdx.x * THREADS + threadIdx.x) / GT;
  const int g = threadIdx.x % GT;
  const bool live = lane < a.n;
  RootMap<T, FM> map;
  map.inv_scale = div_rn(T(1), a.scale);
  map.nsu = a.nsu;
  map.dev_only = a.dev_only;
  map.cyl = a.cyl;
  map.tex = a.mean != nullptr;
  const int lead = a.cyl ? 1 : 6, next = nf - lead;
  Lane<T> L;
  L.stage = START;
  L.it = L.nevals = 0;
  if (live) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      map.su[k] = k < a.nsu ? a.su[lane * a.nsu + k] : T(0);
      map.mean[k] = map.tex ? a.mean[k] : T(0);
      map.fsc[k] = map.tex ? a.fscale[k] : T(1);
    }
    for_features(fm, [&](int k) {
      if (k >= lead) map.ext[k] = a.extra[lane * next + k - lead];
    });
    L.start = L.x = a.start[lane];
    L.top = a.top[lane];
  }
  if (nsv <= stage) {
    pylabfea::svc_stage(buf, fm, a.sv, a.dc, 0, nsv);
    __syncthreads();
    if (live) {
      while (L.stage != DONE) {
        T x[FM::CAP];
        features(L.x, map, fm, x);
        const T acc = group_accumulate<GT>(
            buf, nsv, fm, x, pylabfea::svc_norm2(x, fm), a.gamma, T(0));
        advance(L, acc + a.rho, a.maxmarch, a.maxiter, a.xtol, a.rtol);
      }
    }
  } else {
    bool active = live;
    while (__syncthreads_or(active)) {
      T x[FM::CAP], x2 = T(0), acc = T(0);
      if (active) {
        features(L.x, map, fm, x);
        x2 = pylabfea::svc_norm2(x, fm);
      }
      for (int s0 = 0; s0 < nsv; s0 += stage) {
        const int m = min(stage, nsv - s0);
        __syncthreads();  // previous chunk fully consumed
        pylabfea::svc_stage(buf, fm, a.sv, a.dc, s0, m);
        __syncthreads();
        if (active)
          acc = group_accumulate<GT>(buf, m, fm, x, x2, a.gamma, acc);
      }
      if (active) {
        advance(L, acc + a.rho, a.maxmarch, a.maxiter, a.xtol, a.rtol);
        active = L.stage != DONE;
      }
    }
  }
  if (live && g == 0) {
    a.xs[lane] = L.b.ok ? L.b.root : L.b.xcur;
    a.ok[lane] = L.b.ok;
    if (a.nevals != nullptr) a.nevals[lane] = L.nevals;
  }
}

template <typename T, int GT, class FM>
void launch_g(const RootArgs<T>& a, FM fm, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.n * GT + THREADS - 1) / THREADS);
  yf_root_kernel<T, FM, GT><<<blocks, THREADS, 0, stream>>>(a, fm);
}

template <typename T>
int launch(const RootArgs<T>& a, int nfeat, void* stream) {
  const int lead = a.cyl ? 1 : 6;
  if (a.n <= 0 || a.nsv <= 0 || a.maxmarch < 0 || a.maxiter < 0 ||
      nfeat < lead || (a.nsu != 6 && !(a.cyl && a.nsu == 3)) ||
      (nfeat > lead && a.extra == nullptr) ||
      ((a.mean == nullptr) != (a.fscale == nullptr)) ||
      (a.cyl && a.mean != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // the group size: the largest power of two up to 32 with n * GT threads
  // still at most 1024 per SM
  const long long fill = (long long)pylabfea::sm_count() * 1024;
  int gt = 1;
  while (gt < 32 && a.n * gt * 2 <= fill) gt *= 2;
  const bool ok = pylabfea::with_features(nfeat, [&](auto fm) {
    switch (gt) {
      case 1: launch_g<T, 1>(a, fm, s); break;
      case 2: launch_g<T, 2>(a, fm, s); break;
      case 4: launch_g<T, 4>(a, fm, s); break;
      case 8: launch_g<T, 8>(a, fm, s); break;
      case 16: launch_g<T, 16>(a, fm, s); break;
      default: launch_g<T, 32>(a, fm, s); break;
    }
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int yf_root(const T* su, int nsu, const T* extra, const T* mean,
            const T* fscale, const T* start, const T* top, const T* sv,
            const T* dc, long long n, int nsv, int nfeat, T gamma, T rho,
            T scale_seq, int dev_only, int cyl, int maxmarch, int maxiter,
            T xtol, T rtol, T* xs, bool* ok, int* nevals, void* stream) {
  RootArgs<T> a{su, extra, mean, fscale, start, top, sv, dc, n, nsu, nsv,
                gamma, rho, scale_seq, dev_only != 0, cyl != 0, maxmarch,
                maxiter, xtol, rtol, xs, ok, nevals};
  return launch(a, nfeat, stream);
}

}  // namespace

// su (n, nsu); extra (n, nfeat - lead) or null; mean and fscale (6,) or
// null; lead = 1 with cyl, else 6.
extern "C" int pylabfea_yf_root_f32(
    const float* su, int nsu, const float* extra, const float* mean,
    const float* fscale, const float* start, const float* top,
    const float* sv, const float* dc, long long n, int nsv, int nfeat,
    float gamma, float rho, float scale_seq, int dev_only, int cyl,
    int maxmarch, int maxiter, float xtol, float rtol, float* xs, bool* ok,
    int* nevals, void* stream) {
  return yf_root<float>(su, nsu, extra, mean, fscale, start, top, sv, dc, n,
                        nsv, nfeat, gamma, rho, scale_seq, dev_only, cyl,
                        maxmarch, maxiter, xtol, rtol, xs, ok, nevals,
                        stream);
}

extern "C" int pylabfea_yf_root_f64(
    const double* su, int nsu, const double* extra, const double* mean,
    const double* fscale, const double* start, const double* top,
    const double* sv, const double* dc, long long n, int nsv, int nfeat,
    double gamma, double rho, double scale_seq, int dev_only, int cyl,
    int maxmarch, int maxiter, double xtol, double rtol, double* xs,
    bool* ok, int* nevals, void* stream) {
  return yf_root<double>(su, nsu, extra, mean, fscale, start, top, sv, dc, n,
                         nsv, nfeat, gamma, rho, scale_seq, dev_only, cyl,
                         maxmarch, maxiter, xtol, rtol, xs, ok, nevals,
                         stream);
}
