// One iteration of the Brent zeroin on one lane, held in registers.
//
// The body of the while loop of pylabfea_tpu/ops/rootfind.py brent_jax
// (rootfind.brent_step_plain in the port), shared by kernel F
// (brent_step.cu: one iteration of every lane per launch, the state in
// device memory) and kernel G (yf_root.cu: a whole root find per lane in
// one launch, the state in registers).
//
// Every operation is one IEEE operation with round-to-nearest and no
// contraction into FMAs (the __*_rn intrinsics), in the order of the plain
// PyTorch version, so both give the same bits and an iterate sequence
// depends only on the f values the caller evaluates.  The exact comparisons
// fcur == 0 and xpre == xblk and the safe divisions (a zero divisor replaced
// by 1) are kept.
#pragma once
#include <cuda_runtime.h>

#include "fp_ops.cuh"

namespace pylabfea {

__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ T safe(T v) {
  return v == T(0) ? T(1) : v;
}

// The state of one lane, in the order of rootfind.STATE.
template <typename T>
struct BrentState {
  bool done, ok;
  T root, xpre, fpre, xcur, fcur, xblk, fblk, spre, scur;
};

// One iteration on a lane that is not done, up to the new abscissa xcur;
// the caller evaluates f there unless the lane is now done.
template <typename T>
__device__ __forceinline__ void brent_iteration(BrentState<T>& s, T xtol,
                                                T rtol) {
  if (mul_rn(s.fpre, s.fcur) < T(0)) {  // a new bracket
    s.xblk = s.xpre;
    s.fblk = s.fpre;
    s.spre = sub_rn(s.xcur, s.xpre);
    s.scur = s.spre;
  }
  if (abs_t(s.fblk) < abs_t(s.fcur)) {  // rotate: pre <- cur, cur <- blk
    s.xpre = s.xcur;
    s.fpre = s.fcur;
    s.xcur = s.xblk;
    s.fcur = s.fblk;
    s.xblk = s.xpre;
    s.fblk = s.fpre;
  }
  const T delta = div_rn(add_rn(xtol, mul_rn(rtol, abs_t(s.xcur))), T(2));
  const T sbis = div_rn(sub_rn(s.xblk, s.xcur), T(2));
  if (s.fcur == T(0) || abs_t(sbis) < delta) {  // converged
    s.root = s.xcur;
    s.ok = true;
    s.done = true;
    return;
  }
  const bool interp = abs_t(s.spre) > delta && abs_t(s.fcur) < abs_t(s.fpre);
  T stry;
  if (s.xpre == s.xblk) {  // secant
    stry = div_rn(mul_rn(-s.fcur, sub_rn(s.xcur, s.xpre)),
                  safe(sub_rn(s.fcur, s.fpre)));
  } else {  // inverse quadratic interpolation
    const T dpre = div_rn(sub_rn(s.fpre, s.fcur), safe(sub_rn(s.xpre, s.xcur)));
    const T dblk = div_rn(sub_rn(s.fblk, s.fcur), safe(sub_rn(s.xblk, s.xcur)));
    stry = div_rn(mul_rn(-s.fcur, sub_rn(mul_rn(s.fblk, dblk),
                                         mul_rn(s.fpre, dpre))),
                  safe(mul_rn(mul_rn(dblk, dpre), sub_rn(s.fblk, s.fpre))));
  }
  // 2|stry| < min(|spre|, 3|sbis| - delta); a NaN makes it false, as
  // torch.minimum's NaN does in the plain version
  const T lhs = mul_rn(T(2), abs_t(stry));
  const bool accept = interp && lhs < abs_t(s.spre) &&
                      lhs < sub_rn(mul_rn(T(3), abs_t(sbis)), delta);
  s.spre = accept ? s.scur : sbis;
  s.scur = accept ? stry : sbis;
  s.xpre = s.xcur;
  s.fpre = s.fcur;
  const T step = abs_t(s.scur) > delta ? s.scur
                                       : (sbis > T(0) ? delta : -delta);
  s.xcur = add_rn(s.xcur, step);
}

}  // namespace pylabfea
