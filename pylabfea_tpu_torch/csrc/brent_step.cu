// One iteration of the batched Brent zeroin, every lane's update fused.
//
// Replaces the body of the while loop of pylabfea_tpu/ops/rootfind.py
// brent_jax, which XLA compiles into one fused loop body on the TPU.  The
// reference-faithful return map runs a Brent root find in every
// yield-locus distance evaluation (up to 100 iterations, over 200 times
// per response); as separate PyTorch operations one iteration launches
// about 90 elementwise kernels, so the root find was bound by launch
// overhead.  This kernel does the iteration's whole update in one launch;
// the function evaluation at the new abscissa stays outside (the SVC
// decision function, kernel D).
//
// What bounds it: 11 values read and written per lane, about 40 flops:
// bytes-bound, and at the return map's lane counts (10^3 to 10^6) a
// launch or a few microseconds.
//
// Design: one thread per lane; the state arrays are updated in place.
// Finished lanes return at once (the plain version masks every update
// with the active set).  Every operation is one IEEE operation with
// round-to-nearest and no contraction into FMAs (the __*_rn intrinsics),
// in the order of the plain PyTorch version (rootfind.brent_step_plain),
// so both give the same bits and the float64 iterate sequence stays the
// JAX package's.  The exact comparisons fcur == 0 and xpre == xblk and the
// safe divisions (a zero divisor replaced by 1) are kept.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ T safe(T v) {
  return v == T(0) ? T(1) : v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
brent_step_kernel(long long n, bool* __restrict__ done, bool* __restrict__ ok,
                  T* __restrict__ root, T* __restrict__ xpre_,
                  T* __restrict__ fpre_, T* __restrict__ xcur_,
                  T* __restrict__ fcur_, T* __restrict__ xblk_,
                  T* __restrict__ fblk_, T* __restrict__ spre_,
                  T* __restrict__ scur_, T xtol, T rtol) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || done[i]) return;
  T xpre = xpre_[i], fpre = fpre_[i], xcur = xcur_[i], fcur = fcur_[i];
  T xblk = xblk_[i], fblk = fblk_[i], spre = spre_[i], scur = scur_[i];

  if (mul_rn(fpre, fcur) < T(0)) {  // a new bracket
    xblk = xpre;
    fblk = fpre;
    spre = sub_rn(xcur, xpre);
    scur = spre;
  }
  if (abs_t(fblk) < abs_t(fcur)) {  // rotate: pre <- cur, cur <- blk
    xpre = xcur;
    fpre = fcur;
    xcur = xblk;
    fcur = fblk;
    xblk = xpre;
    fblk = fpre;
  }
  const T delta = div_rn(add_rn(xtol, mul_rn(rtol, abs_t(xcur))), T(2));
  const T sbis = div_rn(sub_rn(xblk, xcur), T(2));
  if (fcur == T(0) || abs_t(sbis) < delta) {  // converged
    root[i] = xcur;
    ok[i] = true;
    done[i] = true;
  } else {
    const bool interp = abs_t(spre) > delta && abs_t(fcur) < abs_t(fpre);
    T stry;
    if (xpre == xblk) {  // secant
      stry = div_rn(mul_rn(-fcur, sub_rn(xcur, xpre)),
                    safe(sub_rn(fcur, fpre)));
    } else {  // inverse quadratic interpolation
      const T dpre = div_rn(sub_rn(fpre, fcur), safe(sub_rn(xpre, xcur)));
      const T dblk = div_rn(sub_rn(fblk, fcur), safe(sub_rn(xblk, xcur)));
      stry = div_rn(mul_rn(-fcur, sub_rn(mul_rn(fblk, dblk),
                                         mul_rn(fpre, dpre))),
                    safe(mul_rn(mul_rn(dblk, dpre), sub_rn(fblk, fpre))));
    }
    // 2|stry| < min(|spre|, 3|sbis| - delta); a NaN makes it false, as
    // torch.minimum's NaN does in the plain version
    const T lhs = mul_rn(T(2), abs_t(stry));
    const bool accept = interp && lhs < abs_t(spre) &&
                        lhs < sub_rn(mul_rn(T(3), abs_t(sbis)), delta);
    spre = accept ? scur : sbis;
    scur = accept ? stry : sbis;
    xpre = xcur;
    fpre = fcur;
    const T step = abs_t(scur) > delta ? scur : (sbis > T(0) ? delta : -delta);
    xcur = add_rn(xcur, step);
  }
  xpre_[i] = xpre;
  fpre_[i] = fpre;
  xcur_[i] = xcur;
  fcur_[i] = fcur;
  xblk_[i] = xblk;
  fblk_[i] = fblk;
  spre_[i] = spre;
  scur_[i] = scur;
}

template <typename T>
int launch(long long n, bool* done, bool* ok, T* root, T* xpre, T* fpre,
           T* xcur, T* fcur, T* xblk, T* fblk, T* spre, T* scur, T xtol,
           T rtol, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  brent_step_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      n, done, ok, root, xpre, fpre, xcur, fcur, xblk, fblk, spre, scur,
      xtol, rtol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pylabfea_brent_step_f32(long long n, bool* done, bool* ok,
                                       float* root, float* xpre, float* fpre,
                                       float* xcur, float* fcur, float* xblk,
                                       float* fblk, float* spre, float* scur,
                                       float xtol, float rtol, void* stream) {
  return launch<float>(n, done, ok, root, xpre, fpre, xcur, fcur, xblk, fblk,
                       spre, scur, xtol, rtol, stream);
}

extern "C" int pylabfea_brent_step_f64(long long n, bool* done, bool* ok,
                                       double* root, double* xpre,
                                       double* fpre, double* xcur,
                                       double* fcur, double* xblk,
                                       double* fblk, double* spre,
                                       double* scur, double xtol,
                                       double rtol, void* stream) {
  return launch<double>(n, done, ok, root, xpre, fpre, xcur, fcur, xblk,
                        fblk, spre, scur, xtol, rtol, stream);
}
