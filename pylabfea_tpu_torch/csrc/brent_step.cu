// One iteration of the batched Brent zeroin, every lane's update fused.
//
// Replaces the body of the while loop of pylabfea_tpu/ops/rootfind.py
// brent_jax, which XLA compiles into one fused loop body on the TPU; it is
// the card route of rootfind.brent, the port's batched Brent zeroin for any
// function f.  As separate PyTorch operations one iteration launches about
// 90 elementwise kernels; this kernel does the iteration's whole update in
// one launch, and the evaluation of f at the new abscissa stays outside.
//
// What bounds it: 11 values read and written per lane, about 40 flops:
// bytes-bound, and at the return map's lane counts (10^3 to 10^6) a
// launch or a few microseconds.
//
// Design: one thread per lane; the state arrays are updated in place.
// Finished lanes return at once (the plain version masks every update
// with the active set).  The update itself is brent_body.cuh's, which
// kernel G (yf_root.cu) runs in registers: one IEEE operation at a time
// (the __*_rn intrinsics), in the order of the plain PyTorch version
// (rootfind.brent_step_plain), so both give the same bits and the float64
// iterate sequence stays the JAX package's.  The yield-locus distance of
// the faithful return map runs its root find in kernel G; this kernel
// serves rootfind.brent, the counterpart of brent_jax for any f.
#include <cuda_runtime.h>

#include "brent_body.cuh"

namespace {

using pylabfea::BrentState;

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
brent_step_kernel(long long n, bool* __restrict__ done, bool* __restrict__ ok,
                  T* __restrict__ root, T* __restrict__ xpre,
                  T* __restrict__ fpre, T* __restrict__ xcur,
                  T* __restrict__ fcur, T* __restrict__ xblk,
                  T* __restrict__ fblk, T* __restrict__ spre,
                  T* __restrict__ scur, T xtol, T rtol) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || done[i]) return;
  BrentState<T> s{false,   ok[i],   root[i], xpre[i], fpre[i], xcur[i],
                  fcur[i], xblk[i], fblk[i], spre[i], scur[i]};
  pylabfea::brent_iteration(s, xtol, rtol);
  if (s.done) {
    root[i] = s.root;
    ok[i] = true;
    done[i] = true;
  }
  xpre[i] = s.xpre;
  fpre[i] = s.fpre;
  xcur[i] = s.xcur;
  fcur[i] = s.fcur;
  xblk[i] = s.xblk;
  fblk[i] = s.fblk;
  spre[i] = s.spre;
  scur[i] = s.scur;
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
