// The soft blob-blob repulsion law of kernels K2 (blob_forces.cu, direct)
// and K5 (nl_forces.cu, linked cells),
//   mag = eps/b exp((2a - r)/b) / r  for r > 2a,   eps/(b r) otherwise,
// written branch-free with one MUFU.EX2 of a folded argument,
//   mag = (eps/b) r^-1 2^min(c 2a - c r, 0),   c = log2(e) / b,
// which is (eps/b) / r within 2a (2^0 = 1) and the exponential beyond. The
// wrappers fold (eps/b, c, c 2a) on the host (ops/mobility_cuda.py
// fold_law). A self pair and coincident blobs have r^2 == 0 and take
// mag = 0 by a select, so no pair tests an index.

#pragma once

#include <cuda_runtime.h>

namespace forcek {

__device__ __forceinline__ float exp2_t(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ double exp2_t(double x) { return exp2(x); }

// eps/b, c = log2(e)/b and c 2a of the folded law
template <typename T>
struct Law {
  T eob, c, c2a;
};

// the magnitude of a pair at r^2, given invr = r^-1 from the caller's
// rsqrt (rsqrt.approx.ftz in float32)
template <typename T>
__device__ __forceinline__ T magnitude(const Law<T>& law, T r2, T invr) {
  const T r = r2 * invr;
  // r^2 == 0: r is NaN and fmin returns 0; the select below drops the pair
  const T e = exp2_t(fmin(law.c2a - law.c * r, T(0)));
  const T mag = (law.eob * invr) * e;
  return r2 > T(0) ? mag : T(0);
}

}  // namespace forcek
