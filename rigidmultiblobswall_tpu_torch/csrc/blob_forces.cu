// Kernel K2: direct O(N^2) soft blob-blob repulsion in an open
// (non-periodic) domain,
//   F_i = sum_{j != i} mag(r_ij) (r_i - r_j),
//   mag = eps/b exp(-(r - 2a)/b) / r  for r > 2a,   eps/(b r) otherwise.
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/mobility_pallas.py
// (_force_kernel; wrapper blob_blob_forces_pallas).
//
// What bounds it on the H100: the per-pair special functions (one rsqrt
// and one exp) and FP32 issue rate; device memory sees each source tile
// once per block of 128 targets.
//
// Design: one thread per target, sources tiled through shared memory,
// sums in registers. Self pairs (i == j) and coincident blobs (r^2 == 0)
// contribute nothing. Ragged edges are masked by index; no sentinel
// padding.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(kTile)
blob_forces_kernel(const T* __restrict__ r, T* __restrict__ out, int n,
                   T eps_over_b, T inv_debye, T two_a) {
  __shared__ T s_pos[3][kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool active = i < n;
  T xt = T(0), yt = T(0), zt = T(0);
  if (active) {
    xt = r[3 * i + 0];
    yt = r[3 * i + 1];
    zt = r[3 * i + 2];
  }
  T fx = T(0), fy = T(0), fz = T(0);
  for (int base = 0; base < n; base += kTile) {
    const int j_load = base + threadIdx.x;
    if (j_load < n) {
      s_pos[0][threadIdx.x] = r[3 * j_load + 0];
      s_pos[1][threadIdx.x] = r[3 * j_load + 1];
      s_pos[2][threadIdx.x] = r[3 * j_load + 2];
    }
    __syncthreads();
    const int count = min(kTile, n - base);
    if (active) {
      // per-tile partial sums (see pair_tt.cu)
      T px = T(0), py = T(0), pz = T(0);
      for (int k = 0; k < count; ++k) {
        const T dx = xt - s_pos[0][k];
        const T dy = yt - s_pos[1][k];
        const T dz = zt - s_pos[2][k];
        const T r2 = dx * dx + dy * dy + dz * dz;
        if (base + k == i || r2 == T(0)) continue;
        const T invr = rsqrt_t(r2);
        const T rn = r2 * invr;
        T mag = eps_over_b * invr;
        if (rn > two_a) mag *= exp_t(-(rn - two_a) * inv_debye);
        px += mag * dx;
        py += mag * dy;
        pz += mag * dz;
      }
      fx += px;
      fy += py;
      fz += pz;
    }
    __syncthreads();
  }
  if (active) {
    out[3 * i + 0] = fx;
    out[3 * i + 1] = fy;
    out[3 * i + 2] = fz;
  }
}

template <typename T>
int launch(const T* r, T* out, int n, double eps_over_b, double inv_debye,
           double two_a, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile);
  blob_forces_kernel<T><<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      r, out, n, T(eps_over_b), T(inv_debye), T(two_a));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r (n,3) and out (n,3), contiguous on the device; n > 0. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int blob_forces_f32(const float* r, float* out, int n,
                               double eps_over_b, double inv_debye,
                               double two_a, void* stream) {
  return launch<float>(r, out, n, eps_over_b, inv_debye, two_a, stream);
}

extern "C" int blob_forces_f64(const double* r, double* out, int n,
                               double eps_over_b, double inv_debye,
                               double two_a, void* stream) {
  return launch<double>(r, out, n, eps_over_b, inv_debye, two_a, stream);
}
