// Kernel M1: the soft blob-blob repulsion energy of a batch of P
// configurations of n blobs each,
//   E_p = sum_{i < j} u(r_ij),
//   u = eps exp(-(r - 2a)/b)  for r > 2a,   eps + eps (2a - r)/b otherwise,
// with r_ij = |x_i - x_j| in an open domain or above the wall, and under
// the minimum image on the periodic axes (L > 0) in its truncation form
// d - trunc(d/L + sign(d)/2) L (the JAX package's _min_image), never over
// image boxes.
//
// Replaces no Pallas kernel: the JAX package computes this sum as XLA on a
// materialized (N, N, 3) difference tensor (rigidmultiblobswall_tpu/ops/
// forces.py:506 blob_blob_energy and the pair term of models/mcmc.py:25
// total_energy), 29 GB in float32 at 49,152 blobs; the MCMC chain
// evaluates it once a step with every body moved.
//
// Two mask flavours, as the two JAX functions set them (template ONE):
// blob_blob_energy drops a pair of distinct coincident blobs (r^2 = 0),
// total_energy keeps it as u(r = 1) (it masks only the diagonal and takes
// r = 1 where r^2 = 0). The diagonal and the blobs past n are masked by
// index: each thread's loop covers only its live pairs.
//
// What bounds it on the H100: the special-function unit. A pair needs one
// rsqrt and one exp2 (MUFU, 16 a clock an SM) beside ~18 float32
// operations; bytes are 12 a blob once.
//
// Design: the energy is symmetric and scalar, so each unordered pair is
// formed once and nothing flows back to the source. The 128-blob tiles fall
// into K1's tile groups (ops/pair_kernels.py plan_groups); gridDim.x runs
// over the G (G + 1) / 2 group pairs of the upper triangle
// (pairk::group_pair) and gridDim.y over the configurations (chunked below
// 65,535 by the launcher). A block sweeps its tile pairs (a, b), b >= a on
// the diagonal group pair, one target of tile a a thread and tile b staged
// in shared memory as padded 16-byte rows read by broadcast; on a diagonal
// tile each thread takes the sources past its own index only. The law is
// forcek::energy (csrc/force_law.cuh), branch-free with one MUFU.EX2;
// rsqrt is pairk::rsqrt_t (rsqrt.approx.ftz in float32). Each tile pair's
// terms are summed in registers in the positions' type and added into a
// float64 sum: the Metropolis test compares energy differences with kT,
// and at 49,152 blobs the total holds 1.2e9 terms. A block reduces its
// threads' sums in a fixed order (warp shuffles, then the four warps in
// order) to one partial; sum_partials adds each configuration's partials in
// a fixed order. No atomics: the result is bit-identical on repeat. The
// energy is returned in float64 for float32 positions too.

#include <cuda_runtime.h>

#include "force_law.cuh"
#include "pair_blocks.cuh"

namespace {

using pairk::kLanes;
using pairk::kTile;
using pairk::kWarps;

using forcek::EnergyLaw;

constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float trunc_t(float x) { return truncf(x); }
__device__ __forceinline__ double trunc_t(double x) { return trunc(x); }

// the box of the periodic instance: L[a] > 0 on a periodic axis
template <typename T>
struct Box {
  T L[3];
  // d - trunc(d/L + sign(d)/2) L on a periodic axis, d on an open one
  __device__ T image(T d, int a) const {
    const T len = L[a];
    if (!(len > T(0))) return d;
    const T half = d > T(0) ? T(0.5) : (d < T(0) ? T(-0.5) : T(0));
    return d - trunc_t(d / len + half) * len;
  }
};

// the energy of the pair (target, source) from their difference
template <typename T, bool PERIODIC, bool ONE>
__device__ __forceinline__ T pair_energy(const EnergyLaw<T>& law,
                                         const Box<T>& box, T dx, T dy,
                                         T dz) {
  if (PERIODIC) {
    dx = box.image(dx, 0);
    dy = box.image(dy, 1);
    dz = box.image(dz, 2);
  }
  const T r2 = dx * dx + dy * dy + dz * dz;
  const bool zero = !(r2 > T(0));
  // ONE: a coincident pair takes r = 1 (total_energy); else it adds 0
  const T r2e = zero ? T(1) : r2;
  const T u = forcek::energy(law, r2e * pairk::rsqrt_t(r2e));
  return (!ONE && zero) ? T(0) : u;
}

// One block: the tile pairs of group pair blockIdx.x of configuration
// blockIdx.y; writes its partial sum to partials[blockIdx.y][blockIdx.x].
template <typename T, bool PERIODIC, bool ONE>
__global__ void __launch_bounds__(kTile, (pairk::Shape<T>::kMinBlocks))
energy_kernel(const T* __restrict__ r_all, double* __restrict__ partials,
              int n, int n_groups, int tiles_per_group, EnergyLaw<T> law,
              Box<T> box) {
  __shared__ __align__(16) T s_src[kTile][4];
  __shared__ double s_warp[kWarps];

  const T* q = r_all + (size_t)blockIdx.y * n * 3;
  int ga, gb;
  pairk::group_pair(blockIdx.x, n_groups, ga, gb);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int a_begin = ga * tiles_per_group;
  const int a_end = min(n_tiles, a_begin + tiles_per_group);
  const int b_begin = gb * tiles_per_group;
  const int b_end = min(n_tiles, b_begin + tiles_per_group);

  double acc = 0.0;
#pragma unroll 1
  for (int ta = a_begin; ta < a_end; ++ta) {
    const int i = ta * kTile + threadIdx.x;
    T xi = T(0), yi = T(0), zi = T(0);
    if (i < n) {
      xi = q[3 * i + 0];
      yi = q[3 * i + 1];
      zi = q[3 * i + 2];
    }
#pragma unroll 1
    for (int tb = ga == gb ? ta : b_begin; tb < b_end; ++tb) {
      __syncthreads();  // s_src may still be read for the previous tile
      const int j = tb * kTile + threadIdx.x;
      if (j < n) {
        s_src[threadIdx.x][0] = q[3 * j + 0];
        s_src[threadIdx.x][1] = q[3 * j + 1];
        s_src[threadIdx.x][2] = q[3 * j + 2];
        s_src[threadIdx.x][3] = T(0);
      }
      __syncthreads();
      const int count = min(kTile, n - tb * kTile);
      // the live sources of this thread: past its own index on the
      // diagonal tile, none for a target past n
      int k = tb == ta ? static_cast<int>(threadIdx.x) + 1 : 0;
      if (i >= n) k = count;
      T part = T(0);
#pragma unroll 4
      for (; k < count; ++k) {
        T src[4];
        pairk::load_row<4>(s_src[k], src);
        part += pair_energy<T, PERIODIC, ONE>(law, box, xi - src[0],
                                              yi - src[1], zi - src[2]);
      }
      acc += static_cast<double>(part);
    }
  }
  // the block's sum in a fixed order: within each warp, then warp by warp
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (threadIdx.x % kLanes == 0) s_warp[threadIdx.x / kLanes] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = s_warp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += s_warp[w];
    partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// out[p] = the sum of configuration p's n_blocks partials, in a fixed
// order (a strided sum a thread, then a tree over the block)
constexpr int kSumThreads = 128;
__global__ void __launch_bounds__(kSumThreads)
sum_partials(const double* __restrict__ partials, double* __restrict__ out,
             int n_blocks) {
  __shared__ double s[kSumThreads];
  const double* p = partials + (size_t)blockIdx.x * n_blocks;
  double acc = 0.0;
  for (int b = threadIdx.x; b < n_blocks; b += kSumThreads) acc += p[b];
  s[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

template <typename T, bool PERIODIC, bool ONE>
int launch(const T* r, double* partials, double* out, int n_conf, int n,
           int n_groups, int tiles_per_group, const EnergyLaw<T>& law,
           const Box<T>& box, cudaStream_t s) {
  const long long n_pairs =
      static_cast<long long>(n_groups) * (n_groups + 1) / 2;
  for (int p0 = 0; p0 < n_conf; p0 += kMaxGridY) {
    const int chunk = min(kMaxGridY, n_conf - p0);
    energy_kernel<T, PERIODIC, ONE>
        <<<dim3(static_cast<unsigned>(n_pairs), chunk), kTile, 0, s>>>(
            r + (size_t)p0 * n * 3, partials + (size_t)p0 * n_pairs, n,
            n_groups, tiles_per_group, law, box);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sum_partials<<<n_conf, kSumThreads, 0, s>>>(partials, out,
                                              static_cast<int>(n_pairs));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* r, double* partials, double* out, int n_conf, int n,
             int n_groups, int tiles_per_group, double eps, double c,
             double two_a, double inv_b, const double* L, int one,
             void* stream) {
  if (r == nullptr || partials == nullptr || out == nullptr || n_conf < 1 ||
      n < 1 || n_groups < 1 || tiles_per_group < 1 ||
      static_cast<long long>(n_groups) * (n_groups + 1) / 2 > 0x7fffffffLL ||
      static_cast<long long>(n_groups) * tiles_per_group * kTile < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EnergyLaw<T> law{T(eps), T(c), T(two_a), T(inv_b)};
  Box<T> box{};
  const bool periodic =
      L != nullptr && (L[0] > 0.0 || L[1] > 0.0 || L[2] > 0.0);
  if (periodic)
    for (int a = 0; a < 3; ++a) box.L[a] = T(L[a]);
#define ENERGY_CASE(P, O)                                                    \
  if (periodic == P && (one != 0) == O)                                      \
    return launch<T, P, O>(r, partials, out, n_conf, n, n_groups,            \
                           tiles_per_group, law, box, s);
  ENERGY_CASE(false, false)
  ENERGY_CASE(false, true)
  ENERGY_CASE(true, false)
  ENERGY_CASE(true, true)
#undef ENERGY_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r (n_conf, n, 3) contiguous on the device; partials (n_conf, G (G + 1)
// / 2) float64 workspace and out (n_conf,) float64 on the device; groups of
// tiles_per_group 128-blob tiles covering n (ops/pair_kernels.py
// plan_groups); the law's eps, c = log2(e) / b, 2a and 1 / b (ops/
// mobility_cuda.py energy_law); L (3,) a host array, the box (0 on an open
// axis), or null for no periodic axis; one: 1 for total_energy's mask
// (a coincident distinct pair at r = 1), 0 for blob_blob_energy's (it
// adds 0). Returns the CUDA error code of the launches (0 on success).
#define ENERGY_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* r, double* partials, double* out,             \
                      int n_conf, int n, int n_groups, int tiles_per_group,  \
                      double eps, double c, double two_a, double inv_b,      \
                      const double* L, int one, void* stream) {              \
    return dispatch<T>(r, partials, out, n_conf, n, n_groups,                \
                       tiles_per_group, eps, c, two_a, inv_b, L, one,        \
                       stream);                                              \
  }

ENERGY_ENTRY(blob_energy_f32, float)
ENERGY_ENTRY(blob_energy_f64, double)
