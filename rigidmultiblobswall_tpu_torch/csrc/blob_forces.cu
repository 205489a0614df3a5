// Kernel K2: direct O(N^2) soft blob-blob repulsion,
//   F_i = sum_{j != i} mag(r_ij) (r_i - r_j),
//   mag = eps/b exp(-(r - 2a)/b) / r  for r > 2a,   eps/(b r) otherwise,
// in an open domain, and its periodic instance: d = r_i - r_j taken to the
// minimum image in its truncation form, d - trunc(d/L + sign(d)/2) L, on
// each periodic axis (L > 0), then summed over the image boxes d + b L of a
// list (b in {-1, 0, 1} on the periodic axes), the self pair skipped in
// every box (its images cancel in pairs).
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/mobility_pallas.py
// (_force_kernel; wrapper blob_blob_forces_pallas) and, in its periodic
// instance, the XLA sweep of rigidmultiblobswall_tpu/ops/forces.py
// (blob_blob_forces with periodic_length, :48-109).
//
// What bounds it on the H100: instruction issue and the special-function
// unit, not bytes (12 bytes a blob in and out against ~20 operations a
// directed pair, two of them on MUFU, which runs at an eighth of the FP32
// rate). The law, shared with K5, is branch-free with one MUFU.EX2 of a folded
// argument (csrc/force_law.cuh); r^-1 is rsqrt.approx.ftz in float32
// (csrc/pair_blocks.cuh).
//
// Design: the force is antisymmetric (F_ji = -F_ij with one magnitude a
// pair), so the sweep is K1's symmetric one (csrc/pair_blocks.cuh,
// sym_kernel): each unordered pair's magnitude is formed once and applied
// as +mag d to the target and -mag d to the source. The 128-blob tiles fall
// into the tile groups of ops/pair_kernels.py plan_groups, a block takes
// one pair of groups of the upper triangle (group_pair), and off the
// diagonal a warp rotates 32 sources and their running sums through its
// lanes with shuffles; a diagonal tile runs the directed sweep over its own
// tile. Each block owns one workspace slice of its groups' rows, and
// slice_sum_kernel adds the G slices in order: no atomics, bit-identical on
// repeat, a workspace (G, N, 3) that grows like N. Ragged edges: a blob
// past N sits at far_coord, so far from every blob that its magnitude is
// 0; the periodic instance, whose minimum image would fold that far blob
// back into the box, masks the pairs of blobs past N by their index.
// Minimum image and box offsets are odd in d, so the periodic sum stays
// antisymmetric and the symmetric sweep holds. Its cost: three IEEE
// divisions a pair (MUFU.RCP and a correction, kept for the truncation's
// rounding at half a box) and one magnitude a box; the wrapper drops the
// boxes whose magnitudes underflow to 0 for every pair (ops/mobility_cuda.py
// image_boxes), so a box wider than the force's range costs one box.

#include "force_law.cuh"
#include "pair_blocks.cuh"

namespace {

using pairk::kLanes;
using pairk::kTile;
using pairk::kWarps;

using forcek::Law;

// a coordinate for the blobs past N: its pairs with any blob have r^2 near
// 3e36 (finite in float32), r^-1 near 1e-18 and an exponent of -1e18 c, so
// mag is 0; two such blobs coincide and take mag = 0 as well
template <typename T>
__device__ __forceinline__ T far_coord() {
  return T(1e18);
}

template <typename T>
__device__ __forceinline__ T magnitude(const Law<T>& law, T r2) {
  return forcek::magnitude(law, r2, pairk::rsqrt_t(r2));
}

// the periodic instance's axes and image boxes: L[a] > 0 on a periodic
// axis; the offsets b L of the boxes summed, (0, 0, 0) first
constexpr int kMaxBoxes = 27;
template <typename T>
struct Boxes {
  T L[3];
  int n;
  T off[kMaxBoxes][3];
};

__device__ __forceinline__ float trunc_t(float x) { return truncf(x); }
__device__ __forceinline__ double trunc_t(double x) { return trunc(x); }

// d - trunc(d/L + sign(d)/2) L on a periodic axis (the JAX package's
// _min_image), d itself on an open one
template <typename T>
__device__ __forceinline__ T min_image(T d, T L) {
  if (!(L > T(0))) return d;
  const T half = d > T(0) ? T(0.5) : (d < T(0) ? T(-0.5) : T(0));
  return d - trunc_t(d / L + half) * L;
}

// The force of one pair, target minus source d: mag d in the open domain;
// periodic, the minimum image summed over the boxes, zero unless `live`
// (both blobs below N and not the self pair).
template <typename T, bool PERIODIC>
__device__ __forceinline__ void pair_force(const Law<T>& law,
                                           const Boxes<T>& bx, T dx, T dy,
                                           T dz, bool live, T& fx, T& fy,
                                           T& fz) {
  if (!PERIODIC) {
    const T mag = magnitude(law, dx * dx + dy * dy + dz * dz);
    fx = mag * dx;
    fy = mag * dy;
    fz = mag * dz;
    return;
  }
  dx = min_image(dx, bx.L[0]);
  dy = min_image(dy, bx.L[1]);
  dz = min_image(dz, bx.L[2]);
  fx = fy = fz = T(0);
  for (int b = 0; b < bx.n; ++b) {
    const T ex = dx + bx.off[b][0], ey = dy + bx.off[b][1],
            ez = dz + bx.off[b][2];
    const T mag = magnitude(law, ex * ex + ey * ey + ez * ez);
    fx += mag * ex;
    fy += mag * ey;
    fz += mag * ez;
  }
  if (!live) fx = fy = fz = T(0);
}

template <typename T, bool PERIODIC>
__global__ void __launch_bounds__(kTile, (pairk::Shape<T>::kMinBlocks))
force_sym_kernel(const T* __restrict__ q, T* __restrict__ ws, int n,
                 int n_groups, int tiles_per_group, Law<T> law,
                 Boxes<T> bx) {
  __shared__ __align__(16) T s_src[kTile][4];
  __shared__ T s_sum[kWarps][kTile][3];

  int ga, gb;
  pairk::group_pair(blockIdx.x, n_groups, ga, gb);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int a_begin = ga * tiles_per_group;
  const int a_end = min(n_tiles, a_begin + tiles_per_group);
  const int b_begin = gb * tiles_per_group;
  const int b_end = min(n_tiles, b_begin + tiles_per_group);
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  T* ws_a = ws + (size_t)gb * n * 3;  // target-side sums of group GA
  T* ws_b = ws + (size_t)ga * n * 3;  // source-side sums of group GB
#pragma unroll 1
  for (int t = 0; t < tiles_per_group; ++t) {
    const int ra = (a_begin + t) * kTile + threadIdx.x;
    const int rb = (b_begin + t) * kTile + threadIdx.x;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (ra < n) ws_a[(size_t)ra * 3 + c] = T(0);
      if (rb < n) ws_b[(size_t)rb * 3 + c] = T(0);
    }
  }

#pragma unroll 1
  for (int ta = a_begin; ta < a_end; ++ta) {
    const int i = ta * kTile + threadIdx.x;
    T xi = far_coord<T>(), yi = far_coord<T>(), zi = far_coord<T>();
    if (i < n) {
      xi = q[3 * i + 0];
      yi = q[3 * i + 1];
      zi = q[3 * i + 2];
    }
    T ax = T(0), ay = T(0), az = T(0);
#pragma unroll 1
    for (int tb = ga == gb ? ta : b_begin; tb < b_end; ++tb) {
      if (tb == ta) {  // the diagonal tile: every ordered pair
        __syncthreads();  // s_src may still be read for the previous tile
        s_src[threadIdx.x][0] = xi;
        s_src[threadIdx.x][1] = yi;
        s_src[threadIdx.x][2] = zi;
        __syncthreads();
        const int count = min(kTile, n - ta * kTile);
        for (int k = 0; k < count; ++k) {
          T src[4];
          pairk::load_row<4>(s_src[k], src);
          T fx, fy, fz;
          pair_force<T, PERIODIC>(law, bx, xi - src[0], yi - src[1],
                                  zi - src[2], k != threadIdx.x, fx, fy, fz);
          ax += fx;
          ay += fy;
          az += fz;
        }
        continue;
      }
      // off the diagonal: each quarter of tile b rotates through the warp
#pragma unroll 1
      for (int quarter = 0; quarter < kWarps; ++quarter) {
        const int j = tb * kTile + quarter * kLanes + lane;
        T xj = far_coord<T>(), yj = far_coord<T>(), zj = far_coord<T>();
        if (j < n) {
          xj = q[3 * j + 0];
          yj = q[3 * j + 1];
          zj = q[3 * j + 2];
        }
        T sx = T(0), sy = T(0), sz = T(0);
        const int next = (lane + 1) % kLanes;
        // after `step` shifts this lane holds the source of lane
        // (lane + step) % 32 of the quarter
        const int j0 = tb * kTile + quarter * kLanes;
#pragma unroll 4
        for (int step = 0; step < kLanes; ++step) {
          T fx, fy, fz;
          pair_force<T, PERIODIC>(
              law, bx, xi - xj, yi - yj, zi - zj,
              i < n && j0 + ((lane + step) & (kLanes - 1)) < n, fx, fy, fz);
          ax += fx;
          ay += fy;
          az += fz;
          sx -= fx;
          sy -= fy;
          sz -= fz;
          xj = __shfl_sync(0xffffffffu, xj, next);
          yj = __shfl_sync(0xffffffffu, yj, next);
          zj = __shfl_sync(0xffffffffu, zj, next);
          sx = __shfl_sync(0xffffffffu, sx, next);
          sy = __shfl_sync(0xffffffffu, sy, next);
          sz = __shfl_sync(0xffffffffu, sz, next);
        }
        T* own = s_sum[warp][quarter * kLanes + lane];
        own[0] = sx;
        own[1] = sy;
        own[2] = sz;
      }
      __syncthreads();
      pairk::add_source_sums<T, 3>(s_sum, ws_b, tb * kTile + threadIdx.x, n);
      __syncthreads();  // s_sum is refilled by the next tile pair
    }
    if (i < n) {
      ws_a[(size_t)i * 3 + 0] += ax;
      ws_a[(size_t)i * 3 + 1] += ay;
      ws_a[(size_t)i * 3 + 2] += az;
    }
  }
}

template <typename T, bool PERIODIC>
int launch(const T* q, T* out, T* ws, int n, int n_groups,
           int tiles_per_group, double eps_over_b, double c, double c2a,
           const double* L, int n_boxes, const double* off, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || ws == nullptr || n_groups < 1 || n_groups > 65535 ||
      tiles_per_group < 1 ||
      static_cast<long long>(n_groups) * tiles_per_group * kTile < n ||
      (PERIODIC && (L == nullptr || off == nullptr || n_boxes < 1 ||
                    n_boxes > kMaxBoxes)))
    return static_cast<int>(cudaErrorInvalidValue);
  Boxes<T> bx{};
  if (PERIODIC) {
    for (int a = 0; a < 3; ++a) bx.L[a] = T(L[a]);
    bx.n = n_boxes;
    for (int b = 0; b < n_boxes; ++b)
      for (int a = 0; a < 3; ++a) bx.off[b][a] = T(off[3 * b + a]);
  }
  const long long n_pairs =
      static_cast<long long>(n_groups) * (n_groups + 1) / 2;
  force_sym_kernel<T, PERIODIC>
      <<<static_cast<unsigned>(n_pairs), kTile, 0, s>>>(
          q, ws, n, n_groups, tiles_per_group,
          Law<T>{T(eps_over_b), T(c), T(c2a)}, bx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long len = 3LL * n;
  pairk::slice_sum_kernel<T>
      <<<static_cast<unsigned>((len + 255) / 256), 256, 0, s>>>(
          ws, out, n_groups, len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r (n,3), out (n,3), ws (n_groups, n, 3), all contiguous on the device;
// n > 0, groups of tiles_per_group 128-blob tiles covering n (ops/
// pair_kernels.py plan_groups); the law's eps / b, c = log2(e) / b and
// c 2a (ops/mobility_cuda.py fold_law). The periodic entry points also take
// L (3,) the box (0 on an open axis) and off (n_boxes, 3) the image boxes'
// offsets b L, host arrays. Returns the CUDA error code of the launches (0
// on success).
#define FORCE_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* r, T* out, T* ws, int n, int n_groups,        \
                      int tiles_per_group, double eps_over_b, double c,      \
                      double c2a, void* stream) {                            \
    return launch<T, false>(r, out, ws, n, n_groups, tiles_per_group,        \
                            eps_over_b, c, c2a, nullptr, 0, nullptr,         \
                            stream);                                         \
  }
#define PERIODIC_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* r, T* out, T* ws, int n, int n_groups,        \
                      int tiles_per_group, double eps_over_b, double c,      \
                      double c2a, const double* L, int n_boxes,              \
                      const double* off, void* stream) {                     \
    return launch<T, true>(r, out, ws, n, n_groups, tiles_per_group,         \
                           eps_over_b, c, c2a, L, n_boxes, off, stream);     \
  }

FORCE_ENTRY(blob_forces_f32, float)
FORCE_ENTRY(blob_forces_f64, double)
PERIODIC_ENTRY(blob_forces_periodic_f32, float)
PERIODIC_ENTRY(blob_forces_periodic_f64, double)
