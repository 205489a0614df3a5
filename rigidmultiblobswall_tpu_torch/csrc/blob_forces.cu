// Kernel K2: direct O(N^2) soft blob-blob repulsion,
//   F_i = sum_{j != i} mag(r_ij) (r_i - r_j),
//   mag = eps/b exp(-(r - 2a)/b) / r  for r > 2a,   eps/(b r) otherwise,
// in an open domain, and its periodic instances: d = r_i - r_j taken to
// the minimum image on each periodic axis (L > 0), then summed over the
// image boxes d + b L of a list (b in {-1, 0, 1} on the periodic axes), the
// self pair skipped in every box (its images cancel in pairs).
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/mobility_pallas.py
// (_force_kernel; wrapper blob_blob_forces_pallas) and, in its periodic
// instances, the XLA sweep of rigidmultiblobswall_tpu/ops/forces.py
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
// 0. Minimum image and box offsets are odd in d, so the periodic sum stays
// antisymmetric and the symmetric sweep holds.
//
// The pair laws (OpenPairs, BoxPairs, OneBoxPairs below):
// - BoxPairs, the image boxes: the JAX package's minimum image in its
//   truncation form d - trunc(d/L + sign(d)/2) L, by IEEE division (a
//   MUFU.RCP, its correction and a conversion an axis), then one
//   magnitude a box of the wrapper's list; the pairs of blobs past N,
//   which the minimum image folds back into the box, and the self pair are
//   masked by index;
// - OneBoxPairs, the home box alone, which the wrapper takes when
//   ops/mobility_cuda.py image_boxes has found every magnitude of every
//   other box to underflow (every pair at r >= L/2 has a zero force): the
//   minimum image d - rint(d (1/L)) L, 1/L formed once on the host and
//   rint by the round-to-nearest add of 1.5 2^23 (2^52 in float64), exact
//   for |d| < 2^22 L; the periodic axes are a template mask, so an open
//   axis (the wall slab's z) takes no minimum image. It picks another
//   image than the truncation only where d/L lies within a few ulps of a
//   half-integer, and there both images lie at r >= L/2 (1 - 2^-21 |d/L|),
//   where the magnitude is 0: the sum is the same. With an open axis, the
//   blobs past N stay far along it and no pair needs an index test.

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

__device__ __forceinline__ float trunc_t(float x) { return truncf(x); }
__device__ __forceinline__ double trunc_t(double x) { return trunc(x); }

// x rounded to the nearest integer, ties to even, by adding and taking
// away 1.5 2^23 (2^52): exact for |x| < 2^22 (2^51); two adds in place of
// a conversion (FRND runs at the MUFU's rate)
__device__ __forceinline__ float round_t(float x) {
  return __fsub_rn(__fadd_rn(x, 12582912.0f), 12582912.0f);
}
__device__ __forceinline__ double round_t(double x) {
  return __dsub_rn(__dadd_rn(x, 6755399441055744.0), 6755399441055744.0);
}

// Each pair law gives the force of one pair from the target-minus-source
// difference d; kMasked: the sweep must zero the pairs of blobs past N and
// the self pair by their index (`live`).
struct OpenPairs {
  static constexpr bool kMasked = false;
  template <typename T>
  __device__ void force(const Law<T>& law, T dx, T dy, T dz, bool,
                        T& fx, T& fy, T& fz) const {
    const T mag = magnitude(law, dx * dx + dy * dy + dz * dz);
    fx = mag * dx;
    fy = mag * dy;
    fz = mag * dz;
  }
};

// the home box alone, periodic on the axes of the mask AXES (bit a: axis
// a); without an open axis the blobs past N fold back into the box
template <typename T, int AXES>
struct OneBoxPairs {
  static constexpr bool kMasked = AXES == 7;
  T L[3], inv_L[3];
  __device__ T image(T d, int a) const {
    return ((AXES >> a) & 1) ? d - round_t(d * inv_L[a]) * L[a] : d;
  }
  __device__ void force(const Law<T>& law, T dx, T dy, T dz, bool live,
                        T& fx, T& fy, T& fz) const {
    OpenPairs().force(law, image(dx, 0), image(dy, 1), image(dz, 2), live,
                      fx, fy, fz);
    if (kMasked && !live) fx = fy = fz = T(0);
  }
};

// the image boxes: L[a] > 0 on a periodic axis; the offsets b L of the
// boxes summed, (0, 0, 0) first
constexpr int kMaxBoxes = 27;
template <typename T>
struct BoxPairs {
  static constexpr bool kMasked = true;
  T L[3];
  int n;
  T off[kMaxBoxes][3];
  // d - trunc(d/L + sign(d)/2) L on a periodic axis (the JAX package's
  // _min_image), d itself on an open one
  __device__ static T image(T d, T len) {
    if (!(len > T(0))) return d;
    const T half = d > T(0) ? T(0.5) : (d < T(0) ? T(-0.5) : T(0));
    return d - trunc_t(d / len + half) * len;
  }
  __device__ void force(const Law<T>& law, T dx, T dy, T dz, bool live,
                        T& fx, T& fy, T& fz) const {
    dx = image(dx, L[0]);
    dy = image(dy, L[1]);
    dz = image(dz, L[2]);
    fx = fy = fz = T(0);
    for (int b = 0; b < n; ++b) {
      const T ex = dx + off[b][0], ey = dy + off[b][1], ez = dz + off[b][2];
      const T mag = magnitude(law, ex * ex + ey * ey + ez * ez);
      fx += mag * ex;
      fy += mag * ey;
      fz += mag * ez;
    }
    if (!live) fx = fy = fz = T(0);
  }
};

template <typename T, typename P>
__global__ void __launch_bounds__(kTile, (pairk::Shape<T>::kMinBlocks))
force_sym_kernel(const T* __restrict__ q, T* __restrict__ ws, int n,
                 int n_groups, int tiles_per_group, Law<T> law, P pairs) {
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
          pairs.force(law, xi - src[0], yi - src[1], zi - src[2],
                      k != threadIdx.x, fx, fy, fz);
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
          pairs.force(law, xi - xj, yi - yj, zi - zj,
                      !P::kMasked ||
                          (i < n && j0 + ((lane + step) & (kLanes - 1)) < n),
                      fx, fy, fz);
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

template <typename T, typename P>
int launch(const T* q, T* out, T* ws, int n, int n_groups,
           int tiles_per_group, double eps_over_b, double c, double c2a,
           const P& pairs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || ws == nullptr || n_groups < 1 || n_groups > 65535 ||
      tiles_per_group < 1 ||
      static_cast<long long>(n_groups) * tiles_per_group * kTile < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_pairs =
      static_cast<long long>(n_groups) * (n_groups + 1) / 2;
  force_sym_kernel<T, P><<<static_cast<unsigned>(n_pairs), kTile, 0, s>>>(
      q, ws, n, n_groups, tiles_per_group,
      Law<T>{T(eps_over_b), T(c), T(c2a)}, pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long len = 3LL * n;
  pairk::slice_sum_kernel<T>
      <<<static_cast<unsigned>((len + 255) / 256), 256, 0, s>>>(
          ws, out, n_groups, len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_boxes(const T* q, T* out, T* ws, int n, int n_groups,
                 int tiles_per_group, double eps_over_b, double c, double c2a,
                 const double* L, int n_boxes, const double* off,
                 void* stream) {
  if (L == nullptr || off == nullptr || n_boxes < 1 || n_boxes > kMaxBoxes)
    return static_cast<int>(cudaErrorInvalidValue);
  BoxPairs<T> pairs{};
  for (int a = 0; a < 3; ++a) pairs.L[a] = T(L[a]);
  pairs.n = n_boxes;
  for (int b = 0; b < n_boxes; ++b)
    for (int a = 0; a < 3; ++a) pairs.off[b][a] = T(off[3 * b + a]);
  return launch<T>(q, out, ws, n, n_groups, tiles_per_group, eps_over_b, c,
                   c2a, pairs, stream);
}

template <typename T, int AXES>
int launch_one_box_axes(const T* q, T* out, T* ws, int n, int n_groups,
                        int tiles_per_group, double eps_over_b, double c,
                        double c2a, const double* L, void* stream) {
  OneBoxPairs<T, AXES> pairs{};
  for (int a = 0; a < 3; ++a) {
    pairs.L[a] = T(L[a]);
    pairs.inv_L[a] = L[a] > 0.0 ? T(1.0 / L[a]) : T(0);
  }
  return launch<T>(q, out, ws, n, n_groups, tiles_per_group, eps_over_b, c,
                   c2a, pairs, stream);
}

// the instance of the periodic axes' mask (L > 0), one of 1..7
template <typename T>
int launch_one_box(const T* q, T* out, T* ws, int n, int n_groups,
                   int tiles_per_group, double eps_over_b, double c,
                   double c2a, const double* L, void* stream) {
  if (L == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int axes = (L[0] > 0.0) | (L[1] > 0.0) << 1 | (L[2] > 0.0) << 2;
#define ONE_BOX_CASE(AXES)                                                \
  case AXES:                                                              \
    return launch_one_box_axes<T, AXES>(q, out, ws, n, n_groups,          \
                                        tiles_per_group, eps_over_b, c,   \
                                        c2a, L, stream);
  switch (axes) {
    ONE_BOX_CASE(1)
    ONE_BOX_CASE(2)
    ONE_BOX_CASE(3)
    ONE_BOX_CASE(4)
    ONE_BOX_CASE(5)
    ONE_BOX_CASE(6)
    ONE_BOX_CASE(7)
  }
#undef ONE_BOX_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r (n,3), out (n,3), ws (n_groups, n, 3), all contiguous on the device;
// n > 0, groups of tiles_per_group 128-blob tiles covering n (ops/
// pair_kernels.py plan_groups); the law's eps / b, c = log2(e) / b and
// c 2a (ops/mobility_cuda.py fold_law). The periodic entry points also take
// L (3,) the box (0 on an open axis, at least one axis periodic), a host
// array, and the image boxes' instance off (n_boxes, 3) the boxes' offsets
// b L, a host array. Returns the CUDA error code of the launches (0 on
// success).
#define FORCE_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* r, T* out, T* ws, int n, int n_groups,        \
                      int tiles_per_group, double eps_over_b, double c,      \
                      double c2a, void* stream) {                            \
    return launch<T>(r, out, ws, n, n_groups, tiles_per_group, eps_over_b,   \
                     c, c2a, OpenPairs(), stream);                           \
  }
#define PERIODIC_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* r, T* out, T* ws, int n, int n_groups,        \
                      int tiles_per_group, double eps_over_b, double c,      \
                      double c2a, const double* L, int n_boxes,              \
                      const double* off, void* stream) {                     \
    return launch_boxes<T>(r, out, ws, n, n_groups, tiles_per_group,         \
                           eps_over_b, c, c2a, L, n_boxes, off, stream);     \
  }
#define ONE_BOX_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* r, T* out, T* ws, int n, int n_groups,        \
                      int tiles_per_group, double eps_over_b, double c,      \
                      double c2a, const double* L, void* stream) {           \
    return launch_one_box<T>(r, out, ws, n, n_groups, tiles_per_group,       \
                             eps_over_b, c, c2a, L, stream);                 \
  }

FORCE_ENTRY(blob_forces_f32, float)
FORCE_ENTRY(blob_forces_f64, double)
PERIODIC_ENTRY(blob_forces_periodic_f32, float)
PERIODIC_ENTRY(blob_forces_periodic_f64, double)
ONE_BOX_ENTRY(blob_forces_one_box_f32, float)
ONE_BOX_ENTRY(blob_forces_one_box_f64, double)
