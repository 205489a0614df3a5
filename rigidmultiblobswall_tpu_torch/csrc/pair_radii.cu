// Kernel P1: the square tt product of the RPY mobility with per-blob radii
// and, above a wall, the finite-size Swan-Brady image system of unequal
// radii, on B = 1 or 2 stacked right-hand sides:
//   u_i = sum_j M(r_i, r_j; a_i, a_j) v_j
// with M = rpy_tt_radii + wall_tt_radii of ops/rpy.py in physical units.
// The caller (ops/mobility_cuda.radii_matvec) shifts the heights to
// z_eff = max(z, a_i), damps v by B_jj = min(z_j / a_j, 1), and applies
// 1/(8 pi eta) and the target damping.
//
// Replaces no Pallas kernel: the JAX package runs this product as XLA
// (ops/mobility.py:540 mobility_radii_trans_times_force, the source-target
// product with sources = targets). It was added because its plain PyTorch
// version at a path's size (~1.2e9 pairs a product at 49,152 blobs) takes
// seconds a product, and a Slip-Trapz step takes some forty products.
//
// What bounds it on the H100: float32 instruction issue, as K1's sweeps
// (csrc/pair_blocks.cuh): an unordered pair costs ~180 operations to
// condense its block (the three RPY regimes ~56, the five wall terms ~124)
// into the five scalars of pairk::Diag and 36 a right-hand side to apply
// it both ways, with two rsqrt and one reciprocal; the inputs are 16 bytes
// a blob and a right-hand side's 12.
//
// Design: K1's symmetric sweep (pairk::sym_kernel) with a fourth staged
// coordinate, the radius. The block of unequal radii is reciprocal,
// M(j, i) = M(i, j)^T (the wall's terms 3 and 4 trade (a^2, z_s) for
// (b^2, z_t); tests/test_torch_radii.py holds the plain blocks to it at
// 1e-13), and it has the structure of K1's condensed tt block: an
// in-plane part A I + S d d^T, the z column P d, the z row Q d^T and the
// zz entry. So each unordered pair is condensed once and applied both
// ways by pairk::diag_apply and diag_apply_t. The three RPY regimes (far:
// r > a + b; overlapping: |b - a| < r <= a + b; one inside the other: r <=
// |b - a|, coincident blobs included) are all evaluated and selected, with
// no branch; one reciprocal of a b a pair and rsqrt of r^2 and of R^2 take
// the place of the divisions. Self pairs (r = 0) take the inside regime,
// 4 / (3 a), and the wall terms at dx = dy = 0, Rz = 2 z: the self
// mobility of the plain version. The group plan, the workspace of one
// slice a group and the fixed-order slice sum are K1's, so the product is
// bit-identical on repeat.

#include "pair_blocks.cuh"

namespace {

using pairk::Diag;
using pairk::kLanes;
using pairk::kTile;
using pairk::kWarps;
using pairk::rsqrt_t;

// resident blocks an SM that __launch_bounds__ asks for: 4 in float32 (at
// most 128 registers a thread: the condensing keeps ~40 values live beside
// the sweep's state); float64 uncapped
template <typename T>
constexpr int min_blocks() {
  return sizeof(T) == 4 ? 4 : 1;
}

// a staged row: x, y, z_eff, a and the 3B vector entries, padded to whole
// 16-byte loads
template <typename T, int B>
using Row = pairk::RowLen<T, 3 * B + 1>;

// the condensed block of (target t, source s) for d = r_t - r_s, heights
// zt, zs (shifted) and radii at, as
template <typename T, bool WALL>
__device__ __forceinline__ Diag<T> condense(T dx, T dy, T dz, T zt, T zs,
                                            T at, T as) {
  // RPY of unequal radii: c1 I + c2 d d^T
  const T xy2 = dx * dx + dy * dy;
  const T r2_raw = xy2 + dz * dz;
  const bool zero = !(r2_raw > T(0));
  const T r2 = zero ? T(1) : r2_raw;
  const T invr = rsqrt_t(r2);
  const T r = r2 * invr;
  const T invr2 = invr * invr;
  const T invr3 = invr2 * invr;
  const T at2 = at * at, as2 = as * as;
  const T s2 = at2 + as2;
  const T inv_ab = T(1) / (at * as);
  const T c1_far = (T(1) + s2 * invr2 * T(1.0 / 3.0)) * invr;
  const T c2_far = (T(1) - s2 * invr2) * invr3;
  const T sum = at + as;
  const T dif = as - at;
  const T dd2 = dif * dif;
  const T q = dd2 + T(3) * r2;
  // (4/3) ((a + b) / 2 - (dd2 + 3 r^2)^2 / (32 r^3)) / (a b)
  const T c1_mid = (T(0.5) * sum - q * q * invr3 * T(1.0 / 32.0)) *
                   (T(4.0 / 3.0) * inv_ab);
  const T w = dd2 - r2;
  // (dd2 - r^2)^2 / (8 a b r^5)
  const T c2_mid = w * w * invr3 * invr2 * (T(0.125) * inv_ab);
  // 4 / (3 max(a, b)) = (4/3) min(a, b) / (a b)
  const T c1_in = T(4.0 / 3.0) * (at < as ? at : as) * inv_ab;
  const bool far = !zero && r > sum;
  const bool mid = !zero && !far && r > (dif < T(0) ? -dif : dif);
  const T c1 = far ? c1_far : (mid ? c1_mid : c1_in);
  const T c2 = far ? c2_far : (mid ? c2_mid : T(0));
  Diag<T> m;
  m.A = c1;
  m.S = c2;
  m.P = c2 * dz;
  m.Q = m.P;
  m.mzz = c1 + c2 * dz * dz;
  if (WALL) {
    // wall_tt_radii on (dx, dy, Rz = zt + zs), x3 = zt, y3 = zs: every
    // entry is A_w delta (in plane) + S_w d d^T, P_w d (the z column), Q_w
    // d^T (the z row) and Z_w (zz); W_k = 1 / R^k
    const T Rz = zt + zs;
    const T W = rsqrt_t(Rz * Rz + xy2);
    const T u = W * W;
    const T W3 = W * u, W5 = W3 * u, W7 = W5 * u, W9 = W7 * u;
    const T Rz2 = Rz * Rz;
    const T xy3 = zt * zs;
    const T ca = T(2.0 / 3.0) * at2, cb = T(2.0 / 3.0) * as2;
    const T cab = ca * as2;
    // term 1, the image of the RPY far form
    const T t1c1 = (T(1) + s2 * u * T(1.0 / 3.0)) * W;
    const T t1c2 = (T(1) - s2 * u) * W3;
    T Aw = -t1c1, Sw = -t1c2;
    T Pw = t1c2 * Rz, Qw = -Pw;
    T Zw = t1c1 + t1c2 * Rz2;
    // term 2, the Stokes doublet and source dipole of the x3 y3 factor
    Aw -= T(2) * xy3 * W3;
    Sw += T(6) * xy3 * W5;
    const T p2 = T(6) * xy3 * Rz * W5;
    Pw += -T(2) * zt * W3 - p2;
    Qw += T(2) * zs * W3 + p2;
    Zw += T(2) * (xy3 * (W3 - T(3) * Rz2 * W5) - W - Rz * (zt + zs) * W3);
    // terms 3 and 4, the a^2 (with z_s) and b^2 (with z_t) corrections
    const T f5 = T(3) * W5, f7 = T(15) * Rz2 * W7;
    const T ga = ca * zs, gb = cb * zt;
    Aw += (ga + gb) * T(3) * Rz * W5;
    Sw -= (ga + gb) * T(15) * Rz * W7;
    Pw += ca * (f5 * Rz - zs * (f5 - f7)) - gb * (f5 - f7);
    Qw += ga * (f5 - f7) - cb * (f5 * Rz - zt * (f5 - f7));
    const T zz34 = -W3 + f5 * Rz2;
    const T zzh = T(9) * Rz * W5 - T(15) * Rz2 * Rz * W7;
    Zw += ca * (zz34 - zs * zzh) + cb * (zz34 - zt * zzh);
    // term 5, the a^2 b^2 source dipole of the image
    Aw += cab * (W5 - T(5) * Rz2 * W7);
    Sw -= cab * (T(5) * W7 - T(35) * Rz2 * W9);
    const T p5 = cab * Rz * (T(15) * W7 - T(35) * Rz2 * W9);
    Pw += p5;
    Qw -= p5;
    Zw += cab * (T(-3) * W5 + T(30) * Rz2 * W7 - T(35) * Rz2 * Rz2 * W9);
    m.A += Aw;
    m.S += Sw;
    m.P += Pw;
    m.Q += Qw;
    m.mzz += Zw;
  }
  return m;
}

// target i's share of the pair (i, j): M_ij v_j
template <typename T, int B, bool WALL>
__device__ __forceinline__ void accumulate(const T* pi, const T* pj,
                                           const T* vj, T* acc_i) {
  const T dx = pi[0] - pj[0], dy = pi[1] - pj[1], dz = pi[2] - pj[2];
  const Diag<T> m =
      condense<T, WALL>(dx, dy, dz, pi[2], pj[2], pi[3], pj[3]);
#pragma unroll
  for (int b = 0; b < B; ++b)
    pairk::diag_apply(m, dx, dy, vj + 3 * b, acc_i + 3 * b);
}

// One block: one pair of tile groups (GA, GB), GA <= GB, as
// pairk::sym_kernel, on rows (x, y, z_eff, a).
template <typename T, int B, bool WALL>
__global__ void __launch_bounds__(kTile, (min_blocks<T>()))
radii_sym_kernel(const T* __restrict__ q, const T* __restrict__ vec,
                 T* __restrict__ ws, int n, int n_groups,
                 int tiles_per_group) {
  constexpr int NV = 3 * B;
  constexpr int L = Row<T, B>::value;
  __shared__ __align__(16) T s_src[kTile][L];
  __shared__ T s_sum[kWarps][kTile][NV];

  int ga, gb;
  pairk::group_pair(blockIdx.x, n_groups, ga, gb);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int a_begin = ga * tiles_per_group;
  const int a_end = min(n_tiles, a_begin + tiles_per_group);
  const int b_begin = gb * tiles_per_group;
  const int b_end = min(n_tiles, b_begin + tiles_per_group);
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  T* ws_a = ws + (size_t)gb * n * NV;  // target-side sums of group GA
  T* ws_b = ws + (size_t)ga * n * NV;  // source-side sums of group GB
#pragma unroll 1
  for (int t = 0; t < tiles_per_group; ++t) {
    const int ra = (a_begin + t) * kTile + threadIdx.x;
    const int rb = (b_begin + t) * kTile + threadIdx.x;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (ra < n) ws_a[(size_t)ra * NV + c] = T(0);
      if (rb < n) ws_b[(size_t)rb * NV + c] = T(0);
    }
  }

#pragma unroll 1
  for (int ta = a_begin; ta < a_end; ++ta) {
    const int i = ta * kTile + threadIdx.x;
    // rows past n: far away, unit radius, zero vector
    T pi[4] = {T(0), T(0), T(1), T(1)}, vi[NV], acc[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      vi[c] = T(0);
      acc[c] = T(0);
    }
    if (i < n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) pi[c] = q[4 * i + c];
#pragma unroll
      for (int c = 0; c < NV; ++c) vi[c] = vec[(size_t)i * NV + c];
    }
#pragma unroll 1
    for (int tb = ga == gb ? ta : b_begin; tb < b_end; ++tb) {
      if (tb == ta) {  // the diagonal tile: every ordered pair, self included
        __syncthreads();  // s_src may still be read for the previous tile
        T* row = s_src[threadIdx.x];
#pragma unroll
        for (int c = 0; c < 4; ++c) row[c] = pi[c];
#pragma unroll
        for (int c = 0; c < NV; ++c) row[4 + c] = vi[c];
        __syncthreads();
        const int count = min(kTile, n - ta * kTile);
        for (int k = 0; k < count; ++k) {
          T src[L];
          pairk::load_row<L>(s_src[k], src);
          accumulate<T, B, WALL>(pi, src, src + 4, acc);
        }
        continue;
      }
      // off the diagonal: each quarter of tile b rotates through the warp
#pragma unroll 1
      for (int quarter = 0; quarter < kWarps; ++quarter) {
        const int j = tb * kTile + quarter * kLanes + lane;
        T pj[4] = {T(0), T(0), T(1), T(1)}, vj[NV], accj[NV];
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          vj[c] = T(0);
          accj[c] = T(0);
        }
        if (j < n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) pj[c] = q[4 * j + c];
#pragma unroll
          for (int c = 0; c < NV; ++c) vj[c] = vec[(size_t)j * NV + c];
        }
        const int next = (lane + 1) % kLanes;
#pragma unroll 1
        for (int step = 0; step < kLanes; ++step) {
          const T dx = pi[0] - pj[0], dy = pi[1] - pj[1], dz = pi[2] - pj[2];
          const Diag<T> m =
              condense<T, WALL>(dx, dy, dz, pi[2], pj[2], pi[3], pj[3]);
#pragma unroll
          for (int b = 0; b < B; ++b) {
            pairk::diag_apply(m, dx, dy, vj + 3 * b, acc + 3 * b);
            pairk::diag_apply_t(m, dx, dy, vi + 3 * b, accj + 3 * b);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
            pj[c] = __shfl_sync(0xffffffffu, pj[c], next);
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            vj[c] = __shfl_sync(0xffffffffu, vj[c], next);
            accj[c] = __shfl_sync(0xffffffffu, accj[c], next);
          }
        }
#pragma unroll
        for (int c = 0; c < NV; ++c)
          s_sum[warp][quarter * kLanes + lane][c] = accj[c];
      }
      __syncthreads();
      pairk::add_source_sums<T, NV>(s_sum, ws_b, tb * kTile + threadIdx.x, n);
      __syncthreads();  // s_sum is refilled by the next tile pair
    }
    if (i < n) {
#pragma unroll
      for (int c = 0; c < NV; ++c) ws_a[(size_t)i * NV + c] += acc[c];
    }
  }
}

template <typename T, int B, bool WALL>
int launch_bw(const T* q, const T* vec, T* out, T* ws, int n, int n_groups,
              int tiles_per_group, cudaStream_t s) {
  const long long n_pairs =
      static_cast<long long>(n_groups) * (n_groups + 1) / 2;
  radii_sym_kernel<T, B, WALL><<<static_cast<unsigned>(n_pairs), kTile, 0,
                                 s>>>(q, vec, ws, n, n_groups,
                                      tiles_per_group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long len = static_cast<long long>(n) * 3 * B;
  pairk::slice_sum_kernel<T>
      <<<static_cast<unsigned>((len + 255) / 256), 256, 0, s>>>(
          ws, out, n_groups, len);
  return static_cast<int>(cudaGetLastError());
}

// q (n,4) rows (x, y, z_eff, a), vec (n, 3 n_rhs) b-major columns, out
// (n, 3 n_rhs), ws (n_groups, n, 3 n_rhs); all contiguous on the device;
// n > 0, n_rhs 1 or 2, groups of tiles_per_group 128-blob tiles covering
// n. Returns the CUDA error code of the launches.
template <typename T>
int launch(const T* q, const T* vec, T* out, T* ws, int n, int n_rhs,
           int n_groups, int tiles_per_group, int wall, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || ws == nullptr || n_groups < 1 || n_groups > 65535 ||
      tiles_per_group < 1 ||
      static_cast<long long>(n_groups) * tiles_per_group * kTile < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rhs == 1)
    return wall ? launch_bw<T, 1, true>(q, vec, out, ws, n, n_groups,
                                        tiles_per_group, s)
                : launch_bw<T, 1, false>(q, vec, out, ws, n, n_groups,
                                         tiles_per_group, s);
  if (n_rhs == 2)
    return wall ? launch_bw<T, 2, true>(q, vec, out, ws, n, n_groups,
                                        tiles_per_group, s)
                : launch_bw<T, 2, false>(q, vec, out, ws, n, n_groups,
                                         tiles_per_group, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int pair_radii_sym_f32(const float* q, const float* vec,
                                  float* out, float* ws, int n, int n_rhs,
                                  int n_groups, int tiles_per_group,
                                  int wall, void* stream) {
  return launch<float>(q, vec, out, ws, n, n_rhs, n_groups, tiles_per_group,
                       wall, stream);
}

extern "C" int pair_radii_sym_f64(const double* q, const double* vec,
                                  double* out, double* ws, int n, int n_rhs,
                                  int n_groups, int tiles_per_group,
                                  int wall, void* stream) {
  return launch<double>(q, vec, out, ws, n, n_rhs, n_groups,
                        tiles_per_group, wall, stream);
}
