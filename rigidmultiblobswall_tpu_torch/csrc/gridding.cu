// Kernels G1 and G2: the spectral engines' gridding (ops/ewald.py `spread`
// and `interpolate`, which every spectral product of the package calls:
// the periodic engine, its mixed-radii groups and rank shares, the wall
// engine's merged, image and noise channels, the rollers' rot channels).
//
// G1, the spread S f: every point p adds w_x w_y w_z f_c into the P^3
// grid nodes of its window, for its C channels, into a channel-major
// (C, nxl, gy, gz) grid. G2, the interpolation S^T u: every point's row is
// the sum of w_x w_y w_z u_c over the same nodes, read from that layout in
// place. The weights are separable exponential-of-semicircle windows,
// w(d) = exp(beta (sqrt(1 - t^2) - 1)) with t = d / (P h / 2), zero where
// |d| > P h / 2, on minimum-image offsets d = node - x - L round(. / L).
// The stamps' first nodes are those of the plain version (ops/ewald.py
// `_stamps`): x from the sort-time position, round(sort_x / h) - P / 2,
// y and z from the current one, ceil(x / h - P / 2), every index modulo
// the grid. With `planes` (x0, nxl) the stamps outside those x planes are
// dropped and the x index is local to the slab. The q-th point a launch
// takes is row ids[q] of the positions, and its forces or row are row
// rows[q] of the caller's.
//
// Replaces the XLA gridding of rigidmultiblobswall_tpu/ops/ewald.py
// (`spread` and `_spread_planes`, `interpolate` and `_interp_rows`; no
// Pallas kernel there: the TPU's version is a slab layout of matmuls).
//
// What bounds it on the H100: the grid's bytes (each node written or read
// once: 201 MB at 256^3 x 3 float32 channels) and, above them, the atomic
// adds of the spread: P^3 C a point (215 M at 98,304 points, P = 9, C = 3),
// each a read-modify-write in L2. The window weights are 3 P exponentials
// a point, nothing beside the P^3 C products.
//
// Design (simple first): one warp a point, eight a block, the points in
// the order of their sort-time x (the wrapper's argsort: ids and rows),
// so the warps in flight stamp few x planes (at 98,304 image points and
// C = 18 a launch took 9.9 ms in the callers' order, 5.0 in this one).
// The warp's lanes form the point's 3 P axis weights and
// indices into shared memory, then walk its P^3 stamps z fastest, 32 at
// a time, so one warp step touches a few runs of P consecutive z nodes
// (few sectors a step). The spread adds with atomicAdd (a node's sum order
// then varies from run to run); the interpolation sums each lane's stamps
// in registers and reduces the lanes in a fixed xor tree, so repeated runs
// are bit-identical. The offsets and weights take the plain version's
// operations in its order without contraction (__fmul_rn and friends),
// so the two form the same weights and drop the same window-edge nodes.
// A launch takes CT channels of the C the caller passes (instances 3, 6,
// 9 and 18; the wrapper splits any other multiple of 3 into them).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;     // points a block, one a warp
constexpr int kMaxP = 16;     // the largest window support the kernels take

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float rint_t(float x) { return rintf(x); }
__device__ __forceinline__ double rint_t(double x) { return rint(x); }
__device__ __forceinline__ float ceil_t(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil_t(double x) { return ceil(x); }

// One grid axis: nodes, spacing, period and window half-width in the
// working type (the plain version's Python floats cast to it).
template <typename T>
struct Axis {
  int g;
  T h, L, rwin;
};

template <typename T>
struct Plan {
  Axis<T> ax[3];
  T beta;
  T half_p;     // 0.5 P
  int P, x0, nxl;
};

// The ES window of offset d, as ops/ewald.py `_es_window` forms it.
template <typename T>
__device__ __forceinline__ T window(T d, T rwin, T beta) {
  T t = d / rwin;
  t = t < T(-1) ? T(-1) : (t > T(1) ? T(1) : t);
  T a = sub_rn(T(1), mul_rn(t, t));
  a = a < T(0) ? T(0) : a;
  const T w = exp_t(mul_rn(beta, sub_rn(sqrt_t(a), T(1))));
  return (d < T(0) ? -d : d) <= rwin ? w : T(0);
}

// The warp's point p: its 3 P axis weights and node indices into the
// warp's shared rows (an x plane off the slab gets weight 0).
template <typename T>
__device__ __forceinline__ void axis_stamps(const Plan<T>& pl,
                                            const T* __restrict__ pos,
                                            const T* __restrict__ spos,
                                            long long p, unsigned lane,
                                            T (*sw)[kMaxP], int (*si)[kMaxP]) {
  const int P = pl.P;
  for (int k = lane; k < 3 * P; k += 32) {
    const int a = k >= 2 * P ? 2 : (k >= P ? 1 : 0);
    const int j = k - a * P;
    const Axis<T> ax = a == 0 ? pl.ax[0] : (a == 1 ? pl.ax[1] : pl.ax[2]);
    const T x = pos[3 * p + a];
    long long first;
    if (a == 0)   // the sort-time planes round(x / h) + (0..P-1) - P // 2
      first = static_cast<long long>(rint_t(spos[3 * p] / ax.h)) - P / 2;
    else          // every node with |d| <= P h / 2
      first = static_cast<long long>(ceil_t(sub_rn(x / ax.h, pl.half_p)));
    long long i = (first + j) % ax.g;
    if (i < 0) i += ax.g;
    T d = sub_rn(mul_rn(static_cast<T>(i), ax.h), x);
    d = sub_rn(d, mul_rn(ax.L, rint_t(d / ax.L)));
    T w = window(d, ax.rwin, pl.beta);
    int idx = static_cast<int>(i);
    if (a == 0) {
      idx -= pl.x0;
      if (idx < 0 || idx >= pl.nxl) {
        w = T(0);
        idx = 0;
      }
    }
    sw[a][j] = w;
    si[a][j] = idx;
  }
  __syncwarp();
}

// G1: grid[c][node] += w f[rows[q]][c] for the CT channels of this launch
// (grid and f already offset to its first channel; f's rows `stride`
// apart).
template <typename T, int CT>
__global__ void __launch_bounds__(kWarps * 32)
grid_spread_kernel(const T* __restrict__ pos, const T* __restrict__ spos,
                   const long long* __restrict__ ids,
                   const long long* __restrict__ rows,
                   const T* __restrict__ f, T* __restrict__ grid, int n,
                   int stride, int gy, int gz, Plan<T> pl) {
  __shared__ T sw_all[kWarps][3][kMaxP];
  __shared__ int si_all[kWarps][3][kMaxP];
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  T (*sw)[kMaxP] = sw_all[warp];
  int (*si)[kMaxP] = si_all[warp];
  const int P = pl.P, P2 = P * P, P3 = P2 * P;
  const size_t plane = static_cast<size_t>(pl.nxl) * gy * gz;
  for (long long q = static_cast<long long>(blockIdx.x) * kWarps + warp;
       q < n; q += static_cast<long long>(gridDim.x) * kWarps) {
    const long long p = ids[q], row = rows[q];
    axis_stamps(pl, pos, spos, p, lane, sw, si);
    T fv[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) fv[c] = f[row * stride + c];
    for (int k = lane; k < P3; k += 32) {
      const int i = k / P2, r = k - i * P2, j = r / P, l = r - j * P;
      const T w = mul_rn(mul_rn(sw[0][i], sw[1][j]), sw[2][l]);
      if (w == T(0)) continue;   // adds nothing (off the slab or window)
      T* node = grid + (static_cast<size_t>(si[0][i]) * gy + si[1][j]) * gz +
                si[2][l];
#pragma unroll
      for (int c = 0; c < CT; ++c)
        atomicAdd(node + c * plane, mul_rn(w, fv[c]));
    }
    __syncwarp();
  }
}

// G2: out[rows[q]][c] = sum over the stamps of w grid[c][node], each
// lane's stamps in order, then the lanes in a fixed xor tree (out already
// offset to the launch's first channel, rows `stride` apart; grid to its
// first channel).
template <typename T, int CT>
__global__ void __launch_bounds__(kWarps * 32)
grid_interp_kernel(const T* __restrict__ pos, const T* __restrict__ spos,
                   const long long* __restrict__ ids,
                   const long long* __restrict__ rows,
                   const T* __restrict__ grid, T* __restrict__ out, int n,
                   int stride, int gy, int gz, Plan<T> pl) {
  __shared__ T sw_all[kWarps][3][kMaxP];
  __shared__ int si_all[kWarps][3][kMaxP];
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  T (*sw)[kMaxP] = sw_all[warp];
  int (*si)[kMaxP] = si_all[warp];
  const int P = pl.P, P2 = P * P, P3 = P2 * P;
  const size_t plane = static_cast<size_t>(pl.nxl) * gy * gz;
  for (long long q = static_cast<long long>(blockIdx.x) * kWarps + warp;
       q < n; q += static_cast<long long>(gridDim.x) * kWarps) {
    const long long p = ids[q], row = rows[q];
    axis_stamps(pl, pos, spos, p, lane, sw, si);
    T acc[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[c] = T(0);
    for (int k = lane; k < P3; k += 32) {
      const int i = k / P2, r = k - i * P2, j = r / P, l = r - j * P;
      const T w = mul_rn(mul_rn(sw[0][i], sw[1][j]), sw[2][l]);
      if (w == T(0)) continue;
      const T* node = grid +
                      (static_cast<size_t>(si[0][i]) * gy + si[1][j]) * gz +
                      si[2][l];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[c] += w * node[c * plane];
    }
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      T v = acc[c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[c] = v;
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CT; ++c) out[row * stride + c] = acc[c];
    }
    __syncwarp();
  }
}

template <typename T>
Plan<T> make_plan(int gx, int gy, int gz, int x0, int nxl, int P, double Lx,
                  double Ly, double Lz, double beta) {
  Plan<T> pl;
  const int g[3] = {gx, gy, gz};
  const double L[3] = {Lx, Ly, Lz};
  for (int a = 0; a < 3; ++a) {
    const double h = L[a] / g[a];
    pl.ax[a] = Axis<T>{g[a], static_cast<T>(h), static_cast<T>(L[a]),
                       static_cast<T>(0.5 * P * h)};
  }
  pl.beta = static_cast<T>(beta);
  pl.half_p = static_cast<T>(0.5 * P);
  pl.P = P;
  pl.x0 = x0;
  pl.nxl = nxl;
  return pl;
}

template <typename T, int CT, bool SPREAD>
int launch(const T* pos, const T* spos, const long long* ids,
           const long long* rows, const T* src, T* dst, int n, int stride,
           int gx, int gy, int gz, int x0, int nxl, int P, double Lx,
           double Ly, double Lz, double beta, void* stream) {
  if (n <= 0) return 0;
  if (P < 1 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  const Plan<T> pl =
      make_plan<T>(gx, gy, gz, x0, nxl, P, Lx, Ly, Lz, beta);
  const long long want = (static_cast<long long>(n) + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < 65535 * 8 ? want : 65535 * 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (SPREAD)
    grid_spread_kernel<T, CT><<<blocks, kWarps * 32, 0, s>>>(
        pos, spos, ids, rows, src, dst, n, stride, gy, gz, pl);
  else
    grid_interp_kernel<T, CT><<<blocks, kWarps * 32, 0, s>>>(
        pos, spos, ids, rows, src, dst, n, stride, gy, gz, pl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (ops/_build.py SIGNATURES, ops/grid_kernels.py). Spread:
// src the forces at the launch's first channel (rows `stride` apart), dst
// the zeroed grid at that channel's plane; interpolation: src the grid at
// the first channel, dst the rows at that column. Returns the CUDA error
// code of the launch.
#define GRID_ENTRY(NAME, T, CT, SPREAD)                                       \
  extern "C" int NAME(const T* pos, const T* spos, const long long* ids,     \
                      const long long* rows, const T* src, T* dst, int n,    \
                      int stride, int gx, int gy, int gz, int x0, int nxl,   \
                      int P, double Lx, double Ly, double Lz, double beta,   \
                      void* stream) {                                        \
    return launch<T, CT, SPREAD>(pos, spos, ids, rows, src, dst, n, stride,  \
                                 gx, gy, gz, x0, nxl, P, Lx, Ly, Lz, beta,   \
                                 stream);                                    \
  }

#define GRID_ENTRIES(CT)                                  \
  GRID_ENTRY(grid_spread_f32_c##CT, float, CT, true)     \
  GRID_ENTRY(grid_spread_f64_c##CT, double, CT, true)    \
  GRID_ENTRY(grid_interp_f32_c##CT, float, CT, false)    \
  GRID_ENTRY(grid_interp_f64_c##CT, double, CT, false)

GRID_ENTRIES(3)
GRID_ENTRIES(6)
GRID_ENTRIES(9)
GRID_ENTRIES(18)
