// The 27-cell walk shared by kernels K5 (nl_forces.cu, linked-cell blob
// repulsion), K6 (near_rpy.cu, near-field RPY remainder of the spectral
// engine) and K7 (wall_near.cu, the spectral wall engine's near field)
// over the fixed-capacity cell table of ops/cells.py.
//
// Replaces the TPU layout of rigidmultiblobswall_tpu/ops/cells.py: there
// every cell's 27 neighbor cells are pre-gathered once per plan into a
// (cell, 27 cap) source array padded to 128 lanes, with the periodic
// shifts folded in. Here each block walks its stencil itself: it reads the
// neighbor cells' live slots straight from the cell table and takes each
// cell's periodic shift from its cell coordinates (wrap count x box), so
// no pre-gathered copy exists.
//
// Layout (cell_bin): cell c = (cx ny + cy) nz + cz holds particle ids in
// table[c cap .. c cap + cap - 1]; the live slots are a prefix, the rest
// hold the sentinel id n. The dims are at least 4 a side (the wrapper
// checks), so the 27 stencil cells and their images are distinct. A wall
// slab (K5's wall-slab forces, K7) may have 3 or 2 z layers when its top
// layer is an empty guard: with 3 the z offsets -1, 0, +1 still name three
// distinct layers; with 2 the offsets -1 and +1 of the data layer both
// name the guard. Either way the z wrap lands only on the empty guard, so
// no pair is counted twice and no wrap shift enters a pair.
//
// Design: one block per target cell. Its live slots are the targets; the
// sources are the live slots of the 27 neighbor cells, staged through
// shared memory in tiles of kTile particles (positions, and the
// per-source vector for K6). Positions enter the pair loop in the block's
// local frame, relative to the target cell's corner: target - corner and
// source + shift - corner are formed in double and rounded once, so a
// float32 displacement carries the rounding of coordinates of a few cell
// sides, not of the box (at a 33.6 box, absolute float32 coordinates and
// their shifted images round at up to 4e-6). kLanes threads share a
// target: each sums every kLanes-th source of a tile into its own partial
// sums, then the
// lanes reduce in a fixed shuffle tree, so the result is deterministic
// and needs no atomics. One thread per target would leave most of a block
// idle at the ~20-60 targets a cell holds. The row of a target is written
// once, through its particle id; a particle dropped by overflow is in no
// cell and its row stays as the wrapper initialized it (zero).

#pragma once

#include <cuda_runtime.h>

namespace cellk {

constexpr int kThreads = 256;                 // threads per block
constexpr int kLanes = 8;                     // threads per target
constexpr int kTargets = kThreads / kLanes;   // targets per pass
constexpr int kTile = kThreads;               // sources staged per tile

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

struct Grid {
  int n;            // particles; the table's sentinel id
  int nx, ny, nz;   // cells per axis
  int cap;          // slots per cell
};

// the stencil of one target cell, in ops/cells.neighbor_table's order
// (offsets i, j, k in -1..1, i slowest; entry 13 is the cell itself)
struct Stencil {
  int cell[27];
  int start[28];        // prefix sums of the live-slot counts
  double corner[3];     // the target cell's lower corner
  double offset[27][3]; // periodic image shift of the cell's particles,
                        // less the corner
};

// Fill the stencil of cell c (all threads call; ends in a barrier).
__device__ inline void load_stencil(Stencil& st, const int* __restrict__ table,
                             int c, const Grid& g, double Lx, double Ly,
                             double Lz) {
  __shared__ int count[27];
  const int k = threadIdx.x;
  if (k < 27) {
    const int c3[3] = {c / (g.ny * g.nz), (c / g.nz) % g.ny, c % g.nz};
    const int dims[3] = {g.nx, g.ny, g.nz};
    const int off[3] = {k / 9 - 1, (k / 3) % 3 - 1, k % 3 - 1};
    const double box[3] = {Lx, Ly, Lz};
    int nb[3];
    for (int a = 0; a < 3; ++a) {
      const int raw = c3[a] + off[a];
      const int wrap = raw < 0 ? -1 : (raw >= dims[a] ? 1 : 0);
      nb[a] = raw - wrap * dims[a];
      const double corner = c3[a] * (box[a] / dims[a]);
      st.offset[k][a] = wrap * box[a] - corner;
      if (k == 13) st.corner[a] = corner;
    }
    const int cell = (nb[0] * g.ny + nb[1]) * g.nz + nb[2];
    // the live slots are a prefix: binary search for the first sentinel
    const int* row = table + static_cast<size_t>(cell) * g.cap;
    int lo = 0, hi = g.cap;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (row[mid] < g.n) lo = mid + 1; else hi = mid;
    }
    st.cell[k] = cell;
    count[k] = lo;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int j = 0; j < 27; ++j) {
      st.start[j] = acc;
      acc += count[j];
    }
    st.start[27] = acc;
  }
  __syncthreads();
}

// Sweep the block's target cell against its stencil. NF source components
// are staged per source from src_vec (n, NF) (none for NF = 0); Op
// accumulates one pair into NOUT sums: op(dx, dy, dz, s_vec, j, acc) with
// d = target - source image and s_vec[c][j] the staged component c of
// source j. Writes out (n, NOUT).
template <typename T, int NF, int NOUT, typename Op>
__device__ void cell_sweep(const Stencil& st,
                           const int* __restrict__ table,
                           const T* __restrict__ pos,
                           const T* __restrict__ src_vec,
                           T* __restrict__ out, const Grid& g, const Op& op) {
  __shared__ T s_pos[3][kTile];
  __shared__ T s_vec[NF > 0 ? NF : 1][kTile];
  const int* own = table + static_cast<size_t>(st.cell[13]) * g.cap;
  const int n_tgt = st.start[14] - st.start[13];
  const int total = st.start[27];
  const int t_local = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  for (int t0 = 0; t0 < n_tgt; t0 += kTargets) {
    const int ti = t0 + t_local;
    const bool active = ti < n_tgt;
    int tid = 0;
    T tx = T(0), ty = T(0), tz = T(0);
    if (active) {
      tid = own[ti];
      tx = T(double(pos[3 * tid + 0]) - st.corner[0]);
      ty = T(double(pos[3 * tid + 1]) - st.corner[1]);
      tz = T(double(pos[3 * tid + 2]) - st.corner[2]);
    }
    T acc[NOUT];
    for (int c = 0; c < NOUT; ++c) acc[c] = T(0);
    for (int s0 = 0; s0 < total; s0 += kTile) {
      const int s = s0 + threadIdx.x;
      if (s < total) {
        int k = 0;
        while (st.start[k + 1] <= s) ++k;
        const int sid = table[static_cast<size_t>(st.cell[k]) * g.cap +
                              (s - st.start[k])];
        for (int a = 0; a < 3; ++a)
          s_pos[a][threadIdx.x] =
              T(double(pos[3 * sid + a]) + st.offset[k][a]);
        for (int c = 0; c < NF; ++c)
          s_vec[c][threadIdx.x] = src_vec[static_cast<size_t>(NF) * sid + c];
      }
      __syncthreads();
      if (active) {
        // per-tile partial sums keep the f32 rounding of long sums down
        T part[NOUT];
        for (int c = 0; c < NOUT; ++c) part[c] = T(0);
        const int m = min(kTile, total - s0);
        for (int j = lane; j < m; j += kLanes)
          op(tx - s_pos[0][j], ty - s_pos[1][j], tz - s_pos[2][j], s_vec, j,
             part);
        for (int c = 0; c < NOUT; ++c) acc[c] += part[c];
      }
      __syncthreads();
    }
    // the kLanes lanes of a target sit in one warp: a fixed xor tree
    for (int c = 0; c < NOUT; ++c) {
      T v = acc[c];
      for (int o = kLanes / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[c] = v;
    }
    if (active && lane == 0)
      for (int c = 0; c < NOUT; ++c)
        out[static_cast<size_t>(NOUT) * tid + c] = acc[c];
  }
}

}  // namespace cellk
