// The 27-cell walk shared by kernels K5 (nl_forces.cu, linked-cell blob
// repulsion), K6 (near_rpy.cu, near-field RPY remainder of the spectral
// engine), K7 (wall_near.cu, the spectral wall engine's near field) and
// K8 (wall_rot_near.cu, its rot couplings) over the fixed-capacity cell
// table of ops/cells.py.
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
// slab (K5's wall-slab forces, K7, K8) may have 3 or 2 z layers when its top
// layer is an empty guard: with 3 the z offsets -1, 0, +1 still name three
// distinct layers; with 2 the offsets -1 and +1 of the data layer both
// name the guard. Either way the z wrap lands only on the empty guard, so
// no pair is counted twice and no wrap shift enters a pair.
//
// The pieces every kernel of the walk takes: one block per target cell
// (load_stencil); its stencil's sources staged once into shared memory in
// tiles (stage_sources: the block's warps walk the 27 cells, so no source
// searches for its cell), and the cell's targets in chunks of kTgt
// (stage_targets), both in the block's local frame, relative to the target
// cell's corner: target - corner and source + shift - corner are formed in
// double and rounded once, so a float32 displacement carries the rounding
// of coordinates of a few cell sides, not of the box (at a 33.6 box,
// absolute float32 coordinates and their shifted images round at up to
// 4e-6). K6, K7 and K8 then filter the candidates a warp-step at a time
// (candidate), queue the pairs inside r_cut into rings in shared memory
// (append), and evaluate the RPY remainder of a pair (Remainder) from a
// two-piece Chebyshev table staged as rows that one 16-byte load reads
// (stage_cheb); K7 walks a staged tile in the stencil's order
// (compacted_walk), K8 with its real and image sources staged apart
// (split_reals, stage_split, split_walk), each with its own pair
// evaluations.
// A particle dropped by overflow is in no cell and its row stays as the
// wrapper initialized it (zero).

#pragma once

#include <cuda_runtime.h>

namespace cellk {

constexpr int kThreads = 256;   // the most threads a block of the walk has
constexpr int kTgt = 128;       // targets a block stages at a time
constexpr int kMaxCheb = 32;    // Chebyshev terms per piece of a table
// shared-memory rows of a remainder table: the (a_k, b_k) pairs of a piece,
// padded so that a piece starts on 16 bytes and the two pieces' rows of one
// k fall in different banks
constexpr int kChebPiece = 2 * kMaxCheb + 4;

__device__ __forceinline__ float rsqrt_t(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// sources a kernel's block stages a tile, in float32 and in float64
template <typename T, int F32, int F64>
struct Walk {
  static constexpr int kSrc = sizeof(T) == 4 ? F32 : F64;
};

// target rows a block stages at a time: a cell holds at most cap
__host__ __device__ __forceinline__ int target_slots(int cap) {
  return cap < kTgt ? cap : kTgt;
}

// resident blocks an SM that a kernel's __launch_bounds__ asks for: f32 in
// float32, uncapped in float64 (off the hot paths)
template <typename T>
constexpr int min_blocks(int f32) {
  return sizeof(T) == 8 ? 1 : f32;
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// L values from 16-byte shared-memory loads (L a multiple of 16 bytes)
template <int L>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
#pragma unroll
  for (int c = 0; c < L; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + c);
    dst[c] = v.x;
    dst[c + 1] = v.y;
    dst[c + 2] = v.z;
    dst[c + 3] = v.w;
  }
}
template <int L>
__device__ __forceinline__ void load_vec(const double* src, double* dst) {
#pragma unroll
  for (int c = 0; c < L; c += 2) {
    const double2 v = *reinterpret_cast<const double2*>(src + c);
    dst[c] = v.x;
    dst[c + 1] = v.y;
  }
}

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

// Whether cell c holds no particle (its first slot holds the sentinel):
// a block of such a target cell returns before it loads its stencil.
__device__ __forceinline__ bool empty_cell(const int* __restrict__ table,
                                           int c, const Grid& g) {
  return table[static_cast<size_t>(c) * g.cap] >= g.n;
}

// The count of the prefix of row[0 .. n) whose ids are below `bound` (the
// ids ascend), by an 8-ary search of a group of 8 threads (member 0..7 of
// the group, whose lanes `group` masks): a round loads 8 sample slots in
// parallel and narrows the interval eightfold, so a cap of 64 takes two
// dependent rounds of loads where a binary search takes seven.
__device__ __forceinline__ int prefix_below(const int* __restrict__ row,
                                            int n, int bound, int member,
                                            unsigned group) {
  // slots below lo are in the prefix, slots from hi on are not; lo and hi
  // are uniform across the group
  int lo = 0, hi = n;
  while (lo < hi) {
    const int step = (hi - lo + 7) / 8;
    const int p = lo + member * step;
    const bool in = p < hi && row[p] < bound;
    // the samples in the prefix are a prefix of the group's
    const int n_in = __popc(__ballot_sync(group, in));
    hi = min(hi, lo + n_in * step);
    if (n_in > 0) lo += (n_in - 1) * step + 1;
  }
  return lo;
}

// start[0 .. 27] = the exclusive prefix sums of count[0 .. 26] (the first
// warp scans; the caller's barriers bracket it).
__device__ __forceinline__ void scan27(const int* count, int* start) {
  if (threadIdx.x < 32) {   // an inclusive scan of the counts
    const int lane = threadIdx.x;
    int v = lane < 27 ? count[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane < 27) start[lane + 1] = v;
    if (lane == 0) start[0] = 0;
  }
}

// The cell frame of a box with open axes (K5's open instance): the cells
// of axis a start at lo[a] with the edge cs[a]; L[a] > 0 wraps the axis
// as a periodic box does (lo 0, cs L / n), L[a] == 0 leaves it open, and
// its stencil stops at the grid's edges: a neighbor cell past an open
// edge holds no source (the JAX package's forces.py:214-231 masks it)
// and its particles take no image shift.
struct Frame {
  double lo[3], cs[3], L[3];
};

// Fill the stencil of cell c in the frame f (all threads call; ends in a
// barrier). Each stencil cell's count of live slots (a prefix) comes from
// prefix_below, one group of 8 threads a cell; a cell past an open edge
// counts none.
__device__ inline void load_stencil(Stencil& st,
                                    const int* __restrict__ table, int c,
                                    const Grid& g, const Frame& f) {
  __shared__ int count[27];
  const int member = threadIdx.x % 8;
  const unsigned group = 0xffu << (threadIdx.x % 32 / 8 * 8);
  for (int k = threadIdx.x / 8; k < 27; k += blockDim.x / 8) {
    const int c3[3] = {c / (g.ny * g.nz), (c / g.nz) % g.ny, c % g.nz};
    const int dims[3] = {g.nx, g.ny, g.nz};
    const int off[3] = {k / 9 - 1, (k / 3) % 3 - 1, k % 3 - 1};
    int nb[3];
    bool inside = true;   // uniform across the group of the cell k
    for (int a = 0; a < 3; ++a) {
      const int raw = c3[a] + off[a];
      const double corner = f.lo[a] + c3[a] * f.cs[a];
      double shift = 0.0;
      if (f.L[a] > 0.0) {
        const int wrap = raw < 0 ? -1 : (raw >= dims[a] ? 1 : 0);
        nb[a] = raw - wrap * dims[a];
        shift = wrap * f.L[a];
      } else {
        inside = inside && raw >= 0 && raw < dims[a];
        nb[a] = min(max(raw, 0), dims[a] - 1);
      }
      if (member == 0) st.offset[k][a] = shift - corner;
      if (member == 0 && k == 13) st.corner[a] = corner;
    }
    const int cell = (nb[0] * g.ny + nb[1]) * g.nz + nb[2];
    const int lo = inside ? prefix_below(table + static_cast<size_t>(cell) *
                                                     g.cap,
                                         g.cap, g.n, member, group)
                          : 0;
    if (member == 0) {
      st.cell[k] = cell;
      count[k] = lo;
    }
  }
  __syncthreads();
  scan27(count, st.start);
  __syncthreads();
}

// load_stencil in the periodic box of lengths Lx, Ly, Lz (cells of edge
// L / n from 0)
__device__ inline void load_stencil(Stencil& st,
                                    const int* __restrict__ table, int c,
                                    const Grid& g, double Lx, double Ly,
                                    double Lz) {
  const Frame f{{0.0, 0.0, 0.0}, {Lx / g.nx, Ly / g.ny, Lz / g.nz},
                {Lx, Ly, Lz}};
  load_stencil(st, table, c, g, f);
}

// The real particles (ids below n_real) of each stencil cell: a prefix of
// its live slots (cell_bin keeps a cell's ids ascending, and the reals are
// the ids below n_real). start_r[0 .. 27] receives their prefix sums over
// the stencil (all threads call, after load_stencil; ends in a barrier).
__device__ inline void split_reals(const Stencil& st,
                                   const int* __restrict__ table,
                                   const Grid& g, int n_real, int* start_r) {
  __shared__ int count[27];
  const int member = threadIdx.x % 8;
  const unsigned group = 0xffu << (threadIdx.x % 32 / 8 * 8);
  for (int k = threadIdx.x / 8; k < 27; k += blockDim.x / 8) {
    const int n = prefix_below(
        table + static_cast<size_t>(st.cell[k]) * g.cap,
        st.start[k + 1] - st.start[k], n_real, member, group);
    if (member == 0) count[k] = n;
  }
  __syncthreads();
  scan27(count, start_r);
  __syncthreads();
}

// Stage the sources s0 .. s0 + m - 1 of the stencil (in its order):
// put(s, id, k) receives tile slot s, the particle id and its stencil cell
// k. Warp w of the block walks the stencil cells k = w, w + warps, ..., its
// lanes the cell's live slots inside the window, so no source searches for
// its cell. No barrier: the caller ends the staging with one.
template <typename Put>
__device__ __forceinline__ void stage_sources(const Stencil& st,
                                              const int* __restrict__ table,
                                              const Grid& g, int s0, int m,
                                              const Put& put) {
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32;
  for (int k = threadIdx.x / 32; k < 27; k += warps) {
    const int first = st.start[k];
    const int lo = max(first, s0), hi = min(st.start[k + 1], s0 + m);
    const int* ids = table + static_cast<size_t>(st.cell[k]) * g.cap;
    for (int s = lo + lane; s < hi; s += 32) put(s - s0, ids[s - first], k);
  }
}

// stage_sources in the split order of split_reals: the stencil's real
// sources first (in the stencil's order), then its image sources, so that
// slot s of the stencil's nr = start_r[27] real sources and image slot
// nr + i follow the stencil's cells. Stages the window s0 .. s0 + m - 1
// of that order; no barrier.
template <typename Put>
__device__ __forceinline__ void stage_split(const Stencil& st,
                                            const int* start_r,
                                            const int* __restrict__ table,
                                            const Grid& g, int s0, int m,
                                            const Put& put) {
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32;
  const int nr = start_r[27];
  for (int k = threadIdx.x / 32; k < 27; k += warps) {
    const int* ids = table + static_cast<size_t>(st.cell[k]) * g.cap;
    const int r0 = start_r[k], n_r = start_r[k + 1] - r0;
    const int i0 = nr + st.start[k] - r0;         // the cell's first image
    const int n_i = st.start[k + 1] - st.start[k] - n_r;
    for (int s = max(0, s0 - r0) + lane; s < min(n_r, s0 + m - r0); s += 32)
      put(r0 + s - s0, ids[s], k);
    for (int s = max(0, s0 - i0) + lane; s < min(n_i, s0 + m - i0); s += 32)
      put(i0 + s - s0, ids[n_r + s], k);
  }
}

// A source's position in the block's local frame: rounded once from
// position + shift - corner in double.
template <typename T>
__device__ __forceinline__ void local_source(const Stencil& st,
                                             const T* __restrict__ pos,
                                             int id, int k, T* row) {
  for (int a = 0; a < 3; ++a)
    row[a] = T(double(pos[3 * id + a]) + st.offset[k][a]);
}

// Stage nt targets (ids own[0 .. nt - 1]) as rows (x, y, z, 0) in the local
// frame and their ids. No barrier.
template <typename T>
__device__ __forceinline__ void stage_targets(const Stencil& st,
                                              const int* __restrict__ own,
                                              int nt,
                                              const T* __restrict__ pos,
                                              T* rows, int* ids) {
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    const int id = own[t];
    for (int a = 0; a < 3; ++a)
      rows[4 * t + a] = T(double(pos[3 * id + a]) - st.corner[a]);
    rows[4 * t + 3] = T(0);
    ids[t] = id;
  }
}

// A coordinate for the rows that pad a staged tile: its pairs with any
// particle have r^2 near 3e36 (finite in float32), so they never lie
// inside r_cut, and K5's law gives them magnitude 0.
template <typename T>
__device__ __forceinline__ T far_coord() {
  return T(1e18);
}

// Fill rows m .. pad - 1 of a staged tile (x, y, z, w) with far rows, so
// that a warp-step over a whole group of candidates needs no bounds test.
// No barrier.
template <typename T>
__device__ __forceinline__ void pad_rows(T* rows, int m, int pad) {
  for (int s = m + threadIdx.x; s < pad; s += blockDim.x)
    for (int a = 0; a < 4; ++a) rows[4 * s + a] = far_coord<T>();
}

// Whether candidate j of the staged rows (x, y, z, w) lies inside r_cut of
// the target (0 < r^2 < rc2; a far row never does); src receives its row.
template <typename T>
__device__ __forceinline__ bool candidate(const T* rows, int j, T tx, T ty,
                                          T tz, T rc2, T* src) {
  load_vec<4>(rows + 4 * j, src);
  const T dx = tx - src[0], dy = ty - src[1], dz = tz - src[2];
  const T r2 = dx * dx + dy * dy + dz * dz;
  return r2 > T(0) && r2 < rc2;
}

// A ring's slots in shared memory: R (a power of two), then one scratch
// slot a lane that takes the stores of the lanes that append nothing, so
// an append has no branch.
template <int R>
__host__ __device__ constexpr int ring_slots() {
  return R + 32;
}

// Append `value` of every lane that keeps one to a warp's ring of R slots
// (ring_slots<R>() in memory) at `tail`, in lane order (below: the mask of
// the lanes before this one); the other lanes store into their scratch
// slots. Returns the new tail, uniform across the warp.
template <int R, typename E>
__device__ __forceinline__ unsigned append(E* ring, unsigned tail, bool keep,
                                           E value, unsigned below) {
  const unsigned mask = __ballot_sync(0xffffffffu, keep);
  const unsigned slot = (tail + __popc(mask & below)) % R;
  ring[keep ? slot : R + threadIdx.x % 32] = value;
  return tail + __popc(mask);
}

// Whether candidate j of the staged rows lies inside r_cut of the target,
// as a real-source or an image-source pair of the wall engine's combined
// set (the row's w holds the source's physical z, negative at an image; a
// far row is neither). K7.
template <typename T>
__device__ __forceinline__ void classify(const T* rows, int j, T tx, T ty,
                                         T tz, T rc2, bool& in_r,
                                         bool& in_i) {
  T src[4];
  const bool in = candidate(rows, j, tx, ty, tz, rc2, src);
  const bool image = in && src[3] < T(0);
  in_r = in && !image;
  in_i = image;
}

// One batch of `count` (<= 32) image-ring entries (target << 16 | source)
// of a warp's ring of R slots, lane k taking entry k: image(te, j, u)
// evaluates source j against staged target te into u[NO] (zeroed). The
// entries come in target order, so the batch holds runs of one target
// each: every run is summed in a fixed xor tree and added into its
// target's row of out (STRIDE values a row, at out + STRIDE ids[te]) by
// lane 0.
template <int R, int NO, int STRIDE, typename T, typename Image>
__device__ __forceinline__ void drain_images(const unsigned* ring,
                                             unsigned head, unsigned count,
                                             unsigned lane, const int* ids,
                                             T* out, const Image& image) {
  T u[NO];
#pragma unroll
  for (int q = 0; q < NO; ++q) u[q] = T(0);
  int te = -1;
  if (lane < count) {
    const unsigned e = ring[(head + lane) % R];
    te = static_cast<int>(e >> 16);
    image(te, static_cast<int>(e & 0xffffu), u);
  }
  unsigned pending = __ballot_sync(0xffffffffu, lane < count);
  while (pending) {
    const int t0 = __shfl_sync(0xffffffffu, te, __ffs(pending) - 1);
    const bool mine = te == t0;
    pending &= ~__ballot_sync(0xffffffffu, mine);
    T* row = out + static_cast<size_t>(STRIDE) * ids[t0];
#pragma unroll
    for (int q = 0; q < NO; ++q) {
      T v = mine ? u[q] : T(0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) row[q] += v;
    }
  }
}

// The compacted walk of K7 over one staged tile of m sources (rows
// (x, y, z, physical z) padded with far rows to whole 64-steps) for the nt
// staged targets (tgt (nt, 4), ids their particle ids). A warp takes its
// targets one at a time (t = warp, warp + warps, ...), tests 64
// candidates a step as two independent halves of 32 and appends the pairs
// inside r_cut, with ballot and popc prefixes, in the stencil's order to
// two rings of R slots (ring_slots<R>() in memory): the target's
// real-source pairs (real(j, tgt, acc) into the lane's own sums acc[NO])
// and the warp's image-source pairs, which carry their target and run on
// across the warp's targets (image(te, j, u), drained by drain_images).
// Whenever a ring holds 32 pairs the warp evaluates them with every lane
// busy; the real ring's partial batch runs after the target's last step,
// then the lanes reduce in a fixed xor tree and lane 0 adds the row; the
// image ring's partial batch drains after the warp's last target. Each
// row belongs to one warp at a time; every order depends only on the
// data: no atomics, bit-identical on repeat. No barrier.
template <int R, int NO, typename T, typename Real, typename Image>
__device__ __forceinline__ void compacted_walk(
    const T* src_rows, const T* tgt_rows, const int* ids, int m, int nt,
    T rc2, unsigned short* ring_r, unsigned* ring_i, T* out, const Real& real,
    const Image& image) {
  const int warps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  const unsigned lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  // ring heads and tails are uniform across the warp; the image ring
  // carries over from one of the warp's targets to the next
  unsigned i_head = 0, i_tail = 0;
  // one pass past the warp's last target flushes the image ring (one call
  // site per ring keeps each evaluation's code once in the instruction
  // cache)
  for (int t = warp;; t += warps) {
    const bool done = t >= nt;
    const int mt = done ? 0 : m;
    T tgt[4] = {T(0), T(0), T(0), T(0)};
    if (!done) load_vec<4>(tgt_rows + 4 * t, tgt);
    T acc[NO];
#pragma unroll
    for (int q = 0; q < NO; ++q) acc[q] = T(0);
    unsigned r_head = 0, r_tail = 0;
    // 64 candidates a step, as two independent halves; one step past the
    // tile drains the real ring's last partial batch
    for (int c0 = 0;; c0 += 64) {
      const bool last = c0 >= mt;
      if (!last) {
        bool ra, ia, rb, ib;
        classify(src_rows, c0 + lane, tgt[0], tgt[1], tgt[2], rc2, ra, ia);
        classify(src_rows, c0 + 32 + lane, tgt[0], tgt[1], tgt[2], rc2, rb,
                 ib);
        const unsigned key = static_cast<unsigned>(t) << 16;
        using u16 = unsigned short;
        r_tail = append<R>(ring_r, r_tail, ra, u16(c0 + lane), below);
        i_tail = append<R>(ring_i, i_tail, ia, key | (c0 + lane), below);
        r_tail = append<R>(ring_r, r_tail, rb, u16(c0 + 32 + lane), below);
        i_tail = append<R>(ring_i, i_tail, ib, key | (c0 + 32 + lane),
                           below);
        __syncwarp();
      }
      // full batches of the real ring, lane k on entry k into its own
      // sums; after the target's last step its partial batch
      for (;;) {
        const unsigned nr = r_tail - r_head;
        if (nr < 32 && !(last && nr > 0)) break;
        if (lane < nr) real(int(ring_r[(r_head + lane) % R]), tgt, acc);
        r_head += min(nr, 32u);
      }
      // full batches of the image ring; its partial batch once the warp's
      // targets are done
      for (;;) {
        const unsigned ni = i_tail - i_head;
        if (ni < 32 && !(done && ni > 0)) break;
        drain_images<R, NO, NO>(ring_i, i_head, min(ni, 32u), lane, ids,
                                out, image);
        i_head += min(ni, 32u);
      }
      __syncwarp();   // drained slots are read before they are refilled
      if (last) break;
    }
    if (done) break;
    // the real sources' sums: a fixed xor tree over the warp's 32 lanes
#pragma unroll
    for (int q = 0; q < NO; ++q) {
      T v = acc[q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[q] = v;
    }
    if (lane == 0) {
      T* row = out + static_cast<size_t>(NO) * ids[t];
      for (int q = 0; q < NO; ++q) row[q] += acc[q];
    }
  }
}

// Whether candidate j of the staged rows lies inside r_cut of the target
// (tgt: x, y, z) and, for a real part (REAL), whether it is a real source
// (physical z > 0: the rows past a real part hold images or far rows).
template <bool REAL, typename T>
__device__ __forceinline__ bool in_part(const T* rows, int j, const T* tgt,
                                        T rc2) {
  T src[4];
  const bool in = candidate(rows, j, tgt[0], tgt[1], tgt[2], rc2, src);
  return REAL ? in && src[3] > T(0) : in;
}

// The split walk of K8 over one staged tile of m sources in the order of
// stage_split: rows [0, re) real sources, rows [re, m) image sources (rows
// (x, y, z, physical z), far rows past m up to whole 64-steps of each
// part: split_pad), for the nt staged targets (tgt (nt, 4), ids their
// particle ids). A warp takes its targets one at a time (t = warp, warp +
// warps, ...) and walks each part 64 candidates a step, as two
// independent halves of 32, appending the pairs inside r_cut, with ballot
// and popc prefixes, to the part's ring of R slots (ring_slots<R>() in
// memory): over the real part the target's real-source pairs (real(j,
// tgt, acc) into the lane's own sums acc[NO]), over the image part the
// warp's image-source pairs, which carry their target and run on across
// the warp's targets (image(te, j, u), drained by drain_images). A step
// appends to one ring and tests no kind. Whenever a ring holds 32 pairs
// the warp evaluates them with every lane busy; the real ring's partial
// batch runs after the real part, then the lanes reduce in a fixed xor
// tree and lane 0 adds the row; the image ring's partial batch drains
// after the warp's last target. A row holds STRIDE values, the walk's NO
// from out on. Each row belongs to one warp at a time; every order
// depends only on the data: no atomics, bit-identical on repeat. No
// barrier.
template <int R, int NO, int STRIDE, typename T, typename Real,
          typename Image>
__device__ __forceinline__ void split_walk(
    const T* src_rows, const T* tgt_rows, const int* ids, int m, int re,
    int nt, T rc2, unsigned short* ring_r, unsigned* ring_i, T* out,
    const Real& real, const Image& image) {
  using u16 = unsigned short;
  const int warps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  const unsigned lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  // the image ring's head and tail are uniform across the warp and carry
  // over from one of its targets to the next
  unsigned i_head = 0, i_tail = 0;
  // one pass past the warp's last target flushes the image ring (one call
  // site per ring keeps each evaluation's code once in the instruction
  // cache)
  for (int t = warp;; t += warps) {
    const bool done = t >= nt;
    T tgt[4] = {T(0), T(0), T(0), T(0)};
    if (!done) load_vec<4>(tgt_rows + 4 * t, tgt);
    T acc[NO];
#pragma unroll
    for (int q = 0; q < NO; ++q) acc[q] = T(0);
    // the real part; one step past it drains the real ring's partial batch
    unsigned r_head = 0, r_tail = 0;
    const int r_end = done ? 0 : re;
    for (int c0 = 0;; c0 += 64) {
      const bool last = c0 >= r_end;
      if (!last) {
        const bool a = in_part<true>(src_rows, c0 + lane, tgt, rc2);
        const bool b = in_part<true>(src_rows, c0 + 32 + lane, tgt, rc2);
        r_tail = append<R>(ring_r, r_tail, a, u16(c0 + lane), below);
        r_tail = append<R>(ring_r, r_tail, b, u16(c0 + 32 + lane), below);
        __syncwarp();
      }
      for (;;) {
        const unsigned nr = r_tail - r_head;
        if (nr < 32 && !(last && nr > 0)) break;
        if (lane < nr) real(int(ring_r[(r_head + lane) % R]), tgt, acc);
        r_head += min(nr, 32u);
      }
      __syncwarp();   // drained slots are read before they are refilled
      if (last) break;
    }
    if (!done) {
      // the real sources' sums: a fixed xor tree over the warp's 32 lanes
#pragma unroll
      for (int q = 0; q < NO; ++q) {
        T v = acc[q];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        acc[q] = v;
      }
      if (lane == 0) {
        T* row = out + static_cast<size_t>(STRIDE) * ids[t];
        for (int q = 0; q < NO; ++q) row[q] += acc[q];
      }
    }
    // the image part; past the warp's last target its partial batch
    const int i_end = done ? re : m;
    const unsigned key = static_cast<unsigned>(t) << 16;
    for (int c0 = re;; c0 += 64) {
      const bool last = c0 >= i_end;
      if (!last) {
        const bool a = in_part<false>(src_rows, c0 + lane, tgt, rc2);
        const bool b = in_part<false>(src_rows, c0 + 32 + lane, tgt, rc2);
        i_tail = append<R>(ring_i, i_tail, a, key | (c0 + lane), below);
        i_tail = append<R>(ring_i, i_tail, b, key | (c0 + 32 + lane),
                           below);
        __syncwarp();
      }
      for (;;) {
        const unsigned ni = i_tail - i_head;
        if (ni < 32 && !(done && ni > 0)) break;
        drain_images<R, NO, STRIDE>(ring_i, i_head, min(ni, 32u), lane, ids,
                                    out, image);
        i_head += min(ni, 32u);
      }
      __syncwarp();
      if (last) break;
    }
    if (done) break;
  }
}

// The rows a split tile pads to: whole 64-steps of its real part [0, re)
// and of its image part [re, m).
__host__ __device__ __forceinline__ int split_pad(int m, int re) {
  const int r_pad = (re + 63) / 64 * 64;
  const int i_pad = re + (m - re + 63) / 64 * 64;
  return r_pad > i_pad ? r_pad : i_pad;
}

// Terms of a staged remainder table: K rounded up to even (the padding
// coefficient is zero, and a Clenshaw step on zeros leaves zeros).
__host__ __device__ __forceinline__ int even_terms(int K) {
  return K + (K & 1);
}

// Stage the remainder's table cheb (2 pieces, 2 functions, K) as rows
// (piece, k, function), zero-padded to even_terms(K) terms. No barrier.
template <typename T>
__device__ __forceinline__ void stage_cheb(const T* __restrict__ cheb, int K,
                                           T* rows) {
  const int K2 = even_terms(K);
  for (int i = threadIdx.x; i < 4 * K2; i += blockDim.x) {
    const int p = i / (2 * K2), k = (i / 2) % K2, fn = i % 2;
    rows[p * kChebPiece + 2 * k + fn] =
        k < K ? cheb[(2 * p + fn) * K + k] : T(0);
  }
}

// The two K2-term Chebyshev series of a staged piece (rows (a_k, b_k),
// a_k+1, b_k+1 in one 16-byte load in float32, two in float64) at ts in
// [-1, 1]: al = sum a_k T_k(ts), be = sum b_k T_k(ts). A step is fma(t2,
// b1, c - b2): c - b2 is known a step ahead, so the recurrence's dependent
// chain is one multiply-add a term.
template <typename T>
__device__ __forceinline__ void series2(const T* ab, int K2, T ts, T& al,
                                        T& be) {
  const T t2 = ts + ts;
  T a1 = T(0), a2 = T(0), b1 = T(0), b2 = T(0);
  T c[4];
  for (int k = K2 - 2; k > 0; k -= 2) {
    load_vec<4>(ab + 2 * k, c);
    T an = fma_t(t2, a1, c[2] - a2);
    T bn = fma_t(t2, b1, c[3] - b2);
    a2 = a1;
    a1 = an;
    b2 = b1;
    b1 = bn;
    an = fma_t(t2, a1, c[0] - a2);
    bn = fma_t(t2, b1, c[1] - b2);
    a2 = a1;
    a1 = an;
    b2 = b1;
    b1 = bn;
  }
  load_vec<4>(ab, c);
  const T an = fma_t(t2, a1, c[2] - a2);
  const T bn = fma_t(t2, b1, c[3] - b2);
  al = fma_t(ts, an, c[0] - a1);
  be = fma_t(ts, bn, c[1] - b1);
}

// The RPY remainder's two-piece Chebyshev series: piece 0 on r < 2a,
// piece 1 on 2a <= r < r_cut, t = (r - mid) / half in [-1, 1]. The piece
// is an address, not a branch; (a_k, b_k, a_k+1, b_k+1) come in one
// 16-byte load in float32 (two in float64).
template <typename T>
struct Remainder {
  int K2;                                     // even_terms(K)
  T rc2, two_a, mid0, inv_h0, mid1, inv_h1;

  // alpha(r) and beta(r) / r^2 at r (invr = 1 / r), from the staged rows
  __device__ __forceinline__ void eval(const T* cheb, T r, T invr, T& al,
                                       T& bfac) const {
    const bool near = r < two_a;
    const T* ab = cheb + (near ? 0 : kChebPiece);
    const T ts = near ? (r - mid0) * inv_h0 : (r - mid1) * inv_h1;
    T be;
    series2(ab, K2, ts, al, be);
    bfac = be * invr * invr;
  }
};

// (mid, 1 / half) of the two pieces: piece 0 mid = half = a; piece 1
// mid = (2a + r_cut) / 2, half = (r_cut - 2a) / 2
template <typename T>
Remainder<T> make_remainder(int K, double two_a, double r_cut) {
  return Remainder<T>{even_terms(K),          T(r_cut * r_cut),
                      T(two_a),               T(0.5 * two_a),
                      T(2.0 / two_a),         T(0.5 * (two_a + r_cut)),
                      T(2.0 / (r_cut - two_a))};
}

}  // namespace cellk
