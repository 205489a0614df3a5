// Kernel K7: the near field of the spectral single-wall engine
// (ops/ewald_wall.py) for B = 1 or 2 stacked right-hand sides. Over the
// pairs 0 < r < r_cut of the combined set of 2N points (real rows at
// (x, y, z - z0), their images at (x, y, -z - z0); xy periodic), each real
// target i sums
//   - the RPY remainder alpha(r) f + (beta(r) / r^2) (d . f) d of every
//     source, with mirrored strengths at image sources (grid z + z0 < 0):
//     (-fx, -fy, fz) of the real twin, mirrored here from the raw strength;
//   - for image sources only, the screened image channels
//     pref_img (T0 + h T1 + h^2 T2) f_raw at the displacement d / a and the
//     source height h = -(z_src + z0) / a (img_terms, generated into
//     wall_img_terms.cuh from ops/_wall_channels_gen.py), from ten radial
//     series on r / a (a two-piece Chebyshev table, split at ir_mid).
// alpha and beta come from the RPY remainder's two-piece table (pieces r <
// 2a and 2a <= r < r_cut). The self term and the overlap damping are the
// caller's (ops/ewald_wall.near_matvec, matvec).
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/ewald_wall.py
// (_wall_near_kernel; wrapper _wall_near_rows). The TPU's pre-gathered,
// lane-padded (cell, 27 cap) source layout is not needed: each block walks
// its target cell's 27-cell stencil (cell_sweep.cuh's load_stencil) and
// stages sources through shared memory.
//
// What bounds it on the H100: float32 instruction issue, and how many
// lanes of a warp do useful work. A pair inside r_cut costs the RPY
// remainder's two K-term Clenshaw series; a pair with an image source adds
// ten Ki-term series (Ki = 24 at bench.py's tolerance) and img_terms, ~900
// instructions; the bytes are a few MB. Only ~15 % of the 27-cell
// candidates lie inside r_cut and ~17 % of those have an image source, so a
// sweep that hands each lane its own candidates leaves most lanes idle in
// the remainder and takes the image branch in more than half of its
// warp-steps for a single lane.
//
// Design, a compacted walk on cell_sweep.cuh's pieces (the stencil and
// target staging, the candidate test and ring append, the remainder
// series, which K6 (near_rpy.cu) shares, and the walk of a staged tile,
// compacted_walk, which K8 (wall_rot_near.cu) shares): one block per
// target cell of the layers that can hold real particles ([cz_lo,
// cz_hi]); the image-only
// layers are never launched. The real targets are a prefix of a cell's
// live slots (cell_bin keeps ids in ascending order and the reals are ids
// < n_real).
// - The stencil's sources are staged in shared memory in tiles of kSrc
//   (every stencil of the bench-size slab fits one tile) in the block's
//   local frame, relative to the target cell's corner (formed in double,
//   rounded once), beside the source's ABSOLUTE physical z (the image test
//   and h) and its raw strengths; the cell's targets likewise, kTgt at a
//   time (a cell with more reals walks its stencil once per chunk).
// - A warp takes its targets one at a time over the whole tile. It tests
//   64 candidates a step, as two independent halves of 32 (distance,
//   r_cut, image source), and appends the pairs inside r_cut, with
//   __ballot_sync and __popc prefixes, to two rings in shared memory in
//   the stencil's order: the target's real-source pairs, and the warp's
//   image-source pairs, which carry their target and run on across the
//   warp's targets (a target averages ~35 image pairs at the bench size,
//   so per-target batches would run half empty).
// - Whenever a ring holds 32 pairs, the warp evaluates them with every lane
//   busy, lane k on entry k of the batch. A real batch runs the remainder
//   into the lane's own sums, its partial batch once after the target's
//   last step, then the lanes reduce in a fixed xor tree and lane 0 adds
//   the row into out. An image batch runs the remainder and the image
//   channels; its entries come in target order, so each run of one target
//   is reduced in a fixed xor tree and added into that row by lane 0; the
//   ring's partial batch drains once after the warp's last target.
// - out is zeroed by the caller and each row belongs to one warp; every
//   order depends only on the data: no atomics, bit-identical on repeat. A
//   stencil longer than one tile adds its rows one tile at a time.
// The Chebyshev tables sit in shared memory, loaded once a block, as rows
// that one 16-byte load reads ((a_k, b_k, a_k+1, b_k+1) of the remainder;
// the ten image coefficients of order k); a piece is an address, not a
// branch. The z wrap of the stencil only reaches the empty guard layer on
// top of the slab (ops/ewald_wall.make_wall_plan), so the wrap shift never
// enters a pair.

#include "cell_sweep.cuh"
#include "wall_img_terms.cuh"

namespace {

using cellk::Grid;
using cellk::kChebPiece;
using cellk::kMaxCheb;
using cellk::kTgt;
constexpr int kRing = 128;     // a warp's ring: < 32 left + 64 appended a step
constexpr int kRingSlots = cellk::ring_slots<kRing>();
using cellk::load_vec;

constexpr int kImg = 10;       // radial series of the image channels
constexpr int kWarps = cellk::kThreads / 32;
// shared-memory rows of the image table: the ten image coefficients of
// order k padded to 12; the pieces are padded so that the two pieces' rows
// of one k fall in different banks
constexpr int kImgRow = 12;
constexpr int kImgPiece = kMaxCheb * kImgRow + 4;

// sources staged a tile: float32 holds every stencil of the bench-size
// slab (at most ~1,230 sources) in one tile; float64 (off the hot paths)
// fewer
template <typename T>
using Walk = cellk::Walk<T, 1408, 1024>;

// resident blocks an SM that __launch_bounds__ asks for in float32: B = 1
// three (80 registers, no spills), B = 2 two (112 registers: at 80 it
// spills, and ran ~2 % slower)
template <int B>
constexpr int kMinBlocksF32 = B == 1 ? 3 : 2;

// dynamic shared memory of a launch: tables, the staged tile, a chunk of
// the cell's targets, the two rings of every warp, the target ids
template <typename T, int B>
size_t smem_bytes(int cap) {
  const int nt = cellk::target_slots(cap);
  return sizeof(T) * (2 * kChebPiece + 2 * kImgPiece +
                      (4 + 3 * B) * Walk<T>::kSrc + 4 * nt) +
         (sizeof(unsigned) + sizeof(unsigned short)) * kWarps * kRingSlots +
         sizeof(int) * nt;
}

template <typename T>
__device__ __forceinline__ T clamp_t(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
struct WallScalars {
  int K, Ki;                                   // terms per piece
  cellk::Remainder<T> rem;                     // RPY remainder pieces
  T inv_a, pref_img;
  T ir_lo, ir_mid, ir_hi, mid_i0, inv_hi0, mid_i1, inv_hi1;  // image r / a
};

// One (target, source) pair inside r_cut: d = target - source in the local
// frame, zabs the source's physical z, f its raw strengths (component q at
// f[q kSrc], read where they are used); IMG: the source is an image
// (mirrored strengths, plus the image channels).
template <typename T, int B, bool IMG>
__device__ __forceinline__ void wall_pair(const WallScalars<T>& sc,
                                          const T* cheb, const T* img, T dx,
                                          T dy, T dz, T zabs, const T* f,
                                          T* acc) {
  const T r2 = dx * dx + dy * dy + dz * dz;
  const T invr = cellk::rsqrt_t(r2);
  const T r = r2 * invr;
  // ---- RPY remainder on mirrored strengths
  T al, bfac;
  sc.rem.eval(cheb, r, invr, al, bfac);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    constexpr int kS = Walk<T>::kSrc;
    const T fx = IMG ? -f[(3 * b + 0) * kS] : f[(3 * b + 0) * kS];
    const T fy = IMG ? -f[(3 * b + 1) * kS] : f[(3 * b + 1) * kS];
    const T fz = f[(3 * b + 2) * kS];
    const T g = bfac * (dx * fx + dy * fy + dz * fz);
    acc[3 * b + 0] += al * fx + g * dx;
    acc[3 * b + 1] += al * fy + g * dy;
    acc[3 * b + 2] += al * fz + g * dz;
  }
  if (!IMG) return;
  // ---- screened image channels, in units of a; r / a clamped into the
  // series' domain before evaluation
  const T hs = -zabs * sc.inv_a;
  const T rs = clamp_t(r * sc.inv_a, sc.ir_lo, sc.ir_hi);
  const bool p0 = rs < sc.ir_mid;
  const T ti = clamp_t(p0 ? (rs - sc.mid_i0) * sc.inv_hi0
                          : (rs - sc.mid_i1) * sc.inv_hi1, T(-1), T(1));
  const T ti2 = ti + ti;
  const T* c = img + (p0 ? 0 : kImgPiece);
  T c1[kImg], c2[kImg];
#pragma unroll
  for (int q = 0; q < kImg; ++q) c1[q] = c2[q] = T(0);
  for (int k = sc.Ki - 1; k > 0; --k) {
    T ck[kImgRow];
    load_vec<kImgRow>(c + k * kImgRow, ck);
#pragma unroll
    for (int q = 0; q < kImg; ++q) {
      const T cn = ti2 * c1[q] - c2[q] + ck[q];
      c2[q] = c1[q];
      c1[q] = cn;
    }
  }
  T ck[kImgRow];
  load_vec<kImgRow>(c, ck);
  T cv[kImg];
#pragma unroll
  for (int q = 0; q < kImg; ++q) cv[q] = ti * c1[q] - c2[q] + ck[q];
  const T dxs = dx * sc.inv_a, dys = dy * sc.inv_a, rzs = dz * sc.inv_a;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    T ux, uy, uz;
    constexpr int kS = Walk<T>::kSrc;
    wallk::img_terms<T>(dxs, dys, rzs, hs, f[(3 * b + 0) * kS],
                        f[(3 * b + 1) * kS], f[(3 * b + 2) * kS], T(1),
                        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6],
                        cv[7], cv[8], cv[9], ux, uy, uz);
    acc[3 * b + 0] += sc.pref_img * ux;
    acc[3 * b + 1] += sc.pref_img * uy;
    acc[3 * b + 2] += sc.pref_img * uz;
  }
}

// Evaluate source j of the staged tile (src (kSrc, 4) rows of local x, y,
// z and physical z; f (3B, kSrc) raw strengths) against the target
// (tgt: local x, y, z) into acc.
template <typename T, int B, bool IMG>
__device__ __forceinline__ void eval_entry(const WallScalars<T>& sc,
                                           const T* cheb, const T* img,
                                           const T* src_rows, const T* f,
                                           int j, const T* tgt, T* acc) {
  T src[4];
  load_vec<4>(src_rows + 4 * j, src);
  wall_pair<T, B, IMG>(sc, cheb, img, tgt[0] - src[0], tgt[1] - src[1],
                       tgt[2] - src[2], src[3], f + j, acc);
}

template <typename T, int B>
__global__ void __launch_bounds__(cellk::kThreads,
                                  (cellk::min_blocks<T>(kMinBlocksF32<B>)))
wall_near_kernel(const T* __restrict__ pos, const T* __restrict__ f,
                 const int* __restrict__ table, const T* __restrict__ cheb,
                 const T* __restrict__ img, T* __restrict__ out, Grid g,
                 int n_real, int cz_lo, int nkz, double Lx, double Ly,
                 double Lz, double z0, WallScalars<T> sc, int col0) {
  constexpr int NF = 3 * B;
  constexpr int kSrc = Walk<T>::kSrc;
  static_assert(kSrc % 64 == 0, "a padded tile holds whole 64-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_cheb = reinterpret_cast<T*>(smem);
  T* s_img = s_cheb + 2 * kChebPiece;
  T* s_src = s_img + 2 * kImgPiece;           // (kSrc, 4)
  T* s_f = s_src + 4 * kSrc;                  // (NF, kSrc)
  T* s_tgt = s_f + NF * kSrc;                 // (target_slots, 4)
  unsigned* s_ring_i =
      reinterpret_cast<unsigned*>(s_tgt + 4 * cellk::target_slots(g.cap));
  unsigned short* s_ring_r =
      reinterpret_cast<unsigned short*>(s_ring_i + kWarps * kRingSlots);
  int* s_id = reinterpret_cast<int*>(s_ring_r + kWarps * kRingSlots);
  __shared__ cellk::Stencil st;
  __shared__ int s_ntgt;

  cellk::stage_cheb(cheb, sc.K, s_cheb);
  for (int i = threadIdx.x; i < 2 * kImg * sc.Ki; i += blockDim.x) {
    // img (2 pieces, 10 series, Ki) -> (piece, k, series) rows
    const int p = i / (kImg * sc.Ki), q = (i / sc.Ki) % kImg, k = i % sc.Ki;
    s_img[p * kImgPiece + k * kImgRow + q] = img[i];
  }
  // (x, y) column col0 + blockIdx.x / nkz of a launch (a rank's share of
  // the columns, or every one), z layer cz_lo + blockIdx.x % nkz
  const int c = (col0 + static_cast<int>(blockIdx.x) / nkz) * g.nz + cz_lo +
                static_cast<int>(blockIdx.x) % nkz;
  // no real target (the reals are a prefix of the live slots): uniform
  if (table[static_cast<size_t>(c) * g.cap] >= n_real) return;
  cellk::load_stencil(st, table, c, g, Lx, Ly, Lz);   // ends in a barrier
  const int* own = table + static_cast<size_t>(st.cell[13]) * g.cap;
  if (threadIdx.x == 0) {
    // the real targets: the prefix of live slots with ids < n_real
    int lo = 0, hi = st.start[14] - st.start[13];
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (own[mid] < n_real) lo = mid + 1; else hi = mid;
    }
    s_ntgt = lo;
  }
  __syncthreads();
  const int n_tgt = s_ntgt;
  if (n_tgt == 0) return;                     // uniform across the block
  const int total = st.start[27];
  const int warp = threadIdx.x / 32;
  unsigned short* ring_r = s_ring_r + warp * kRingSlots;   // real sources
  unsigned* ring_i = s_ring_i + warp * kRingSlots;         // image sources

  // the cell's targets kTgt at a time; the barrier that ends the last
  // tile of a chunk comes before the next chunk is staged
  for (int t0 = 0; t0 < n_tgt; t0 += kTgt) {
    const int nt = min(kTgt, n_tgt - t0);
    cellk::stage_targets(st, own + t0, nt, pos, s_tgt, s_id);
    for (int s0 = 0; s0 < total; s0 += kSrc) {
      const int m = min(kSrc, total - s0);
      cellk::stage_sources(st, table, g, s0, m, [&](int s, int sid, int k) {
        T* row = s_src + 4 * s;
        cellk::local_source(st, pos, sid, k, row);
        row[3] = T(double(pos[3 * sid + 2]) + z0);
        // an image row reuses its real twin's raw strengths
        const int src = sid < n_real ? sid : sid - n_real;
        for (int q = 0; q < NF; ++q)
          s_f[q * kSrc + s] = f[static_cast<size_t>(NF) * src + q];
      });
      cellk::pad_rows(s_src, m, (m + 63) / 64 * 64);   // whole 64-steps
      __syncthreads();
      cellk::compacted_walk<kRing, NF>(
          s_src, s_tgt, s_id, m, nt, sc.rem.rc2, ring_r, ring_i, out,
          [&](int j, const T* tgt, T* acc) {
            eval_entry<T, B, false>(sc, s_cheb, s_img, s_src, s_f, j, tgt,
                                    acc);
          },
          [&](int te, int j, T* u) {
            T tgt[4];
            load_vec<4>(s_tgt + 4 * te, tgt);
            eval_entry<T, B, true>(sc, s_cheb, s_img, s_src, s_f, j, tgt, u);
          });
      __syncthreads();   // the tile is restaged
    }
  }
}

template <typename T, int B>
int launch(const T* pos, const T* f, const int* table, const T* cheb,
           const T* img, T* out, int n_real, int nx, int ny, int nz, int cap,
           int K, int Ki, int cz_lo, int cz_hi, double Lx, double Ly,
           double Lz, double two_a, double r_cut, double z0, double a,
           double pref_img, double ir_lo, double ir_mid, double ir_hi,
           int col0, int col1, void* stream) {
  if (K < 1 || K > kMaxCheb || Ki < 1 || Ki > kMaxCheb || cz_lo < 0 ||
      cz_hi >= nz || cz_hi < cz_lo || cap < 1 || col0 < 0 || col1 < col0 ||
      col1 > nx * ny)
    return static_cast<int>(cudaErrorInvalidValue);
  if (col1 == col0) return 0;   // an empty share launches nothing
  // the staged tile, the targets and the rings take more than the 48 KB of
  // static shared memory: raise the instance's limit to this launch's size
  const size_t bytes = smem_bytes<T, B>(cap);
  const cudaError_t attr = cudaFuncSetAttribute(
      wall_near_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Grid g{2 * n_real, nx, ny, nz, cap};
  // the image pieces split [ir_lo, ir_hi] at ir_mid
  const WallScalars<T> sc{
      K, Ki, cellk::make_remainder<T>(K, two_a, r_cut), T(1.0 / a),
      T(pref_img), T(ir_lo), T(ir_mid), T(ir_hi), T(0.5 * (ir_mid + ir_lo)),
      T(2.0 / (ir_mid - ir_lo)), T(0.5 * (ir_hi + ir_mid)),
      T(2.0 / (ir_hi - ir_mid))};
  const int nkz = cz_hi - cz_lo + 1;
  wall_near_kernel<T, B><<<(col1 - col0) * nkz, cellk::kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      pos, f, table, cheb, img, out, g, n_real, cz_lo, nkz, Lx, Ly, Lz, z0,
      sc, col0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos (2 n_real, 3) grid-shifted positions of the reals then their images,
// f (n_real, 3B) raw strengths, b-major columns, table (nx ny nz cap,) int32
// from ops/cells.cell_bin over (Lx, Ly, Lz) (sentinel 2 n_real), cheb
// (2, 2, K) the RPY remainder's pieces, img (2, 10, Ki) the image radial
// series, out (n_real, 3B) zeroed by the caller (dropped particles keep
// their zero row); target cells on the z layers [cz_lo, cz_hi] of the
// (x, y) columns [col0, col1) of the nx ny (a rank's share writes the rows
// of its columns' real particles alone); all contiguous on the device.
// Returns the CUDA error code of the launch.
#define WALL_ENTRY(NAME, T, B)                                                \
  extern "C" int NAME(const T* pos, const T* f, const int* table,            \
                      const T* cheb, const T* img, T* out, int n_real,       \
                      int nx, int ny, int nz, int cap, int K, int Ki,        \
                      int cz_lo, int cz_hi, double Lx, double Ly, double Lz, \
                      double two_a, double r_cut, double z0, double a,       \
                      double pref_img, double ir_lo, double ir_mid,          \
                      double ir_hi, int col0, int col1, void* stream) {      \
    return launch<T, B>(pos, f, table, cheb, img, out, n_real, nx, ny, nz,   \
                        cap, K, Ki, cz_lo, cz_hi, Lx, Ly, Lz, two_a, r_cut,  \
                        z0, a, pref_img, ir_lo, ir_mid, ir_hi, col0, col1,   \
                        stream);                                             \
  }

WALL_ENTRY(wall_near_f32_b1, float, 1)
WALL_ENTRY(wall_near_f32_b2, float, 2)
WALL_ENTRY(wall_near_f64_b1, double, 1)
WALL_ENTRY(wall_near_f64_b2, double, 2)
