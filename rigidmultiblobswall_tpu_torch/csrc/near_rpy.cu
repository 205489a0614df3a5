// Kernel K6: the near-field RPY remainder of the periodic spectral Ewald
// engine (ops/ewald.py) for B = 1 or 2 stacked right-hand sides,
//   u_i = sum_j alpha(r) f_j + (beta(r) / r^2) (d . f_j) d
// over the 27-cell stencil, for the pairs with 0 < r^2 < r_cut^2
// (d = r_i - r_j^image). alpha and beta come from a two-piece Chebyshev
// series (cell_sweep.cuh's Remainder), one Clenshaw recurrence per
// function shared across the B right-hand sides. The self term is the
// caller's (ops/ewald.real_matvec).
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/ewald.py
// (_near_kernel; wrapper _near_rows_pallas).
//
// What bounds it on the H100: float32 instruction issue, and how many
// lanes of a warp do useful work. Only ~15 % of the 27-cell candidates lie
// inside r_cut, and a pair inside costs the two K-term Clenshaw series
// (~120 instructions at K = 24); the bytes are a few MB. A sweep that
// hands each lane its own candidates pays the series in nearly every
// warp-step for ~5 useful lanes.
//
// Design, the compacted walk of K7 (wall_near.cu) for the periodic box:
// - one block per target cell: the stencil's sources staged once into
//   shared memory in tiles of kSrc (cell_sweep.cuh's stage_sources; every
//   stencil of the bench-size plan fits one float32 tile) beside their
//   strengths, and the cell's targets kTgt at a time (a cell with more
//   walks its stencil once per chunk); a stencil longer than one tile adds
//   its rows one tile at a time; the tile is padded to whole steps with
//   far rows (never inside r_cut), so a step tests no bounds;
// - the block's 8 warps take its targets in turn (t = warp, warp + 8, ...;
//   fewer warps a block ran slower at the bench plan); a warp tests kStep
//   (128) candidates of its target a step, as four independent quarters of
//   32, and appends the pairs inside r_cut to its ring in shared memory
//   with __ballot_sync and __popc prefixes (no branch), in stencil order;
// - whenever the ring holds 32 pairs, lane k evaluates entry k. The ring
//   runs on across the warp's targets (a target averages ~2.5 batches, so
//   per-target batches would end part empty); its partial batch drains once
//   after the warp's last target of the tile. The entries come in target
//   order, so a lane adds its entry into its own sums of the current
//   target's run; when the run moves on to the next target, the lanes'
//   sums are reduced in a fixed xor tree and lane 0 adds the row into out.
// out is zeroed by the caller and each row belongs to one warp; every order
// depends only on the data and the launch: no atomics, bit-identical on
// repeat.

#include "cell_sweep.cuh"

namespace {

using cellk::Grid;
using cellk::kChebPiece;
using cellk::kMaxCheb;
using cellk::kTgt;

constexpr int kStep = 128;       // candidates a warp tests a step
constexpr int kRing = 256;       // a warp's ring: < 32 left + kStep appended
constexpr int kRingSlots = cellk::ring_slots<kRing>();

// sources staged a tile, whole steps: float32 holds every stencil of the
// bench-size plan (at most 738 sources) in one tile; float64 (off the hot
// paths) fewer
template <typename T>
using Walk = cellk::Walk<T, 768, 512>;

// strengths of a staged source: 3B padded to whole 16-byte loads in float32
template <int B>
__host__ __device__ constexpr int f_row() {
  return B == 1 ? 4 : 8;
}

// dynamic shared memory of a launch: table rows, the staged tile and its
// strengths, a chunk of the cell's targets, every warp's ring, target ids
template <typename T, int B>
size_t smem_bytes(int cap) {
  constexpr int warps = cellk::kThreads / 32;
  const int nt = cellk::target_slots(cap);
  return sizeof(T) * (2 * kChebPiece + (4 + f_row<B>()) * Walk<T>::kSrc +
                      4 * nt) +
         sizeof(unsigned) * warps * kRingSlots + sizeof(int) * nt;
}

// One pair of a batch: target row tgt, source row src and strengths fs
// (staged), into u.
template <typename T, int B>
__device__ __forceinline__ void eval_pair(const cellk::Remainder<T>& rem,
                                          const T* cheb, const T* tgt,
                                          const T* src, const T* fs, T* u) {
  T t[4], s[4], fv[f_row<B>()];
  cellk::load_vec<4>(tgt, t);
  cellk::load_vec<4>(src, s);
  const T dx = t[0] - s[0], dy = t[1] - s[1], dz = t[2] - s[2];
  const T r2 = dx * dx + dy * dy + dz * dz;
  const T invr = cellk::rsqrt_t(r2);
  T al, bfac;
  rem.eval(cheb, r2 * invr, invr, al, bfac);
  cellk::load_vec<f_row<B>()>(fs, fv);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const T fx = fv[3 * b + 0], fy = fv[3 * b + 1], fz = fv[3 * b + 2];
    const T g = bfac * (dx * fx + dy * fy + dz * fz);
    u[3 * b + 0] = al * fx + g * dx;
    u[3 * b + 1] = al * fy + g * dy;
    u[3 * b + 2] = al * fz + g * dz;
  }
}

// The lanes' sums of target `cur`'s run: reduced in a fixed xor tree and
// added into its row by lane 0, then cleared (cur < 0: no run yet).
template <typename T, int NF>
__device__ __forceinline__ void flush(T* acc, int cur, const int* ids,
                                      T* out, unsigned lane) {
  if (cur < 0) return;                        // uniform across the warp
  T* row = out + static_cast<size_t>(NF) * ids[cur];
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    T v = acc[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) row[q] += v;
    acc[q] = T(0);
  }
}

// resident 256-thread blocks an SM that __launch_bounds__ asks for: float32
// four (64 registers); float64 uncapped
template <typename T, int B>
__global__ void __launch_bounds__(cellk::kThreads, (cellk::min_blocks<T>(4)))
near_rpy_kernel(const T* __restrict__ pos, const T* __restrict__ f,
                const int* __restrict__ table, const T* __restrict__ cheb,
                T* __restrict__ out, Grid g, double Lx, double Ly, double Lz,
                int K, cellk::Remainder<T> rem, int cell0) {
  constexpr int NF = 3 * B;
  constexpr int FR = f_row<B>();
  constexpr int kSrc = Walk<T>::kSrc;
  static_assert(kSrc % kStep == 0, "a padded tile holds whole steps");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  T* s_cheb = reinterpret_cast<T*>(smem);
  T* s_src = s_cheb + 2 * kChebPiece;         // (kSrc, 4)
  T* s_f = s_src + 4 * kSrc;                  // (kSrc, FR)
  T* s_tgt = s_f + FR * kSrc;                 // (target_slots, 4)
  unsigned* s_ring =
      reinterpret_cast<unsigned*>(s_tgt + 4 * cellk::target_slots(g.cap));
  int* s_id = reinterpret_cast<int*>(s_ring + warps * kRingSlots);
  __shared__ cellk::Stencil st;

  // the block's target cell: cells [cell0, cell0 + gridDim.x) of a
  // launch (a rank's share, or every cell)
  const int cell = cell0 + static_cast<int>(blockIdx.x);
  if (cellk::empty_cell(table, cell, g)) return;   // uniform
  cellk::stage_cheb(cheb, K, s_cheb);
  cellk::load_stencil(st, table, cell, g, Lx, Ly, Lz);  // a barrier
  const int n_tgt = st.start[14] - st.start[13];
  const int* own = table + static_cast<size_t>(st.cell[13]) * g.cap;
  const int total = st.start[27];
  const int warp = threadIdx.x / 32;
  const unsigned lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  unsigned* ring = s_ring + warp * kRingSlots;

  // the cell's targets kTgt at a time; the barrier that ends the last tile
  // of a chunk comes before the next chunk is staged
  for (int t0 = 0; t0 < n_tgt; t0 += kTgt) {
    const int nt = min(kTgt, n_tgt - t0);
    cellk::stage_targets(st, own + t0, nt, pos, s_tgt, s_id);
    for (int s0 = 0; s0 < total; s0 += kSrc) {
      const int m = min(kSrc, total - s0);
      cellk::stage_sources(st, table, g, s0, m, [&](int s, int id, int k) {
        T* row = s_src + 4 * s;
        cellk::local_source(st, pos, id, k, row);
        row[3] = T(0);
        T* fr = s_f + FR * s;
        for (int q = 0; q < FR; ++q)
          fr[q] = q < NF ? f[static_cast<size_t>(NF) * id + q] : T(0);
      });
      cellk::pad_rows(s_src, m, (m + kStep - 1) / kStep * kStep);
      __syncthreads();
      // the ring's head and tail and the current run are uniform across
      // the warp; the ring carries over from one of its targets to the next
      unsigned head = 0, tail = 0;
      int cur = -1;                           // the target of the lanes' sums
      T acc[NF];
#pragma unroll
      for (int q = 0; q < NF; ++q) acc[q] = T(0);
      // one pass past the warp's last target drains the ring (one call
      // site of the evaluation keeps its code once in the instruction
      // cache)
      for (int t = warp;; t += warps) {
        const bool done = t >= nt;
        const int mt = done ? 0 : m;
        T tgt[4] = {T(0), T(0), T(0), T(0)};
        if (!done) cellk::load_vec<4>(s_tgt + 4 * t, tgt);
        const unsigned key = static_cast<unsigned>(t) << 16;
        for (int c0 = 0;; c0 += kStep) {
          const bool last = c0 >= mt;
          if (!last) {
            bool in[kStep / 32];
#pragma unroll
            for (int q = 0; q < kStep / 32; ++q) {
              T s[4];
              in[q] = cellk::candidate(s_src, c0 + 32 * q + lane, tgt[0],
                                       tgt[1], tgt[2], rem.rc2, s);
            }
#pragma unroll
            for (int q = 0; q < kStep / 32; ++q)
              tail = cellk::append<kRing>(ring, tail, in[q],
                                          key | (c0 + 32 * q + lane), below);
            __syncwarp();
          }
          // full batches, lane k on entry k; the partial batch once the
          // warp's targets are done
          for (;;) {
            const unsigned n = tail - head;
            if (n < 32 && !(done && n > 0)) break;
            const unsigned count = min(n, 32u);
            T u[NF];
            int te = -1;
            if (lane < count) {
              const unsigned e = ring[(head + lane) % kRing];
              const int j = static_cast<int>(e & 0xffffu);
              te = static_cast<int>(e >> 16);
              eval_pair<T, B>(rem, s_cheb, s_tgt + 4 * te, s_src + 4 * j,
                              s_f + FR * j, u);
            }
            head += count;
            // each lane's entry joins its target's run; a run that moves
            // on to the next target flushes the last one
            unsigned pending = __ballot_sync(0xffffffffu, lane < count);
            while (pending) {
              const int t1 = __shfl_sync(0xffffffffu, te, __ffs(pending) - 1);
              if (t1 != cur) {
                flush<T, NF>(acc, cur, s_id, out, lane);
                cur = t1;
              }
              const bool mine = te == t1;
              pending &= ~__ballot_sync(0xffffffffu, mine);
              if (mine) {
#pragma unroll
                for (int q = 0; q < NF; ++q) acc[q] += u[q];
              }
            }
          }
          __syncwarp();   // drained slots are read before they are refilled
          if (last) break;
        }
        if (done) break;
      }
      flush<T, NF>(acc, cur, s_id, out, lane);
      __syncthreads();   // the tile is restaged
    }
  }
}

template <typename T, int B>
int launch(const T* pos, const T* f, const int* table, const T* cheb,
           T* out, int n, int nx, int ny, int nz, int cap, int K, double Lx,
           double Ly, double Lz, double two_a, double r_cut, int c0, int c1,
           void* stream) {
  if (K < 1 || K > kMaxCheb || cap < 1 || c0 < 0 || c1 < c0 ||
      c1 > nx * ny * nz)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c1 == c0) return 0;   // an empty share launches nothing
  // the staged tile and the rings take more than the 48 KB of static
  // shared memory: raise the instance's limit to this launch's size
  const size_t bytes = smem_bytes<T, B>(cap);
  const cudaError_t attr = cudaFuncSetAttribute(
      near_rpy_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Grid g{n, nx, ny, nz, cap};
  near_rpy_kernel<T, B><<<c1 - c0, cellk::kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      pos, f, table, cheb, out, g, Lx, Ly, Lz, K,
      cellk::make_remainder<T>(K, two_a, r_cut), c0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos (n,3) plan positions, f (n,3B) b-major columns, table (nx ny nz cap,)
// int32 from ops/cells.cell_bin, cheb (2,2,K) the piecewise coefficients,
// out (n,3B) zeroed by the caller (dropped particles keep their zero row);
// the target cells [c0, c1) of the nx ny nz (a rank's share writes the
// rows of its cells' particles alone); all contiguous on the device.
// Returns the CUDA error code of the launch.
#define NEAR_ENTRY(NAME, T, B)                                               \
  extern "C" int NAME(const T* pos, const T* f, const int* table,           \
                      const T* cheb, T* out, int n, int nx, int ny, int nz, \
                      int cap, int K, double Lx, double Ly, double Lz,      \
                      double two_a, double r_cut, int c0, int c1,           \
                      void* stream) {                                       \
    return launch<T, B>(pos, f, table, cheb, out, n, nx, ny, nz, cap, K, Lx, \
                        Ly, Lz, two_a, r_cut, c0, c1, stream);              \
  }

NEAR_ENTRY(near_rpy_f32_b1, float, 1)
NEAR_ENTRY(near_rpy_f32_b2, float, 2)
NEAR_ENTRY(near_rpy_f64_b1, double, 1)
NEAR_ENTRY(near_rpy_f64_b2, double, 2)
