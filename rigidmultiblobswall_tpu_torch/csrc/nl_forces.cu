// Kernel K5: linked-cell soft blob-blob repulsion in a periodic box or a
// wall slab,
//   F_i = sum_j mag(r_ij) (r_i - r_j^image)  over the 27-cell stencil,
//   mag = eps/b exp((2a - r)/b) / r  for r > 2a,   eps/(b r) otherwise,
// skipping r^2 == 0 (the particle itself and coincident blobs). There is
// no cutoff test: the sum runs over the whole stencil, as both JAX paths
// do (a test at the cutoff would drop exp(-12)-sized tails).
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/forces.py
// (_nl_force_kernel; wrapper _neighbor_forces_pallas), periodic box and
// wall slab (the wrapper's guard_z), and, in its open instance
// (nl_forces_open_*), the generic linked-cell path of the same file
// (forces.py:187-269, XLA there) in a box with open axes: the cells of an
// open axis sized from the data's extent (cell_sweep.cuh Frame), the
// stencil stopped at its edges, and the targets of a cell every particle
// binned into it, a cell's overflow included (its own row is summed; it
// is dropped as a source only, as that path drops it), read from the
// wrapper's stable sort of the cell ids (order, starts).
//
// What bounds it on the H100: the special-function unit and instruction
// issue. Every candidate pair costs one rsqrt and one exp2 (MUFU, 16 a
// clock an SM against 128 float32 lanes) and ~16 other instructions; the
// bytes (positions once, the table, the output) are a few MB. The law is
// K2's, branch-free with one MUFU.EX2 of a folded argument
// (csrc/force_law.cuh); a self pair and coincident blobs take mag = 0.
//
// Design: one block of 8 warps per target cell (a cell with no particle
// returns after one load; more blocks a cell or fewer warps a block ran
// slower at the bench plans). The block stages its stencil once into shared
// memory (cell_sweep.cuh's stage_sources; every stencil of the bench-size
// plans fits one float32 tile of kSrc, a longer one adds its rows one tile
// at a time) and the cell's targets kTgt at a time. The cell's targets form
// pairs (2p, 2p + 1); warp w takes the pairs p = w, w + 8, ..., and its
// lanes walk the tile's sources 32 apart, each source's shared load and
// loop step serving both targets. The tile is padded to whole warp-steps
// with far sources (and an odd cell's last pair with a far target), whose
// magnitude is 0, so the loop has no bounds test. The lanes' sums are
// reduced in a fixed xor tree and lane 0 adds each row into out (zeroed by
// the caller); a row belongs to one warp: no atomics, bit-identical on
// repeat.

#include "cell_sweep.cuh"
#include "force_law.cuh"

namespace {

using cellk::Grid;

using forcek::Law;

// sources staged a tile: float32 holds every stencil of the bench-size
// plans (at most ~1,920 sources) in one tile
template <typename T>
using Walk = cellk::Walk<T, 2048, 1024>;

// dynamic shared memory of a launch: the staged tile, a chunk of targets
// and their ids
template <typename T>
size_t smem_bytes(int cap) {
  const int nt = cellk::target_slots(cap);
  return sizeof(T) * 4 * (Walk<T>::kSrc + nt) + sizeof(int) * nt;
}

template <typename T>
__device__ __forceinline__ void add_pair(const Law<T>& law, const T* t,
                                         const T* s, T* acc) {
  const T dx = t[0] - s[0], dy = t[1] - s[1], dz = t[2] - s[2];
  const T r2 = dx * dx + dy * dy + dz * dz;
  const T mag = forcek::magnitude(law, r2, cellk::rsqrt_t(r2));
  acc[0] += mag * dx;
  acc[1] += mag * dy;
  acc[2] += mag * dz;
}

// resident 256-thread blocks an SM that __launch_bounds__ asks for: float32
// four (64 registers); float64 uncapped
// the cells of the frame f (cell_sweep.cuh); OPEN: the open instance, the
// targets order[starts[c] .. starts[c + 1]); else the cell's live slots
template <typename T, bool OPEN>
__global__ void __launch_bounds__(cellk::kThreads, (cellk::min_blocks<T>(4)))
nl_forces_kernel(const T* __restrict__ pos, const int* __restrict__ table,
                 const int* __restrict__ order,
                 const int* __restrict__ starts, T* __restrict__ out, Grid g,
                 cellk::Frame f, Law<T> law) {
  constexpr int kSrc = Walk<T>::kSrc;
  static_assert(kSrc % 32 == 0, "a padded tile holds whole warp-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_src = reinterpret_cast<T*>(smem);      // (kSrc, 4)
  T* s_tgt = s_src + 4 * kSrc;                // (target_slots, 4)
  int* s_id = reinterpret_cast<int*>(s_tgt + 4 * cellk::target_slots(g.cap));
  __shared__ cellk::Stencil st;

  if (cellk::empty_cell(table, blockIdx.x, g)) return;   // uniform
  cellk::load_stencil(st, table, blockIdx.x, g, f);
  const int n_tgt = OPEN ? starts[blockIdx.x + 1] - starts[blockIdx.x]
                         : st.start[14] - st.start[13];
  const int* own = OPEN ? order + starts[blockIdx.x]
                        : table + static_cast<size_t>(st.cell[13]) * g.cap;
  // targets staged at a time: the open instance's cell may hold more
  // particles than its cap
  const int chunk = cellk::target_slots(g.cap);
  const int total = st.start[27];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  // the padding (cell_sweep.cuh's far_coord): its pairs with any particle
  // have r^-1 near 1e-18 and an exponent of -1e18 c, so mag is 0; two far
  // points coincide and take mag = 0 as well
  const T far = cellk::far_coord<T>();

  for (int t0 = 0; t0 < n_tgt; t0 += chunk) {
    const int nt = min(chunk, n_tgt - t0);
    cellk::stage_targets(st, own + t0, nt, pos, s_tgt, s_id);
    for (int s0 = 0; s0 < total; s0 += kSrc) {
      const int m = min(kSrc, total - s0);
      const int mp = (m + 31) / 32 * 32;
      cellk::stage_sources(st, table, g, s0, m, [&](int s, int id, int k) {
        T* row = s_src + 4 * s;
        cellk::local_source(st, pos, id, k, row);
        row[3] = T(0);
      });
      cellk::pad_rows(s_src, m, mp);
      __syncthreads();
      for (int p = warp; 2 * p < nt; p += warps) {
        const bool second = 2 * p + 1 < nt;
        T ta[4], tb[4] = {far, far, far, T(0)};
        cellk::load_vec<4>(s_tgt + 8 * p, ta);
        if (second) cellk::load_vec<4>(s_tgt + 8 * p + 4, tb);
        T a[3] = {T(0), T(0), T(0)}, b[3] = {T(0), T(0), T(0)};
#pragma unroll 4
        for (int j = lane; j < mp; j += 32) {
          T s[4];
          cellk::load_vec<4>(s_src + 4 * j, s);
          add_pair(law, ta, s, a);
          add_pair(law, tb, s, b);
        }
        // the lanes' sums: a fixed xor tree over the warp's 32 lanes
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            a[c] += __shfl_xor_sync(0xffffffffu, a[c], o);
            b[c] += __shfl_xor_sync(0xffffffffu, b[c], o);
          }
        }
        if (lane == 0) {
          T* row = out + 3 * static_cast<size_t>(s_id[2 * p]);
          for (int c = 0; c < 3; ++c) row[c] += a[c];
          if (second) {
            row = out + 3 * static_cast<size_t>(s_id[2 * p + 1]);
            for (int c = 0; c < 3; ++c) row[c] += b[c];
          }
        }
      }
      __syncthreads();   // the tile is restaged
    }
  }
}

template <typename T, bool OPEN>
int launch(const T* pos, const int* table, const int* order,
           const int* starts, T* out, int n, int nx, int ny, int nz, int cap,
           const cellk::Frame& f, double eps_over_b, double c, double c2a,
           void* stream) {
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes<T>(cap);
  const cudaError_t attr = cudaFuncSetAttribute(
      nl_forces_kernel<T, OPEN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Grid g{n, nx, ny, nz, cap};
  nl_forces_kernel<T, OPEN><<<nx * ny * nz, cellk::kThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      pos, table, order, starts, out, g, f,
      Law<T>{T(eps_over_b), T(c), T(c2a)});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos (n,3) wrapped into the box (a wall slab: z clipped below its empty
// guard layer), table (nx ny nz cap,) int32 from ops/cells.cell_bin, out
// (n,3) zeroed by the caller (dropped particles keep their zero row); all
// contiguous on the device; the law's eps / b, c = log2(e) / b and c 2a
// (ops/mobility_cuda.fold_law). Returns the CUDA error code of the launch
// (0 on success).
#define NL_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const T* pos, const int* table, T* out, int n, int nx, \
                      int ny, int nz, int cap, double Lx, double Ly,         \
                      double Lz, double eps_over_b, double c, double c2a,    \
                      void* stream) {                                        \
    const cellk::Frame f{{0.0, 0.0, 0.0}, {Lx / nx, Ly / ny, Lz / nz},       \
                         {Lx, Ly, Lz}};                                      \
    return launch<T, false>(pos, table, nullptr, nullptr, out, n, nx, ny,    \
                            nz, cap, f, eps_over_b, c, c2a, stream);         \
  }

NL_ENTRY(nl_forces_f32, float)
NL_ENTRY(nl_forces_f64, double)

// the open instance: pos (n,3), wrapped on the periodic axes, raw on the
// open ones; table from the binning of ops/forces.py _force_cells; order
// (n,) int32 the particles sorted stably by cell id and starts
// (nx ny nz + 1,) int32 each cell's first entry in order; lo, cs and L
// (3,) host arrays, the frame of cell_sweep.cuh (L 0 on an open axis)
#define NL_OPEN_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* pos, const int* table, const int* order,      \
                      const int* starts, T* out, int n, int nx, int ny,      \
                      int nz, int cap, const double* lo, const double* cs,   \
                      const double* L, double eps_over_b, double c,          \
                      double c2a, void* stream) {                            \
    const cellk::Frame f{{lo[0], lo[1], lo[2]},                              \
                         {cs[0], cs[1], cs[2]},                              \
                         {L[0], L[1], L[2]}};                                \
    return launch<T, true>(pos, table, order, starts, out, n, nx, ny, nz,    \
                           cap, f, eps_over_b, c, c2a, stream);              \
  }

NL_OPEN_ENTRY(nl_forces_open_f32, float)
NL_OPEN_ENTRY(nl_forces_open_f64, double)
