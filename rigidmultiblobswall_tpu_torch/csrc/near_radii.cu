// Kernel P2: the near-field RPY remainder of the periodic spectral Ewald
// engine with mixed blob radii (ops/ewald.py's mixed-radii mode), for B =
// 1 or 2 stacked right-hand sides,
//   u_i = sum_j alpha_gh(r) f_j + (beta_gh(r) / r^2) (d . f_j) d
// over the pairs with 0 < r^2 < r_cut^2 under the periodic image (d = r_i
// - r_j^image), (g, h) = (group[i], group[j]) the pair's radius groups,
// alpha and beta from the group pair's Chebyshev series in three pieces on
// (0, e1), [e1, e2), [e2, r_cut) with e1 = max(|a_g - a_h|, 1e-3 r_cut)
// and e2 = a_g + a_h (ops/ewald.radii_edge_table). The self term is the
// caller's (ops/ewald.real_matvec).
//
// Replaces no Pallas kernel: the JAX package sums it in XLA
// (rigidmultiblobswall_tpu/ops/ewald.py:1222-1345, the radii branch of
// _xla_near_tile_fn, which evaluates every group pair's three pieces on
// every pair of the 27-cell stencil and masks).
//
// What bounds it on the H100: float32 instruction issue. A pair inside
// r_cut costs its piece map and two K-term Clenshaw series (~158
// operations at K = 20), and only ~14 % of a 27-cell stencil's candidates
// lie inside r_cut. A walk over the stencil (K6's compacted walk,
// csrc/near_rpy.cu) spends most of its instructions on the candidate
// filter, its ring and the per-target flush, and repeats them on every
// product, though the positions do not change across the ~11 products
// that one plan serves.
//
// Design: the pairs are found once a plan, and each product walks them.
// - The pair list (pairs_kernel, a count pass and a fill pass; the
//   wrapper, ops/cell_kernels.near_radii_pairs, scans the counts between
//   them): one block a target cell loads its stencil (cell_sweep.cuh's
//   load_stencil) and stages its sources tile by tile (stage_sources) in
//   double as x_j + shift, shift the stencil cell's wrap count times the
//   box; a warp takes a target, tests 64 candidates a step and places the
//   pairs with 0 < r^2 < r_cut^2 by ballot and popc prefixes, in the
//   stencil's order, into a CSR list: offsets (N + 1) and entries j |
//   code << 27, code = 9 (wx + 1) + 3 (wy + 1) + (wz + 1) the image's wrap
//   counts. No ring and no atomics: a warp owns its target's segment. The
//   test forms r^2 in the product's arithmetic (pair_d), so the list holds
//   exactly the pairs the product evaluates.
// - The product (product_kernel): one warp a target, its lanes striding
//   over the target's segment (93 pairs at the bench plan fill ~97 % of
//   three 32-lane batches), each lane forming d = (double) x_i -
//   ((double) x_j + shift) rounded once to T: a float32 d then carries the
//   rounding of the pair's distance, not of coordinates in a 33.6 box
//   (4e-6), as the walk's local frame does (cell_sweep.cuh). Then the
//   piece by r < e1, r < e2 and one Clenshaw recurrence per function from
//   the (G, G, 3) table staged in shared memory as K6's 16-byte rows
//   (cellk::series2). A source is one 16-byte row of rows (N, 4), its
//   position with its group in w, and its strengths, gathered through L1
//   and L2 (both fit the 50 MB L2 at the bench plan). The lanes' sums
//   reduce in a fixed xor tree and lane q writes component q of the row:
//   every row written once, no atomics, bit-identical on repeat. The
//   blocks are persistent (as many as fit the card): each stages the
//   table once and walks the targets a warp at a time.

#include "cell_sweep.cuh"

namespace {

using cellk::Grid;
using cellk::kChebPiece;
using cellk::kMaxCheb;
using cellk::kTgt;

constexpr int kThreads = cellk::kThreads;   // both kernels' blocks
constexpr int kCodeShift = 27;              // j below, the image code above
constexpr unsigned kIdMask = (1u << kCodeShift) - 1u;
constexpr int kCodes = 27;                  // wrap counts (-1..1)^3
constexpr int kRows = 1024;                 // sources a list tile stages
constexpr int kMaxGroups = 8;

// The image shift of `code`, (code / 9 - 1, code / 3 % 3 - 1, code % 3 - 1)
// times the box: exact in double (a wrap count is -1, 0 or 1).
__device__ __forceinline__ void image_shift(unsigned code, double Lx,
                                            double Ly, double Lz,
                                            double* sh) {
  sh[0] = double(static_cast<int>(code / 9) - 1) * Lx;
  sh[1] = double(static_cast<int>(code / 3 % 3) - 1) * Ly;
  sh[2] = double(static_cast<int>(code % 3) - 1) * Lz;
}

// d = x_i - s rounded once to T (x_i the target and s = (double) x_j +
// shift the source image, both in double) and r^2 = |d|^2 in T with fixed
// multiply-adds: the list's test and the product's pair take this same
// arithmetic.
template <typename T>
__device__ __forceinline__ T pair_d(const double* xi, double sx, double sy,
                                    double sz, T* d) {
  d[0] = T(xi[0] - sx);
  d[1] = T(xi[1] - sy);
  d[2] = T(xi[2] - sz);
  return cellk::fma_t(d[0], d[0], cellk::fma_t(d[1], d[1], d[2] * d[2]));
}

// ------------------------------------------------------------ the list

// One block: target cell blockIdx.x. FILL false: count[i] = the pairs of
// each target i of the cell; FILL true: its pairs into entries[offsets[i]
// ..], in the stencil's order.
template <typename T, bool FILL>
__global__ void __launch_bounds__(kThreads)
pairs_kernel(const T* __restrict__ pos, const int* __restrict__ table,
             int* __restrict__ count, const int* __restrict__ offsets,
             unsigned* __restrict__ entries, Grid g, double Lx, double Ly,
             double Lz, T rc2) {
  __shared__ cellk::Stencil st;
  __shared__ double s_xyz[3][kRows];  // the staged sources' x_j + shift
  __shared__ unsigned s_key[kRows];   // their entries
  __shared__ int s_id[kTgt];
  __shared__ unsigned s_run[kTgt];   // a target's pairs so far
  double* s_x = s_xyz[0];
  double* s_y = s_xyz[1];
  double* s_z = s_xyz[2];
  unsigned* keys = s_key;

  const int c = blockIdx.x;
  if (cellk::empty_cell(table, c, g)) return;              // uniform
  cellk::load_stencil(st, table, c, g, Lx, Ly, Lz);       // a barrier
  const int c3[3] = {c / (g.ny * g.nz), (c / g.nz) % g.ny, c % g.nz};
  const int dims[3] = {g.nx, g.ny, g.nz};
  const int n_tgt = st.start[14] - st.start[13];
  const int* own = table + static_cast<size_t>(st.cell[13]) * g.cap;
  const int total = st.start[27];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const unsigned lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one

  // the cell's targets kTgt at a time
  for (int t0 = 0; t0 < n_tgt; t0 += kTgt) {
    const int nt = min(kTgt, n_tgt - t0);
    for (int t = threadIdx.x; t < nt; t += blockDim.x) {
      s_id[t] = own[t0 + t];
      s_run[t] = 0;
    }
    for (int s0 = 0; s0 < total; s0 += kRows) {
      const int m = min(kRows, total - s0);
      cellk::stage_sources(st, table, g, s0, m, [&](int s, int id, int k) {
        const int off[3] = {k / 9 - 1, (k / 3) % 3 - 1, k % 3 - 1};
        unsigned code = 0;
        for (int a = 0; a < 3; ++a) {
          const int raw = c3[a] + off[a];
          const int wrap = raw < 0 ? -1 : (raw >= dims[a] ? 1 : 0);
          code = 3 * code + static_cast<unsigned>(wrap + 1);
        }
        double sh[3];
        image_shift(code, Lx, Ly, Lz, sh);
        s_x[s] = double(pos[3 * id + 0]) + sh[0];
        s_y[s] = double(pos[3 * id + 1]) + sh[1];
        s_z[s] = double(pos[3 * id + 2]) + sh[2];
        keys[s] = static_cast<unsigned>(id) | code << kCodeShift;
      });
      __syncthreads();
      for (int t = warp; t < nt; t += warps) {
        const int i = s_id[t];
        const double xi[3] = {double(pos[3 * i + 0]), double(pos[3 * i + 1]),
                              double(pos[3 * i + 2])};
        unsigned run = s_run[t];                 // uniform across the warp
        unsigned* seg = nullptr;
        if constexpr (FILL) seg = entries + offsets[i];
        // 64 candidates a step, as two independent halves of 32
        for (int c0 = 0; c0 < m; c0 += 64) {
          bool in[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int s = c0 + 32 * q + static_cast<int>(lane);
            in[q] = false;
            if (s < m) {
              T d[3];
              const T r2 = pair_d<T>(xi, s_x[s], s_y[s], s_z[s], d);
              in[q] = r2 > T(0) && r2 < rc2;
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const unsigned mask = __ballot_sync(0xffffffffu, in[q]);
            if constexpr (FILL) {
              if (in[q])
                seg[run + __popc(mask & below)] =
                    s_key[c0 + 32 * q + static_cast<int>(lane)];
            }
            run += __popc(mask);
          }
        }
        if (lane == 0) s_run[t] = run;
      }
      __syncthreads();   // the tile is restaged; the runs are read again
    }
    if constexpr (!FILL) {
      for (int t = threadIdx.x; t < nt; t += blockDim.x)
        count[s_id[t]] = static_cast<int>(s_run[t]);
    }
    __syncthreads();   // the ids and runs are read before the next chunk
  }
}

template <typename T>
int launch_pairs(const T* pos, const int* table, int* count,
                 const int* offsets, unsigned* entries, int n, int nx,
                 int ny, int nz, int cap, double Lx, double Ly, double Lz,
                 double r_cut, int fill, void* stream) {
  if (cap < 1 || n < 0 || n > static_cast<int>(kIdMask) ||
      (fill != 0 && offsets == nullptr) || (fill == 0 && count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{n, nx, ny, nz, cap};
  const T rc2 = T(r_cut * r_cut);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fill != 0)
    pairs_kernel<T, true><<<nx * ny * nz, kThreads, 0, s>>>(
        pos, table, count, offsets, entries, g, Lx, Ly, Lz, rc2);
  else
    pairs_kernel<T, false><<<nx * ny * nz, kThreads, 0, s>>>(
        pos, table, count, offsets, entries, g, Lx, Ly, Lz, rc2);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------- the product

// shared-memory values of the tables: the (G, G, 3) pieces' series rows
// and their (G, G, 8) piece maps (a multiple of 16 bytes, so the shift
// table after them stays aligned)
__host__ __device__ constexpr int table_len(int G) {
  return 3 * G * G * kChebPiece + 8 * G * G;
}

// The tables: cheb (G, G, 3 pieces, 2 functions, K) staged as K6's rows,
// one row block of kChebPiece a (g, h, piece), zero-padded to
// even_terms(K) terms, then the piece maps edges (G, G, 8). No barrier.
template <typename T>
__device__ __forceinline__ void stage_radii(const T* __restrict__ cheb,
                                            const T* __restrict__ edges,
                                            int K, int G, T* rows) {
  const int K2 = cellk::even_terms(K);
  const int pieces = 3 * G * G;
  for (int i = threadIdx.x; i < pieces * 2 * K2; i += blockDim.x) {
    const int p = i / (2 * K2), k = (i / 2) % K2, fn = i % 2;
    rows[p * kChebPiece + 2 * k + fn] =
        k < K ? cheb[(2 * p + fn) * K + k] : T(0);
  }
  T* maps = rows + pieces * kChebPiece;
  for (int i = threadIdx.x; i < 8 * G * G; i += blockDim.x) maps[i] = edges[i];
}

// alpha(r) and beta(r) / r^2 of the groups gt, gs at r (invr = 1 / r)
// from the staged tables: the piece by r < e1, r < e2, t = (r - mid)
// (2 / width), then the piece's two series
template <typename T>
__device__ __forceinline__ void eval_radii(const T* rows, int K2, int G,
                                           T r, T invr, int gt, int gs,
                                           T& al, T& bfac) {
  const int gp = gt * G + gs;
  const T* e = rows + 3 * G * G * kChebPiece + 8 * gp;
  const int piece = r < e[0] ? 0 : (r < e[1] ? 1 : 2);
  const T ts = (r - e[2 + 2 * piece]) * e[3 + 2 * piece];
  T be;
  cellk::series2(rows + (3 * gp + piece) * kChebPiece, K2, ts, al, be);
  bfac = be * invr * invr;
}

// resident 256-thread blocks an SM that __launch_bounds__ asks for: float32
// four (64 registers); float64 uncapped
template <typename T, int B>
__global__ void __launch_bounds__(kThreads, (cellk::min_blocks<T>(4)))
product_kernel(const T* __restrict__ rows, const T* __restrict__ f,
               const int* __restrict__ offsets,
               const unsigned* __restrict__ entries,
               const T* __restrict__ cheb, const T* __restrict__ edges,
               T* __restrict__ out, int n, int K, int G, double Lx,
               double Ly, double Lz, int t0, int t1) {
  constexpr int NF = 3 * B;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  double* s_shift = reinterpret_cast<double*>(s_tab + table_len(G));
  stage_radii(cheb, edges, K, G, s_tab);
  for (int c = threadIdx.x; c < kCodes; c += blockDim.x)
    image_shift(static_cast<unsigned>(c), Lx, Ly, Lz, s_shift + 3 * c);
  __syncthreads();
  const int K2 = cellk::even_terms(K);
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32;

  // targets [t0, t1) (a rank's share, or every target), one warp each
  for (int i = t0 + blockIdx.x * warps + threadIdx.x / 32; i < t1;
       i += gridDim.x * warps) {
    T ti[4];
    cellk::load_vec<4>(rows + 4 * static_cast<size_t>(i), ti);
    const double xi[3] = {double(ti[0]), double(ti[1]), double(ti[2])};
    const int gi = static_cast<int>(ti[3]);
    const int e1 = offsets[i + 1];
    T acc[NF];
#pragma unroll
    for (int q = 0; q < NF; ++q) acc[q] = T(0);
    for (int e = offsets[i] + lane; e < e1; e += 32) {
      const unsigned key = entries[e];
      const int j = static_cast<int>(key & kIdMask);
      const double* sh = s_shift + 3 * (key >> kCodeShift);
      T s[4];
      cellk::load_vec<4>(rows + 4 * static_cast<size_t>(j), s);
      T d[3];
      const T r2 = pair_d<T>(xi, double(s[0]) + sh[0], double(s[1]) + sh[1],
                             double(s[2]) + sh[2], d);
      const T invr = cellk::rsqrt_t(r2);
      T al, bfac;
      eval_radii(s_tab, K2, G, r2 * invr, invr, gi, static_cast<int>(s[3]),
                 al, bfac);
      const T* fj = f + static_cast<size_t>(NF) * j;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const T fx = fj[3 * b + 0], fy = fj[3 * b + 1], fz = fj[3 * b + 2];
        const T gd = bfac * (d[0] * fx + d[1] * fy + d[2] * fz);
        acc[3 * b + 0] += al * fx + gd * d[0];
        acc[3 * b + 1] += al * fy + gd * d[1];
        acc[3 * b + 2] += al * fz + gd * d[2];
      }
    }
    // the row: a fixed xor tree over the warp's lanes, component q from
    // lane q
    T* row = out + static_cast<size_t>(NF) * i;
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      T v = acc[q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == q) row[q] = v;
    }
  }
}

template <typename T, int B>
int launch_product(const T* rows, const T* f, const int* offsets,
                   const unsigned* entries, const T* cheb, const T* edges,
                   T* out, int n, int K, int G, double Lx, double Ly,
                   double Lz, int t0, int t1, void* stream) {
  if (K < 1 || K > kMaxCheb || G < 1 || G > kMaxGroups || n < 0 || t0 < 0 ||
      t1 < t0 || t1 > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t1 == t0) return 0;
  // the tables take up to 108 KB in float64 at G = 8: raise the
  // instance's limit of dynamic shared memory to this launch's size
  const size_t bytes = sizeof(T) * table_len(G) + sizeof(double) * 3 * kCodes;
  cudaError_t err = cudaFuncSetAttribute(
      product_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: as many as fit the card, none without a target
  int dev = 0, n_sm = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, product_kernel<T, B>, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = kThreads / 32;
  const long long want =
      (static_cast<long long>(t1 - t0) + warps - 1) / warps;
  const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                        (n_sm > 0 ? n_sm : 1);
  const int grid = static_cast<int>(want < fit ? want : fit);
  product_kernel<T, B><<<grid, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      rows, f, offsets, entries, cheb, edges, out, n, K, G, Lx, Ly, Lz, t0,
      t1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The list of one plan: pos (n,3) the plan's positions, table (nx ny nz
// cap,) int32 from ops/cells.cell_bin; fill 0: count (n,) int32 zeroed by
// the caller receives each target's pairs (a particle dropped by overflow
// keeps 0); fill 1: offsets (n+1,) int32, the exclusive scan of those
// counts, and entries (offsets[n],) receives the pairs, j | image code <<
// 27; all contiguous on the device, n < 2^27. Returns the CUDA error code
// of the launch.
#define PAIRS_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* pos, const int* table, int* count,           \
                      const int* offsets, unsigned* entries, int n, int nx, \
                      int ny, int nz, int cap, double Lx, double Ly,        \
                      double Lz, double r_cut, int fill, void* stream) {    \
    return launch_pairs<T>(pos, table, count, offsets, entries, n, nx, ny,  \
                           nz, cap, Lx, Ly, Lz, r_cut, fill, stream);       \
  }

PAIRS_ENTRY(near_radii_pairs_f32, float)
PAIRS_ENTRY(near_radii_pairs_f64, double)

// The product: rows (n,4) the list's positions with the radius group in w,
// f (n,3B) b-major columns, offsets and entries the list, cheb (G,G,3,2,K)
// and edges (G,G,8) (ops/ewald.radii_edge_table); out (n,3B), the rows of
// the targets [t0, t1) written (every row for [0, n); a rank's share
// leaves the others as the caller set them); all contiguous on the device.
#define PRODUCT_ENTRY(NAME, T, B)                                            \
  extern "C" int NAME(const T* rows, const T* f, const int* offsets,        \
                      const unsigned* entries, const T* cheb,               \
                      const T* edges, T* out, int n, int K, int G,          \
                      double Lx, double Ly, double Lz, int t0, int t1,      \
                      void* stream) {                                       \
    return launch_product<T, B>(rows, f, offsets, entries, cheb, edges, out, \
                                n, K, G, Lx, Ly, Lz, t0, t1, stream);       \
  }

PRODUCT_ENTRY(near_rpy_radii_f32_b1, float, 1)
PRODUCT_ENTRY(near_rpy_radii_f32_b2, float, 2)
PRODUCT_ENTRY(near_rpy_radii_f64_b1, double, 1)
PRODUCT_ENTRY(near_rpy_radii_f64_b2, double, 2)
