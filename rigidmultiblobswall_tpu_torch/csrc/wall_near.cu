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
// Design: one block per target cell of the layers that can hold real
// particles ([cz_lo, cz_hi]); the image-only layers are never launched. The
// real targets are a prefix of a cell's live slots (cell_bin keeps ids in
// ascending order and the reals are ids < n_real), so image targets are
// never swept. kLanes threads share a target and reduce in a fixed shuffle
// tree: no atomics, deterministic. Positions enter the pair loop in the
// block's local frame (relative to the target cell's corner, formed in
// double, rounded once); the image test and h need the source's ABSOLUTE
// physical z, staged beside it, formed in double and rounded once. The
// stencil's z wrap only reaches the empty guard layer on top of the slab
// (ops/ewald_wall.make_wall_plan), so the wrap shift never enters a pair.
//
// What bounds it on the H100: float32 instruction throughput. A pair inside
// r_cut costs the RPY remainder's two K-term Clenshaw series; a pair with
// an image source adds ten Ki-term series (10 x 3 Ki flops, Ki = 24 at
// bench.py's tolerance) and img_terms (~330 flops a right-hand side); the
// bytes are a few MB. The coefficient tables sit in shared memory, loaded
// once per block.

#include "cell_sweep.cuh"
#include "wall_img_terms.cuh"

namespace {

using cellk::Grid;

constexpr int kMaxCheb = 32;   // terms per piece of either table
constexpr int kImg = 10;       // radial series of the image channels

template <typename T>
__device__ __forceinline__ T clamp_t(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
struct WallScalars {
  int K, Ki;                                   // terms per piece
  T rc2, two_a, mid0, inv_h0, mid1, inv_h1;    // RPY remainder pieces
  T inv_a, pref_img;
  T ir_lo, ir_mid, ir_hi, mid_i0, inv_hi0, mid_i1, inv_hi1;  // image r / a
};

// One (target, source) pair: d = target - source in the local frame, zabs
// the source's physical z, f the source's raw strengths (3B).
template <typename T, int B>
__device__ __forceinline__ void wall_pair(const WallScalars<T>& sc,
                                          const T* cheb, const T* img, T dx,
                                          T dy, T dz, T zabs, const T* f,
                                          T* acc) {
  const T r2 = dx * dx + dy * dy + dz * dz;
  if (!(r2 > T(0) && r2 < sc.rc2)) return;
  const T invr = cellk::rsqrt_t(r2);
  const T r = r2 * invr;
  // ---- RPY remainder on mirrored strengths
  const bool near = r < sc.two_a;
  const T* ca = cheb + (near ? 0 : 2 * sc.K);
  const T* cb = ca + sc.K;
  const T ts = near ? (r - sc.mid0) * sc.inv_h0 : (r - sc.mid1) * sc.inv_h1;
  const T t2 = ts + ts;
  T a1 = T(0), a2 = T(0), b1 = T(0), b2 = T(0);
  for (int k = sc.K - 1; k > 0; --k) {
    const T an = t2 * a1 - a2 + ca[k];
    const T bn = t2 * b1 - b2 + cb[k];
    a2 = a1;
    a1 = an;
    b2 = b1;
    b1 = bn;
  }
  const T al = ts * a1 - a2 + ca[0];
  const T bfac = (ts * b1 - b2 + cb[0]) * invr * invr;
  const bool src_img = zabs < T(0);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const T fx = src_img ? -f[3 * b + 0] : f[3 * b + 0];
    const T fy = src_img ? -f[3 * b + 1] : f[3 * b + 1];
    const T fz = f[3 * b + 2];
    const T g = bfac * (dx * fx + dy * fy + dz * fz);
    acc[3 * b + 0] += al * fx + g * dx;
    acc[3 * b + 1] += al * fy + g * dy;
    acc[3 * b + 2] += al * fz + g * dz;
  }
  if (!src_img) return;
  // ---- screened image channels, in units of a; r / a clamped into the
  // series' domain before evaluation
  const T hs = -zabs * sc.inv_a;
  const T rs = clamp_t(r * sc.inv_a, sc.ir_lo, sc.ir_hi);
  const bool p0 = rs < sc.ir_mid;
  const T ti = clamp_t(p0 ? (rs - sc.mid_i0) * sc.inv_hi0
                          : (rs - sc.mid_i1) * sc.inv_hi1, T(-1), T(1));
  const T ti2 = ti + ti;
  const T* c = img + (p0 ? 0 : kImg * sc.Ki);
  T c1[kImg], c2[kImg];
#pragma unroll
  for (int q = 0; q < kImg; ++q) c1[q] = c2[q] = T(0);
  for (int k = sc.Ki - 1; k > 0; --k) {
#pragma unroll
    for (int q = 0; q < kImg; ++q) {
      const T cn = ti2 * c1[q] - c2[q] + c[q * sc.Ki + k];
      c2[q] = c1[q];
      c1[q] = cn;
    }
  }
  T cv[kImg];
#pragma unroll
  for (int q = 0; q < kImg; ++q) cv[q] = ti * c1[q] - c2[q] + c[q * sc.Ki];
  const T dxs = dx * sc.inv_a, dys = dy * sc.inv_a, rzs = dz * sc.inv_a;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    T ux, uy, uz;
    wallk::img_terms<T>(dxs, dys, rzs, hs, f[3 * b + 0], f[3 * b + 1],
                        f[3 * b + 2], T(1), cv[0], cv[1], cv[2], cv[3],
                        cv[4], cv[5], cv[6], cv[7], cv[8], cv[9], ux, uy,
                        uz);
    acc[3 * b + 0] += sc.pref_img * ux;
    acc[3 * b + 1] += sc.pref_img * uy;
    acc[3 * b + 2] += sc.pref_img * uz;
  }
}

template <typename T, int B>
__global__ void __launch_bounds__(cellk::kThreads)
wall_near_kernel(const T* __restrict__ pos, const T* __restrict__ f,
                 const int* __restrict__ table, const T* __restrict__ cheb,
                 const T* __restrict__ img, T* __restrict__ out, Grid g,
                 int n_real, int cz_lo, int nkz, double Lx, double Ly,
                 double Lz, double z0, WallScalars<T> sc) {
  constexpr int NF = 3 * B;
  using cellk::kLanes;
  using cellk::kTargets;
  using cellk::kTile;
  __shared__ cellk::Stencil st;
  __shared__ T s_cheb[4 * kMaxCheb];
  __shared__ T s_img[2 * kImg * kMaxCheb];
  __shared__ T s_pos[3][kTile];
  __shared__ T s_z[kTile];
  __shared__ T s_f[NF][kTile];
  __shared__ int s_ntgt;
  for (int i = threadIdx.x; i < 4 * sc.K; i += blockDim.x) s_cheb[i] = cheb[i];
  for (int i = threadIdx.x; i < 2 * kImg * sc.Ki; i += blockDim.x)
    s_img[i] = img[i];
  const int c = (blockIdx.x / nkz) * g.nz + cz_lo + blockIdx.x % nkz;
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
    T acc[NF];
#pragma unroll
    for (int q = 0; q < NF; ++q) acc[q] = T(0);
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
        s_z[threadIdx.x] = T(double(pos[3 * sid + 2]) + z0);
        // an image row reuses its real twin's raw strengths
        const int src = sid < n_real ? sid : sid - n_real;
        for (int q = 0; q < NF; ++q)
          s_f[q][threadIdx.x] = f[static_cast<size_t>(NF) * src + q];
      }
      __syncthreads();
      if (active) {
        // per-tile partial sums keep the f32 rounding of long sums down
        T part[NF];
#pragma unroll
        for (int q = 0; q < NF; ++q) part[q] = T(0);
        const int m = min(kTile, total - s0);
        for (int j = lane; j < m; j += kLanes) {
          T fj[NF];
#pragma unroll
          for (int q = 0; q < NF; ++q) fj[q] = s_f[q][j];
          wall_pair<T, B>(sc, s_cheb, s_img, tx - s_pos[0][j],
                          ty - s_pos[1][j], tz - s_pos[2][j], s_z[j], fj,
                          part);
        }
#pragma unroll
        for (int q = 0; q < NF; ++q) acc[q] += part[q];
      }
      __syncthreads();
    }
    // the kLanes lanes of a target sit in one warp: a fixed xor tree
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      T v = acc[q];
      for (int o = kLanes / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[q] = v;
    }
    if (active && lane == 0) {
      for (int q = 0; q < NF; ++q)
        out[static_cast<size_t>(NF) * tid + q] = acc[q];
    }
  }
}

template <typename T, int B>
int launch(const T* pos, const T* f, const int* table, const T* cheb,
           const T* img, T* out, int n_real, int nx, int ny, int nz, int cap,
           int K, int Ki, int cz_lo, int cz_hi, double Lx, double Ly,
           double Lz, double two_a, double r_cut, double z0, double a,
           double pref_img, double ir_lo, double ir_mid, double ir_hi,
           void* stream) {
  if (K < 1 || K > kMaxCheb || Ki < 1 || Ki > kMaxCheb || cz_lo < 0 ||
      cz_hi >= nz || cz_hi < cz_lo)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{2 * n_real, nx, ny, nz, cap};
  // piece 0: mid = half = a; piece 1: mid = (2a + r_cut) / 2,
  // half = (r_cut - 2a) / 2; the image pieces split [ir_lo, ir_hi] at ir_mid
  const WallScalars<T> sc{
      K, Ki, T(r_cut * r_cut), T(two_a), T(0.5 * two_a), T(2.0 / two_a),
      T(0.5 * (two_a + r_cut)), T(2.0 / (r_cut - two_a)), T(1.0 / a),
      T(pref_img), T(ir_lo), T(ir_mid), T(ir_hi), T(0.5 * (ir_mid + ir_lo)),
      T(2.0 / (ir_mid - ir_lo)), T(0.5 * (ir_hi + ir_mid)),
      T(2.0 / (ir_hi - ir_mid))};
  const int nkz = cz_hi - cz_lo + 1;
  wall_near_kernel<T, B><<<nx * ny * nkz, cellk::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      pos, f, table, cheb, img, out, g, n_real, cz_lo, nkz, Lx, Ly, Lz, z0,
      sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos (2 n_real, 3) grid-shifted positions of the reals then their images,
// f (n_real, 3B) raw strengths, b-major columns, table (nx ny nz cap,) int32
// from ops/cells.cell_bin over (Lx, Ly, Lz) (sentinel 2 n_real), cheb
// (2, 2, K) the RPY remainder's pieces, img (2, 10, Ki) the image radial
// series, out (n_real, 3B) zeroed by the caller (dropped particles keep
// their zero row); target cells on the z layers [cz_lo, cz_hi]; all
// contiguous on the device. Returns the CUDA error code of the launch.
#define WALL_ENTRY(NAME, T, B)                                                \
  extern "C" int NAME(const T* pos, const T* f, const int* table,            \
                      const T* cheb, const T* img, T* out, int n_real,       \
                      int nx, int ny, int nz, int cap, int K, int Ki,        \
                      int cz_lo, int cz_hi, double Lx, double Ly, double Lz, \
                      double two_a, double r_cut, double z0, double a,       \
                      double pref_img, double ir_lo, double ir_mid,          \
                      double ir_hi, void* stream) {                          \
    return launch<T, B>(pos, f, table, cheb, img, out, n_real, nx, ny, nz,   \
                        cap, K, Ki, cz_lo, cz_hi, Lx, Ly, Lz, two_a, r_cut,  \
                        z0, a, pref_img, ir_lo, ir_mid, ir_hi, stream);      \
  }

WALL_ENTRY(wall_near_f32_b1, float, 1)
WALL_ENTRY(wall_near_f32_b2, float, 2)
WALL_ENTRY(wall_near_f64_b1, double, 1)
WALL_ENTRY(wall_near_f64_b2, double, 2)
