// Kernel K8: the rot-coupling near field of the spectral single-wall
// engine (ops/ewald_wall_rot.py): the tr, rt and rr blocks of the grand
// mobility's real-space part, without tt. Over the pairs 0 < r < r_cut of
// the combined set of 2N points (real rows at (x, y, z - z0), their images
// at (x, y, -z - z0); xy periodic), each real target i sums, from damped
// forces f and torques t of the real particles,
//   - for a real source j (physical z > 0), the two-piece Chebyshev
//     remainders (gamma_r, alpha_r, beta_r) at r = |d|, d = target -
//     source:
//       v += gamma_r t_j x d,
//       w += gamma_r f_j x d + alpha_r t_j + beta_r (d . t_j / r^2) d;
//   - for an image source j (physical z < 0), the screened image channels
//     of the generated img_terms_rt / img_terms_tr / img_terms_rr
//     (wall_img_terms.cuh, from ops/_wall_channels_gen.py) at the
//     displacement d / a, on the raw strengths of the image's real twin:
//       w += pref_c (C0 + h_src C1) f_j,       h_src = -z_src / a,
//       v += pref_c W_rt(h_tgt)^T t_j,         h_tgt = z_tgt / a,
//       w += pref_r W_rr t_j,
//     pref_c = 1/(8 pi eta a^2), pref_r = pref_c / a. The three channels
//     read only the radial values c2_1, c2_2, c2_3 of K7's ten image
//     series (the header's comments say so), so K8 stages and evaluates
//     those three.
// Outputs rows (v, w) of the real particles; the rr self term, the
// overlap damping and tt are the caller's (ops/ewald_wall_rot.py
// grand_near, grand_matvec).
//
// Replaces rigidmultiblobswall_tpu/ops/ewald_wall_rot.py (grand_near_xla),
// an XLA sweep over a pre-gathered (cell, 27, cap) layout, not a Pallas
// kernel.
//
// What bounds it on the H100: float32 instruction issue, and how many
// lanes of a warp do useful work, as for K7. A real-source pair costs three
// K-term Clenshaw series with torques, one (gamma_r) without (K up to 48 at
// the rot remainders' fit), and one or two cross products; an image-source
// pair three Ki-term series and the three generated channels (a few hundred
// operations); the bytes are a few MB.
//
// Design: K7's compacted walk (cell_sweep.cuh: the stencil and target
// staging, and compacted_walk, which queues the pairs inside r_cut of a
// staged tile by kind and evaluates them 32 at a time with every lane
// busy; no atomics, bit-identical on repeat), templated on which of f and
// t are present (the torque solves' rr and tr products carry t only, the
// Lanczos grand product both, the rt product f only). One block per target
// cell of the layers that can hold real particles; the stencil's sources
// staged in the block's local frame (formed in double, rounded once)
// beside their physical z and their real twin's strengths, the cell's real
// targets with their physical z (the tr channel's height). The Chebyshev
// tables sit in shared memory as rows that one 16-byte load reads
// ((gamma_k, alpha_k, beta_k, 0); (c2_1, c2_2, c2_3, 0) of order k); a
// piece is an address, not a branch.

#include "cell_sweep.cuh"
#include "wall_img_terms.cuh"

namespace {

using cellk::Grid;
using cellk::kMaxCheb;
using cellk::kTgt;
using cellk::load_vec;
constexpr int kRing = 128;     // a warp's ring: < 32 left + 64 appended a step
constexpr int kRingSlots = cellk::ring_slots<kRing>();
constexpr int kWarps = cellk::kThreads / 32;
constexpr int kOut = 6;        // a row: v (3), then w (3)

// the rot remainders' table: (2 pieces, 3 functions, K), K at most kMaxRot
// (ops/ewald_wall_rot.py fits K = 24, 32, 40 or 48); rows of four
// (gamma_k, alpha_k, beta_k, 0), the pieces padded so that the two pieces'
// rows of one k fall in different banks
constexpr int kMaxRot = 48;
constexpr int kRotPiece = 4 * kMaxRot + 4;
// the image series c2_1, c2_2, c2_3 (rows 6, 7, 8 of K7's (2, 10, Ki)
// table) as rows of four
constexpr int kImgFirst = 6;
constexpr int kImgPiece = 4 * kMaxCheb + 4;

// sources staged a tile: as K7's
template <typename T>
using Walk = cellk::Walk<T, 1408, 1024>;

// strengths staged per source: f, then t
template <bool HF, bool HT>
constexpr int kStr = 3 * (HF ? 1 : 0) + 3 * (HT ? 1 : 0);

// dynamic shared memory of a launch: tables, the staged tile, a chunk of
// the cell's targets, the two rings of every warp, the target ids
template <typename T, bool HF, bool HT>
size_t smem_bytes(int cap) {
  const int nt = cellk::target_slots(cap);
  return sizeof(T) * (2 * kRotPiece + 2 * kImgPiece +
                      (4 + kStr<HF, HT>) * Walk<T>::kSrc + 4 * nt) +
         (sizeof(unsigned) + sizeof(unsigned short)) * kWarps * kRingSlots +
         sizeof(int) * nt;
}

template <typename T>
__device__ __forceinline__ T clamp_t(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
struct RotScalars {
  int K, Ki;                                   // terms per piece
  T rc2, two_a, mid0, inv_h0, mid1, inv_h1;    // remainder pieces
  T inv_a, pref_c, pref_r;
  T ir_lo, ir_mid, ir_hi, mid_i0, inv_hi0, mid_i1, inv_hi1;  // image r / a
};

// Clenshaw sums of the first NQ series of one piece's rows (four values a
// row) at t, K terms.
template <int NQ, typename T>
__device__ __forceinline__ void clenshaw(const T* rows, int K, T t, T* out) {
  const T t2 = t + t;
  T b1[NQ], b2[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) b1[q] = b2[q] = T(0);
  for (int k = K - 1; k > 0; --k) {
    T c[4];
    if (NQ == 1) c[0] = rows[4 * k]; else load_vec<4>(rows + 4 * k, c);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const T bn = cellk::fma_t(t2, b1[q], c[q] - b2[q]);
      b2[q] = b1[q];
      b1[q] = bn;
    }
  }
  T c[4];
  if (NQ == 1) c[0] = rows[0]; else load_vec<4>(rows, c);
#pragma unroll
  for (int q = 0; q < NQ; ++q) out[q] = cellk::fma_t(t, b1[q], c[q] - b2[q]);
}

// A real-source pair inside r_cut: d = target - source in the local frame;
// s the source's staged strengths (f then t, component q at s[q kS]).
template <typename T, bool HF, bool HT>
__device__ __forceinline__ void real_pair(const RotScalars<T>& sc,
                                          const T* rot, T dx, T dy, T dz,
                                          const T* s, T* acc) {
  constexpr int kS = Walk<T>::kSrc;
  const T r2 = dx * dx + dy * dy + dz * dz;
  const T invr = cellk::rsqrt_t(r2);
  const T r = r2 * invr;
  const bool near = r < sc.two_a;
  const T ts = near ? (r - sc.mid0) * sc.inv_h0 : (r - sc.mid1) * sc.inv_h1;
  // gamma_r, alpha_r, beta_r; without torques only gamma_r is read
  T g[3];
  clenshaw<HT ? 3 : 1>(rot + (near ? 0 : kRotPiece), sc.K, ts, g);
  if (HF) {
    const T fx = s[0], fy = s[kS], fz = s[2 * kS];
    acc[3] += g[0] * (fy * dz - fz * dy);
    acc[4] += g[0] * (fz * dx - fx * dz);
    acc[5] += g[0] * (fx * dy - fy * dx);
  }
  if (HT) {
    constexpr int o = HF ? 3 : 0;
    const T tx = s[o * kS], ty = s[(o + 1) * kS], tz = s[(o + 2) * kS];
    acc[0] += g[0] * (ty * dz - tz * dy);
    acc[1] += g[0] * (tz * dx - tx * dz);
    acc[2] += g[0] * (tx * dy - ty * dx);
    const T b = g[2] * (dx * tx + dy * ty + dz * tz) * invr * invr;
    acc[3] += g[1] * tx + b * dx;
    acc[4] += g[1] * ty + b * dy;
    acc[5] += g[1] * tz + b * dz;
  }
}

// An image-source pair inside r_cut: d as above, zsrc the source's
// physical z, ztgt the target's.
template <typename T, bool HF, bool HT>
__device__ __forceinline__ void image_pair(const RotScalars<T>& sc,
                                           const T* img, T dx, T dy, T dz,
                                           T zsrc, T ztgt, const T* s,
                                           T* acc) {
  constexpr int kS = Walk<T>::kSrc;
  const T r2 = dx * dx + dy * dy + dz * dz;
  const T r = r2 * cellk::rsqrt_t(r2);
  // r / a clamped into the series' domain before evaluation
  const T rs = clamp_t(r * sc.inv_a, sc.ir_lo, sc.ir_hi);
  const bool p0 = rs < sc.ir_mid;
  const T ti = clamp_t(p0 ? (rs - sc.mid_i0) * sc.inv_hi0
                          : (rs - sc.mid_i1) * sc.inv_hi1, T(-1), T(1));
  T c[3];                                      // c2_1, c2_2, c2_3
  clenshaw<3>(img + (p0 ? 0 : kImgPiece), sc.Ki, ti, c);
  const T z = T(0);
  const T dxs = dx * sc.inv_a, dys = dy * sc.inv_a, rzs = dz * sc.inv_a;
  if (HF) {
    T wx, wy, wz;
    wallk::img_terms_rt<T>(dxs, dys, rzs, -zsrc * sc.inv_a, s[0], s[kS],
                           s[2 * kS], z, z, z, z, z, z, c[0], c[1], c[2], z,
                           wx, wy, wz);
    acc[3] += sc.pref_c * wx;
    acc[4] += sc.pref_c * wy;
    acc[5] += sc.pref_c * wz;
  }
  if (HT) {
    constexpr int o = HF ? 3 : 0;
    const T tx = s[o * kS], ty = s[(o + 1) * kS], tz = s[(o + 2) * kS];
    T ux, uy, uz;
    wallk::img_terms_tr<T>(dxs, dys, rzs, ztgt * sc.inv_a, tx, ty, tz, z, z,
                           z, z, z, z, c[0], c[1], c[2], z, ux, uy, uz);
    acc[0] += sc.pref_c * ux;
    acc[1] += sc.pref_c * uy;
    acc[2] += sc.pref_c * uz;
    T wx, wy, wz;
    wallk::img_terms_rr<T>(dxs, dys, rzs, tx, ty, tz, z, z, z, z, z, z,
                           c[0], c[1], c[2], z, wx, wy, wz);
    acc[3] += sc.pref_r * wx;
    acc[4] += sc.pref_r * wy;
    acc[5] += sc.pref_r * wz;
  }
}

template <typename T, bool HF, bool HT>
__global__ void __launch_bounds__(cellk::kThreads, (cellk::min_blocks<T>(2)))
wall_rot_near_kernel(const T* __restrict__ pos, const T* __restrict__ f,
                     const T* __restrict__ t, const int* __restrict__ table,
                     const T* __restrict__ cheb, const T* __restrict__ img,
                     T* __restrict__ out, Grid g, int n_real, int cz_lo,
                     int nkz, double Lx, double Ly, double Lz, double z0,
                     RotScalars<T> sc) {
  constexpr int NS = kStr<HF, HT>;
  constexpr int kSrc = Walk<T>::kSrc;
  constexpr int q0 = HT ? 0 : 3;              // v stays zero without t
  static_assert(kSrc % 64 == 0, "a padded tile holds whole 64-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_rot = reinterpret_cast<T*>(smem);
  T* s_img = s_rot + 2 * kRotPiece;
  T* s_src = s_img + 2 * kImgPiece;           // (kSrc, 4)
  T* s_s = s_src + 4 * kSrc;                  // (NS, kSrc)
  T* s_tgt = s_s + NS * kSrc;                 // (target_slots, 4)
  unsigned* s_ring_i =
      reinterpret_cast<unsigned*>(s_tgt + 4 * cellk::target_slots(g.cap));
  unsigned short* s_ring_r =
      reinterpret_cast<unsigned short*>(s_ring_i + kWarps * kRingSlots);
  int* s_id = reinterpret_cast<int*>(s_ring_r + kWarps * kRingSlots);
  __shared__ cellk::Stencil st;
  __shared__ int s_ntgt;

  for (int i = threadIdx.x; i < 2 * 4 * sc.K; i += blockDim.x) {
    // cheb (2 pieces, 3 functions, K) -> (piece, k, function) rows of 4
    const int p = i / (4 * sc.K), k = (i / 4) % sc.K, fn = i % 4;
    s_rot[p * kRotPiece + 4 * k + fn] =
        fn < 3 ? cheb[(3 * p + fn) * sc.K + k] : T(0);
  }
  for (int i = threadIdx.x; i < 2 * 4 * sc.Ki; i += blockDim.x) {
    // img (2 pieces, 10 series, Ki): series 6..8 -> (piece, k, 4) rows
    const int p = i / (4 * sc.Ki), k = (i / 4) % sc.Ki, q = i % 4;
    s_img[p * kImgPiece + 4 * k + q] =
        q < 3 ? img[(10 * p + kImgFirst + q) * sc.Ki + k] : T(0);
  }
  const int c = (blockIdx.x / nkz) * g.nz + cz_lo + blockIdx.x % nkz;
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
    // the targets' physical z into their rows' w (stage_targets' threads)
    for (int k = threadIdx.x; k < nt; k += blockDim.x)
      s_tgt[4 * k + 3] = T(double(pos[3 * own[t0 + k] + 2]) + z0);
    for (int s0 = 0; s0 < total; s0 += kSrc) {
      const int m = min(kSrc, total - s0);
      cellk::stage_sources(st, table, g, s0, m, [&](int s, int sid, int k) {
        T* row = s_src + 4 * s;
        cellk::local_source(st, pos, sid, k, row);
        row[3] = T(double(pos[3 * sid + 2]) + z0);
        // an image row takes its real twin's strengths
        const size_t src = 3 * static_cast<size_t>(sid < n_real ? sid
                                                                : sid - n_real);
        for (int q = 0; q < 3; ++q) {
          if (HF) s_s[q * kSrc + s] = f[src + q];
          if (HT) s_s[(q + (HF ? 3 : 0)) * kSrc + s] = t[src + q];
        }
      });
      cellk::pad_rows(s_src, m, (m + 63) / 64 * 64);   // whole 64-steps
      __syncthreads();
      cellk::compacted_walk<kRing, kOut, q0>(
          s_src, s_tgt, s_id, m, nt, sc.rc2, ring_r, ring_i, out,
          [&](int j, const T* tgt, T* acc) {
            T src[4];
            load_vec<4>(s_src + 4 * j, src);
            real_pair<T, HF, HT>(sc, s_rot, tgt[0] - src[0], tgt[1] - src[1],
                                 tgt[2] - src[2], s_s + j, acc);
          },
          [&](int te, int j, T* u) {
            T tgt[4], src[4];
            load_vec<4>(s_tgt + 4 * te, tgt);
            load_vec<4>(s_src + 4 * j, src);
            image_pair<T, HF, HT>(sc, s_img, tgt[0] - src[0], tgt[1] - src[1],
                                  tgt[2] - src[2], src[3], tgt[3], s_s + j,
                                  u);
          });
      __syncthreads();   // the tile is restaged
    }
  }
}

template <typename T, bool HF, bool HT>
int launch(const T* pos, const T* f, const T* t, const int* table,
           const T* cheb, const T* img, T* out, int n_real, int nx, int ny,
           int nz, int cap, int K, int Ki, int cz_lo, int cz_hi, double Lx,
           double Ly, double Lz, double two_a, double r_cut, double z0,
           double a, double pref_c, double pref_r, double ir_lo,
           double ir_mid, double ir_hi, void* stream) {
  if (K < 1 || K > kMaxRot || Ki < 1 || Ki > kMaxCheb || cz_lo < 0 ||
      cz_hi >= nz || cz_hi < cz_lo || cap < 1 || (HF && f == nullptr) ||
      (HT && t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the staged tile, the targets and the rings take more than the 48 KB of
  // static shared memory: raise the instance's limit to this launch's size
  const size_t bytes = smem_bytes<T, HF, HT>(cap);
  const cudaError_t attr = cudaFuncSetAttribute(
      wall_rot_near_kernel<T, HF, HT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Grid g{2 * n_real, nx, ny, nz, cap};
  // the remainder pieces: [0, 2a] and [2a, r_cut]; the image pieces split
  // [ir_lo, ir_hi] at ir_mid
  const RotScalars<T> sc{K,
                         Ki,
                         T(r_cut * r_cut),
                         T(two_a),
                         T(0.5 * two_a),
                         T(2.0 / two_a),
                         T(0.5 * (two_a + r_cut)),
                         T(2.0 / (r_cut - two_a)),
                         T(1.0 / a),
                         T(pref_c),
                         T(pref_r),
                         T(ir_lo),
                         T(ir_mid),
                         T(ir_hi),
                         T(0.5 * (ir_mid + ir_lo)),
                         T(2.0 / (ir_mid - ir_lo)),
                         T(0.5 * (ir_hi + ir_mid)),
                         T(2.0 / (ir_hi - ir_mid))};
  const int nkz = cz_hi - cz_lo + 1;
  wall_rot_near_kernel<T, HF, HT><<<nx * ny * nkz, cellk::kThreads, bytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      pos, f, t, table, cheb, img, out, g, n_real, cz_lo, nkz, Lx, Ly, Lz, z0,
      sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos (2 n_real, 3) grid-shifted positions of the reals then their images,
// f and t (n_real, 3) damped forces and torques (either may be null; the
// entry point's name says which it reads), table (nx ny nz cap,) int32 from
// ops/cells.cell_bin over (Lx, Ly, Lz) (sentinel 2 n_real), cheb (2, 3, K)
// the rot remainders' pieces, img (2, 10, Ki) K7's image radial series, out
// (n_real, 6) rows (v, w) zeroed by the caller (dropped particles keep
// their zero row); target cells on the z layers [cz_lo, cz_hi]; all
// contiguous on the device. Returns the CUDA error code of the launch.
#define ROT_ENTRY(NAME, T, HF, HT)                                            \
  extern "C" int NAME(const T* pos, const T* f, const T* t, const int* table, \
                      const T* cheb, const T* img, T* out, int n_real,        \
                      int nx, int ny, int nz, int cap, int K, int Ki,         \
                      int cz_lo, int cz_hi, double Lx, double Ly, double Lz,  \
                      double two_a, double r_cut, double z0, double a,        \
                      double pref_c, double pref_r, double ir_lo,             \
                      double ir_mid, double ir_hi, void* stream) {            \
    return launch<T, HF, HT>(pos, f, t, table, cheb, img, out, n_real, nx,    \
                             ny, nz, cap, K, Ki, cz_lo, cz_hi, Lx, Ly, Lz,    \
                             two_a, r_cut, z0, a, pref_c, pref_r, ir_lo,      \
                             ir_mid, ir_hi, stream);                          \
  }

ROT_ENTRY(wall_rot_near_f32_ft, float, true, true)
ROT_ENTRY(wall_rot_near_f32_f, float, true, false)
ROT_ENTRY(wall_rot_near_f32_t, float, false, true)
ROT_ENTRY(wall_rot_near_f64_ft, double, true, true)
ROT_ENTRY(wall_rot_near_f64_f, double, true, false)
ROT_ENTRY(wall_rot_near_f64_t, double, false, true)
