// Kernel K8: the rot-coupling near field of the spectral single-wall
// engine (ops/ewald_wall_rot.py): the tr, rt and rr blocks of the grand
// mobility's real-space part, without tt. Over the pairs 0 < r < r_cut of
// the combined set of 2N points (real rows at (x, y, z - z0), their images
// at (x, y, -z - z0); xy periodic), each real target i sums, from damped
// forces f and torques t of the real particles,
//   - for a real source j (physical z > 0), the two-piece Chebyshev
//     remainders (gamma_r, alpha_r, beta_r) at r = |d|, d = target -
//     source:
//       tr: v += gamma_r t_j x d,
//       rt: w += gamma_r f_j x d,
//       rr: w += alpha_r t_j + beta_r (d . t_j / r^2) d;
//   - for an image source j (physical z < 0), the screened image channels
//     of the generated img_terms_rt / img_terms_tr / img_terms_rr
//     (wall_img_terms.cuh, from ops/_wall_channels_gen.py) at the
//     displacement d / a, on the raw strengths of the image's real twin:
//       rt: w += pref_c (C0 + h_src C1) f_j,   h_src = -z_src / a,
//       tr: v += pref_c W_rt(h_tgt)^T t_j,     h_tgt = z_tgt / a,
//       rr: w += pref_r W_rr t_j,
//     pref_c = 1/(8 pi eta a^2), pref_r = pref_c / a. The channels read the
//     radial values c2_1, c2_2 and (rt, tr) c2_3 of K7's ten image series
//     (the header's comments say so), so K8 stages and evaluates those.
// An instance forms one product (rt, tr or rr) or all three (grand, from
// f and t: v = tr, w = rt + rr), and writes only the columns of its
// output: rt and rr the w half of a row (v, w), tr the v half. The rr self
// term, the overlap damping and tt are the caller's (ops/ewald_wall_rot.py
// grand_near, grand_matvec).
//
// Replaces rigidmultiblobswall_tpu/ops/ewald_wall_rot.py (grand_near_xla),
// an XLA sweep over a pre-gathered (cell, 27, cap) layout, not a Pallas
// kernel.
//
// What bounds it on the H100: latency and float32 instruction throughput;
// the bytes are a few MB. At the wall rollers' plan (32,768 rollers, cells
// of ~21 real targets and ~390 stencil sources, K = 32, Ki = 20), a one-
// product launch takes ~0.11 ms (tools/torch_profile_kernels.py --kernels
// k8, H100 80GB HBM3): ~0.025 ms with no pair evaluated (the stencil, the
// staging, the launch), ~0.035 more to filter the candidates, ~0.017 for
// the real pairs and ~0.03 for the image pairs, at a tenth of its
// operation bound. A Clenshaw term costs in proportion to its
// instructions: the series are bound by instruction throughput, not by
// their shared-memory loads' latency.
//
// Design: cell_sweep.cuh's split walk. One block per target cell of the
// layers that can hold real particles; the stencil's sources staged in
// the block's local frame (formed in double, rounded once) beside their
// physical z and their real twin's strengths, the stencil's real sources
// first and its image sources after them (split_reals, stage_split), so
// that a 64-candidate step tests distances alone and appends to one ring
// (split_walk; no atomics, bit-identical on repeat). One instance a
// product, so a launch evaluates only the series its product reads:
// gamma_r alone for rt and tr, alpha_r and beta_r for rr, all three for
// grand on real pairs; c2_1 and c2_2 for rr, c2_1..c2_3 otherwise on image
// pairs. The Chebyshev tables sit in shared memory zero-padded at the top
// to a multiple of kGroup = 8 terms (a leading zero coefficient leaves the
// Clenshaw state exactly zero, so the padded sum is the unpadded one, bit
// for bit), each piece's terms as rows of the series read, so one 16-byte
// load reads 4 / NQ terms; the series runs unrolled by 8, the next group's
// coefficients loaded while the current group's multiply-adds run, in
// Clenshaw's order of operations (fma(2t, b1, c_k - b2)).

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
constexpr int kGroup = 8;      // Clenshaw terms a group: the unroll width

// the rot remainders' table: (2 pieces, 3 functions, K), K at most kMaxRot
// (ops/ewald_wall_rot.py fits K = 24, 32, 40 or 48)
constexpr int kMaxRot = 48;
// the image series c2_1, c2_2, c2_3: rows 6, 7, 8 of K7's (2, 10, Ki) table
constexpr int kImgFirst = 6;

// sources staged a tile (a bench-size stencil holds ~390), with room for
// a split tile's padding: 1024 in float32 and float64, so that four
// blocks of the grand instance fit an SM's shared memory
template <typename T>
using Walk = cellk::Walk<T, 1024, 1024>;
template <typename T>
constexpr int kSrcRows = Walk<T>::kSrc + 64;

// the products an instance forms
enum { kGrand, kRt, kTr, kRr };

template <int P>
struct Prod {
  static constexpr bool kRtOn = P == kGrand || P == kRt;   // w from f
  static constexpr bool kTrOn = P == kGrand || P == kTr;   // v from t
  static constexpr bool kRrOn = P == kGrand || P == kRr;   // w from t
  static constexpr bool kHasF = kRtOn;
  static constexpr bool kHasT = kTrOn || kRrOn;
  // strengths staged per source: f, then t
  static constexpr int kNS = 3 * kHasF + 3 * kHasT;
  static constexpr int kTo = kHasF ? 3 : 0;      // t's first row of them
  // outputs formed: v then w for grand, one of them otherwise, from
  // column kCol of a row (v, w)
  static constexpr int kNO = P == kGrand ? 6 : 3;
  static constexpr int kCol = P == kRt || P == kRr ? 3 : 0;
  static constexpr int kWo = P == kGrand ? 3 : 0;  // w's first output
  // rot series read: functions kRot0 .. kRot0 + kNR - 1 of (gamma_r,
  // alpha_r, beta_r)
  static constexpr int kNR = P == kGrand ? 3 : (P == kRr ? 2 : 1);
  static constexpr int kRot0 = P == kRr ? 1 : 0;
  // image series read: c2_1 .. c2_kNI
  static constexpr int kNI = P == kRr ? 2 : 3;
  // a piece's rows: the padded terms of its series, and 4 more values so
  // that the two pieces' rows of one term fall in different banks
  static constexpr int kRotPiece = kMaxRot * kNR + 4;
  static constexpr int kImgPiece = kMaxCheb * kNI + 4;
};

// dynamic shared memory of a launch: tables, the staged tile, a chunk of
// the cell's targets, the two rings of every warp, the target ids
template <typename T, int P>
size_t smem_bytes(int cap) {
  using Pr = Prod<P>;
  const int nt = cellk::target_slots(cap);
  return sizeof(T) * (2 * Pr::kRotPiece + 2 * Pr::kImgPiece +
                      4 * kSrcRows<T> + Pr::kNS * Walk<T>::kSrc + 4 * nt) +
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
  int groups, groups_i;                        // padded: kGroup-term groups
  T rc2, two_a, mid0, inv_h0, mid1, inv_h1;    // remainder pieces
  T inv_a, pref_c, pref_r;
  T ir_lo, ir_mid, ir_hi, mid_i0, inv_hi0, mid_i1, inv_hi1;  // image r / a
};

// kGroup Clenshaw steps of NQ series on a group's coefficients c (term k
// of series q at c[NQ k + q]), its top term first.
template <int NQ, typename T>
__device__ __forceinline__ void clenshaw_steps(const T* c, T t2, T* b1,
                                               T* b2) {
#pragma unroll
  for (int k = kGroup - 1; k >= 0; --k) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const T bn = cellk::fma_t(t2, b1[q], c[NQ * k + q] - b2[q]);
      b2[q] = b1[q];
      b1[q] = bn;
    }
  }
}

// The lowest group: its terms kGroup - 1 .. 1 as steps, term 0 closing
// the sum, out = fma(t, b1, c_0 - b2).
template <int NQ, typename T>
__device__ __forceinline__ void clenshaw_close(const T* c, T t, T t2, T* b1,
                                               T* b2, T* out) {
#pragma unroll
  for (int k = kGroup - 1; k > 0; --k) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const T bn = cellk::fma_t(t2, b1[q], c[NQ * k + q] - b2[q]);
      b2[q] = b1[q];
      b1[q] = bn;
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) out[q] = cellk::fma_t(t, b1[q], c[q] - b2[q]);
}

// Clenshaw sums of NQ series at t from one piece's staged rows (groups of
// kGroup terms, term k of series q at rows[NQ k + q]): the groups from the
// top, each group's coefficients loaded while the group above it runs (two
// buffers, so no copy between groups).
template <int NQ, typename T>
__device__ __forceinline__ void clenshaw(const T* rows, int groups, T t,
                                         T* out) {
  constexpr int L = kGroup * NQ;               // values a group
  const T t2 = t + t;
  T b1[NQ], b2[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) b1[q] = b2[q] = T(0);
  T ca[L], cb[L];
  int g = groups - 1;                          // uniform across the warp
  load_vec<L>(rows + L * g, ca);
  for (; g >= 2; g -= 2) {
    load_vec<L>(rows + L * (g - 1), cb);
    clenshaw_steps<NQ>(ca, t2, b1, b2);
    load_vec<L>(rows + L * (g - 2), ca);
    clenshaw_steps<NQ>(cb, t2, b1, b2);
  }
  if (g == 1) {
    load_vec<L>(rows, cb);
    clenshaw_steps<NQ>(ca, t2, b1, b2);
    clenshaw_close<NQ>(cb, t, t2, b1, b2, out);
  } else {
    clenshaw_close<NQ>(ca, t, t2, b1, b2, out);
  }
}

// Stage a two-piece Chebyshev table (2 pieces, nser series, K terms) as
// rows of the NQ series first .. first + NQ - 1 of each piece, piece p at
// rows + p * piece, zero-padded to groups * kGroup terms. No barrier.
template <int NQ, typename T>
__device__ __forceinline__ void stage_series(const T* __restrict__ table,
                                             int nser, int first, int K,
                                             int groups, int piece,
                                             T* rows) {
  const int KP = groups * kGroup;
  for (int i = threadIdx.x; i < 2 * KP * NQ; i += blockDim.x) {
    const int p = i / (KP * NQ), k = (i / NQ) % KP, q = i % NQ;
    rows[p * piece + NQ * k + q] =
        k < K ? table[(nser * p + first + q) * K + k] : T(0);
  }
}

// A real-source pair inside r_cut: d = target - source in the local frame;
// s the source's staged strengths (f then t, component q at s[q kS]).
template <typename T, int P>
__device__ __forceinline__ void real_pair(const RotScalars<T>& sc,
                                          const T* rot, T dx, T dy, T dz,
                                          const T* s, T* acc) {
  using Pr = Prod<P>;
  constexpr int kS = Walk<T>::kSrc;
  const T r2 = dx * dx + dy * dy + dz * dz;
  const T invr = cellk::rsqrt_t(r2);
  const T r = r2 * invr;
  const bool near = r < sc.two_a;
  const T ts = near ? (r - sc.mid0) * sc.inv_h0 : (r - sc.mid1) * sc.inv_h1;
  T g[Pr::kNR];
  clenshaw<Pr::kNR>(rot + (near ? 0 : Pr::kRotPiece), sc.groups, ts, g);
  if constexpr (Pr::kRtOn) {
    const T fx = s[0], fy = s[kS], fz = s[2 * kS];
    acc[Pr::kWo] += g[0] * (fy * dz - fz * dy);
    acc[Pr::kWo + 1] += g[0] * (fz * dx - fx * dz);
    acc[Pr::kWo + 2] += g[0] * (fx * dy - fy * dx);
  }
  if constexpr (Pr::kHasT) {
    constexpr int o = Pr::kTo;
    const T tx = s[o * kS], ty = s[(o + 1) * kS], tz = s[(o + 2) * kS];
    if constexpr (Pr::kTrOn) {
      acc[0] += g[0] * (ty * dz - tz * dy);
      acc[1] += g[0] * (tz * dx - tx * dz);
      acc[2] += g[0] * (tx * dy - ty * dx);
    }
    if constexpr (Pr::kRrOn) {
      // alpha_r and beta_r: the series after gamma_r (grand) or the two
      // rr reads
      constexpr int a = Pr::kNR - 2;
      const T b = g[a + 1] * (dx * tx + dy * ty + dz * tz) * invr * invr;
      acc[Pr::kWo] += g[a] * tx + b * dx;
      acc[Pr::kWo + 1] += g[a] * ty + b * dy;
      acc[Pr::kWo + 2] += g[a] * tz + b * dz;
    }
  }
}

// An image-source pair inside r_cut: d as above, zsrc the source's
// physical z, ztgt the target's.
template <typename T, int P>
__device__ __forceinline__ void image_pair(const RotScalars<T>& sc,
                                           const T* img, T dx, T dy, T dz,
                                           T zsrc, T ztgt, const T* s,
                                           T* acc) {
  using Pr = Prod<P>;
  constexpr int kS = Walk<T>::kSrc;
  const T r2 = dx * dx + dy * dy + dz * dz;
  const T r = r2 * cellk::rsqrt_t(r2);
  // r / a clamped into the series' domain before evaluation
  const T rs = clamp_t(r * sc.inv_a, sc.ir_lo, sc.ir_hi);
  const bool p0 = rs < sc.ir_mid;
  const T ti = clamp_t(p0 ? (rs - sc.mid_i0) * sc.inv_hi0
                          : (rs - sc.mid_i1) * sc.inv_hi1, T(-1), T(1));
  T c[3] = {T(0), T(0), T(0)};                 // c2_1, c2_2, c2_3
  clenshaw<Pr::kNI>(img + (p0 ? 0 : Pr::kImgPiece), sc.groups_i, ti, c);
  const T z = T(0);
  const T dxs = dx * sc.inv_a, dys = dy * sc.inv_a, rzs = dz * sc.inv_a;
  if constexpr (Pr::kRtOn) {
    T wx, wy, wz;
    wallk::img_terms_rt<T>(dxs, dys, rzs, -zsrc * sc.inv_a, s[0], s[kS],
                           s[2 * kS], z, z, z, z, z, z, c[0], c[1], c[2], z,
                           wx, wy, wz);
    acc[Pr::kWo] += sc.pref_c * wx;
    acc[Pr::kWo + 1] += sc.pref_c * wy;
    acc[Pr::kWo + 2] += sc.pref_c * wz;
  }
  if constexpr (Pr::kHasT) {
    constexpr int o = Pr::kTo;
    const T tx = s[o * kS], ty = s[(o + 1) * kS], tz = s[(o + 2) * kS];
    if constexpr (Pr::kTrOn) {
      T ux, uy, uz;
      wallk::img_terms_tr<T>(dxs, dys, rzs, ztgt * sc.inv_a, tx, ty, tz, z,
                             z, z, z, z, z, c[0], c[1], c[2], z, ux, uy, uz);
      acc[0] += sc.pref_c * ux;
      acc[1] += sc.pref_c * uy;
      acc[2] += sc.pref_c * uz;
    }
    if constexpr (Pr::kRrOn) {
      T wx, wy, wz;
      wallk::img_terms_rr<T>(dxs, dys, rzs, tx, ty, tz, z, z, z, z, z, z,
                             c[0], c[1], c[2], z, wx, wy, wz);
      acc[Pr::kWo] += sc.pref_r * wx;
      acc[Pr::kWo + 1] += sc.pref_r * wy;
      acc[Pr::kWo + 2] += sc.pref_r * wz;
    }
  }
}

// four resident blocks an SM in float32: 64 registers a thread
template <typename T, int P>
__global__ void __launch_bounds__(cellk::kThreads, (cellk::min_blocks<T>(4)))
wall_rot_near_kernel(const T* __restrict__ pos, const T* __restrict__ f,
                     const T* __restrict__ t, const int* __restrict__ table,
                     const T* __restrict__ cheb, const T* __restrict__ img,
                     T* __restrict__ out, Grid g, int n_real, int cz_lo,
                     int nkz, double Lx, double Ly, double Lz, double z0,
                     RotScalars<T> sc) {
  using Pr = Prod<P>;
  constexpr int kSrc = Walk<T>::kSrc;
  static_assert(kSrc % 64 == 0, "a tile holds whole 64-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_rot = reinterpret_cast<T*>(smem);
  T* s_img = s_rot + 2 * Pr::kRotPiece;
  T* s_src = s_img + 2 * Pr::kImgPiece;       // (kSrcRows, 4)
  T* s_s = s_src + 4 * kSrcRows<T>;           // (kNS, kSrc)
  T* s_tgt = s_s + Pr::kNS * kSrc;            // (target_slots, 4)
  unsigned* s_ring_i =
      reinterpret_cast<unsigned*>(s_tgt + 4 * cellk::target_slots(g.cap));
  unsigned short* s_ring_r =
      reinterpret_cast<unsigned short*>(s_ring_i + kWarps * kRingSlots);
  int* s_id = reinterpret_cast<int*>(s_ring_r + kWarps * kRingSlots);
  __shared__ cellk::Stencil st;
  __shared__ int start_r[28];

  stage_series<Pr::kNR>(cheb, 3, Pr::kRot0, sc.K, sc.groups, Pr::kRotPiece,
                        s_rot);
  stage_series<Pr::kNI>(img, 10, kImgFirst, sc.Ki, sc.groups_i,
                        Pr::kImgPiece, s_img);
  const int c = (blockIdx.x / nkz) * g.nz + cz_lo + blockIdx.x % nkz;
  // no real target (the reals are a prefix of the live slots): uniform
  if (table[static_cast<size_t>(c) * g.cap] >= n_real) return;
  cellk::load_stencil(st, table, c, g, Lx, Ly, Lz);   // ends in a barrier
  cellk::split_reals(st, table, g, n_real, start_r);  // ends in a barrier
  // the real targets: the own cell's (stencil entry 13) real prefix
  const int n_tgt = start_r[14] - start_r[13];
  const int* own = table + static_cast<size_t>(st.cell[13]) * g.cap;
  const int total = st.start[27], n_r = start_r[27];
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
      const int re = min(max(n_r - s0, 0), m);   // the tile's real part
      cellk::stage_split(st, start_r, table, g, s0, m,
                         [&](int s, int sid, int k) {
        T* row = s_src + 4 * s;
        cellk::local_source(st, pos, sid, k, row);
        row[3] = T(double(pos[3 * sid + 2]) + z0);
        // an image row takes its real twin's strengths
        const size_t src = 3 * static_cast<size_t>(sid < n_real ? sid
                                                                : sid - n_real);
        for (int q = 0; q < 3; ++q) {
          if constexpr (Pr::kHasF) s_s[q * kSrc + s] = f[src + q];
          if constexpr (Pr::kHasT) s_s[(q + Pr::kTo) * kSrc + s] = t[src + q];
        }
      });
      cellk::pad_rows(s_src, m, cellk::split_pad(m, re));
      __syncthreads();
      cellk::split_walk<kRing, Pr::kNO, 6>(
          s_src, s_tgt, s_id, m, re, nt, sc.rc2, ring_r, ring_i,
          out + Pr::kCol,
          [&](int j, const T* tgt, T* acc) {
            T src[4];
            load_vec<4>(s_src + 4 * j, src);
            real_pair<T, P>(sc, s_rot, tgt[0] - src[0], tgt[1] - src[1],
                            tgt[2] - src[2], s_s + j, acc);
          },
          [&](int te, int j, T* u) {
            T tgt[4], src[4];
            load_vec<4>(s_tgt + 4 * te, tgt);
            load_vec<4>(s_src + 4 * j, src);
            image_pair<T, P>(sc, s_img, tgt[0] - src[0], tgt[1] - src[1],
                             tgt[2] - src[2], src[3], tgt[3], s_s + j, u);
          });
      __syncthreads();   // the tile is restaged
    }
  }
}

template <typename T, int P>
int launch(const T* pos, const T* f, const T* t, const int* table,
           const T* cheb, const T* img, T* out, int n_real, int nx, int ny,
           int nz, int cap, int K, int Ki, int cz_lo, int cz_hi, double Lx,
           double Ly, double Lz, double two_a, double r_cut, double z0,
           double a, double pref_c, double pref_r, double ir_lo,
           double ir_mid, double ir_hi, void* stream) {
  using Pr = Prod<P>;
  if (K < 1 || K > kMaxRot || Ki < 1 || Ki > kMaxCheb || cz_lo < 0 ||
      cz_hi >= nz || cz_hi < cz_lo || cap < 1 ||
      (Pr::kHasF && f == nullptr) || (Pr::kHasT && t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the staged tile, the targets and the rings take more than the 48 KB of
  // static shared memory: raise the instance's limit to this launch's size
  const size_t bytes = smem_bytes<T, P>(cap);
  const cudaError_t attr = cudaFuncSetAttribute(
      wall_rot_near_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Grid g{2 * n_real, nx, ny, nz, cap};
  // the remainder pieces: [0, 2a] and [2a, r_cut]; the image pieces split
  // [ir_lo, ir_hi] at ir_mid
  const RotScalars<T> sc{K,
                         Ki,
                         (K + kGroup - 1) / kGroup,
                         (Ki + kGroup - 1) / kGroup,
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
  wall_rot_near_kernel<T, P><<<nx * ny * nkz, cellk::kThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      pos, f, t, table, cheb, img, out, g, n_real, cz_lo, nkz, Lx, Ly, Lz, z0,
      sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos (2 n_real, 3) grid-shifted positions of the reals then their images,
// f and t (n_real, 3) damped forces and torques (the instance reads f for
// grand and rt, t for grand, tr and rr; the other may be null), table (nx
// ny nz cap,) int32 from ops/cells.cell_bin over (Lx, Ly, Lz) (sentinel
// 2 n_real), cheb (2, 3, K) the rot remainders' pieces, img (2, 10, Ki)
// K7's image radial series, out (n_real, 6) rows (v, w) zeroed by the
// caller (dropped particles keep their zero row; the instance adds into
// the columns of its output and leaves the others); target cells on the z
// layers [cz_lo, cz_hi]; all contiguous on the device. Returns the CUDA
// error code of the launch.
#define ROT_ENTRY(NAME, T, P)                                                 \
  extern "C" int NAME(const T* pos, const T* f, const T* t, const int* table, \
                      const T* cheb, const T* img, T* out, int n_real,        \
                      int nx, int ny, int nz, int cap, int K, int Ki,         \
                      int cz_lo, int cz_hi, double Lx, double Ly, double Lz,  \
                      double two_a, double r_cut, double z0, double a,        \
                      double pref_c, double pref_r, double ir_lo,             \
                      double ir_mid, double ir_hi, void* stream) {            \
    return launch<T, P>(pos, f, t, table, cheb, img, out, n_real, nx, ny, nz, \
                        cap, K, Ki, cz_lo, cz_hi, Lx, Ly, Lz, two_a, r_cut,   \
                        z0, a, pref_c, pref_r, ir_lo, ir_mid, ir_hi, stream); \
  }

ROT_ENTRY(wall_rot_near_f32_grand, float, kGrand)
ROT_ENTRY(wall_rot_near_f32_rt, float, kRt)
ROT_ENTRY(wall_rot_near_f32_tr, float, kTr)
ROT_ENTRY(wall_rot_near_f32_rr, float, kRr)
ROT_ENTRY(wall_rot_near_f64_grand, double, kGrand)
ROT_ENTRY(wall_rot_near_f64_rt, double, kRt)
ROT_ENTRY(wall_rot_near_f64_tr, double, kTr)
ROT_ENTRY(wall_rot_near_f64_rr, double, kRr)
