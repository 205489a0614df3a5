// Kernel P1: the square tt product of the RPY mobility with per-blob radii
// and, above a wall, the finite-size Swan-Brady image system of unequal
// radii, on B = 1 or 2 stacked right-hand sides:
//   u_i = sum_j M(r_i, r_j; a_i, a_j) v_j
// with M = rpy_tt_radii + wall_tt_radii of ops/rpy.py in physical units.
// The caller (ops/mobility_cuda.radii_matvec) shifts the heights to
// z_eff = max(z, a_i), damps v by B_jj = min(z_j / a_j, 1), and applies
// 1/(8 pi eta) and the target damping.
//
// Replaces no Pallas kernel: the JAX package runs this product as XLA
// (ops/mobility.py:540 mobility_radii_trans_times_force, the source-target
// product with sources = targets). It was added because its plain PyTorch
// version at a path's size (~1.2e9 pairs a product at 49,152 blobs) takes
// seconds a product, and a Slip-Trapz step takes some forty products.
//
// What bounds it on the H100: float32 instruction issue, as K1's sweeps
// (csrc/pair_blocks.cuh). The inputs are 20 bytes a blob and a right-hand
// side's 12; an unordered pair off contact costs 104 float32 operations
// (an FMA as 2: the geometry 11, the far RPY form 13, the wall image
// system 80) to condense its block into the five scalars of pairk::Diag
// and 36 a right-hand side to apply it both ways, with two rsqrt and no
// division (chip_smoke.py P1_FAR_FLOPS). In the SASS the far path issues
// 107 instructions a pair at B = 1 and 133 at B = 2, against 182 and 208
// when every pair formed all three regimes and a division
// (tools/torch_profile_kernels.py --kernels p1). On the free surface (two
// far forms) the far path of the one-target sweep issued 67 instructions a
// pair at B = 1 (51 float32, 10 shuffles of five coordinates and the
// vector and sum), 59.5 on the two-targets sweep below
// (tools/torch_profile_kernels.py --kernels fsopen, PERF.md §6).
//
// Design: K1's symmetric sweep (pairk::sym_kernel) with two more staged
// coordinates, the radius and its reciprocal. The block of unequal radii
// is reciprocal, M(j, i) = M(i, j)^T (the wall's terms 3 and 4 trade
// (a^2, z_s) for (b^2, z_t); tests/test_torch_radii.py holds the plain
// blocks to it at 1e-13), and it has the structure of K1's condensed tt
// block: an in-plane part A I + S d d^T, the z column P d, the z row Q d^T
// and the zz entry. So each unordered pair is condensed once and applied
// both ways by pairk::diag_apply and diag_apply_t. What each pair costs:
// - the RPY regimes: far (r > a + b, tested as r^2 > (a + b)^2 before any
//   rsqrt), overlapping (|b - a| < r <= a + b) and one inside the other
//   (r <= |b - a|, coincident blobs included). Off the diagonal tile, a
//   tile pair whose bounding boxes lie further apart than their largest
//   radii add up to takes the far path, condense<FULL = false>, the far
//   form alone, at every step with no test a pair; in any other tile pair
//   each rotation step votes across the warp (__all_sync) and takes the
//   far path when its 32 pairs are all far. Other steps, and the diagonal
//   tile with its self pairs, take the full path, condense<FULL = true>,
//   which forms the same far form and selects the other regimes over it
//   by the same test. A far pair gets the same bits on either path, and
//   its block is applied both ways, so the product stays bit-identical on
//   repeat. Where no two blobs touch, no step leaves the far path;
// - the reciprocals: 1/a is staged beside a by the wrapper (its exact
//   division), so 1 / (a b) is one multiply, on the full path only;
// - the target's a^2, (2/3) a^2 and (2/3) z_t are formed once a tile;
// - the wall image system: each of the five condensed entries collected
//   by powers of u = 1/R^2 (derived from ops/rpy.py wall_tt_radii), with
//   e = Rz^2 u <= 1 absorbing the Rz^2 of the higher powers, and
//   evaluated by Horner's rule in u, each power of W = 1/R formed once.
// Self pairs (r = 0) take the inside regime, 4 / (3 a), and the wall
// terms at dx = dy = 0, Rz = 2 z: the self mobility of the plain version.
// The group plan, the workspace of one slice a group and the fixed-order
// slice sum are K1's.
//
// The domain modes (MODE): 0 the open domain, 1 the wall, 2 the free
// surface, a slip plane at z = 0 (the JAX package's source_target_matvec
// :488-492): the block adds the different-radii RPY block at the image
// R = (dx, dy, z_t + z_s) with its z column reflected, the heights raw
// and nothing damped. The image's block has the three regimes of its own
// distance |R| and the same Diag structure (A += e1, S += e2, P -= e2 Rz,
// Q += e2 Rz, mzz -= e1 + e2 Rz^2); its coefficients are symmetric in the
// radii, so the block stays reciprocal. A pair takes the far path only
// when both it and its image are far; the tile test adds that both tiles
// lie above the plane (then |R| >= r). The open free surface runs its own
// sweep, radii_sym2_kernel: pairk::sym2_kernel's two targets a lane in
// blocks of 64 threads, the same tile test, a far tile pair rotating four
// coordinates (x, y, z, a; 1/a is the full path's alone) and unrolled by
// two, one warp vote a step for both of a lane's pairs elsewhere; 12
// blocks an SM (80 registers; B = 1 spills 16 bytes; 10 blocks, 96
// registers without a spill, ran no faster).
//
// The image-box instances (pair_radii_sym_img_*; the pseudo-periodic
// boxes of source_target_matvec with a periodic_length, XLA there) take
// K1's policies (pair_blocks.cuh): each pair's minimum image formed in
// float64, then every box of the list summed into one pairk::BlockSum and
// applied both ways. ImageBoxes: each box's path by its own warp vote
// (every lane walks the same boxes). PlaneBoxes, chosen on the host when
// both in-plane lengths exceed kPlaneFarMin times the largest radius: the
// home box by the vote, the eight others in the far form alone (they lie
// at r >= L / 2 > 2.02 max(a) >= a + b, and so do their images). No tile
// test on the distance: the minimum image moves a pair out of its tiles'
// boxes. The self pair takes the inside regime in the home box only (r = 0
// there; in every other box a blob's image is an ordinary pair at d = b
// L), as the plain version, which has no self mask, computes it.
//
// The free surface under PlaneBoxes (fs_box_sum), where a pair's nine
// boxes are nearly all of its work: z is never imaged, so dz, Rz and s2 =
// a^2 + b^2 are the same in every box, and no box is condensed. Every box
// adds the coefficients of the pair and of its image (c1, c2, e1, e2) into
// the sums pair_blocks.cuh FsMoments keeps, and dz and Rz are folded in
// once a pair when the sum closes into its one block. The eight far boxes
// are unrolled, their in-plane offsets and squares formed once a column and
// a row: each costs two adds, two rsqrt, the two far RPY forms and the
// sums' add, no regime flag and no Geo. The home box takes its regimes by
// the warp vote, as before, into the same sums; its image's regime is
// settled once a tile pair by a z test (images_far: the tiles' lowest
// heights against their largest radii, z being the same in every box), so
// where it passes the image takes the far form and the vote asks about the
// direct pair alone, and where it fails (a blob at or below its radius)
// the image keeps its own test.

#include "pair_blocks.cuh"

namespace {

using pairk::above_plane;
using pairk::Box;
using pairk::boxes_far;
using pairk::Diag;
using pairk::images_far;
using pairk::kLanes;
using pairk::kTile;
using pairk::kWarps;
using pairk::rsqrt_t;

// the open domain's pair geometry: one pair, d = r_t - r_s
struct RadiiOpen {
  static constexpr bool kImages = false;
};

constexpr int kOpen = 0, kWall = 1, kFreeSurface = 2;

// resident blocks an SM that __launch_bounds__ asks for in float32: 6,
// at most 85 registers a thread (ptxas gives B = 1 72 and B = 2 76; 4
// left B = 2 at 85 and ~4 % slower, 8 spills; PERF.md §6); the image
// boxes' instances, which hold a pair's box sum besides, 4 (128
// registers), but the free surface's under PlaneBoxes: 6 (80 registers,
// no spill; at 4 and 5 it takes 128 and 96 and runs 8 % and 3 % slower at
// 21e's scene, PERF.md §6). float64 uncapped
template <typename T, int MODE, typename G>
constexpr int min_blocks() {
  if (sizeof(T) != 4) return 1;
  return !G::kImages || (MODE == kFreeSurface &&
                         std::is_same_v<G, pairk::PlaneBoxes<T>>)
             ? 6
             : 4;
}

// a staged blob: x, y, z_eff, a, 1/a
constexpr int kQ = 5;

// a staged row: the blob and the 3B vector entries, padded to whole
// 16-byte loads
template <typename T, int B>
using Row = pairk::RowLen<T, 3 * B + kQ - 3>;

// the target's terms, formed once a tile
template <typename T>
struct Target {
  T x, y, z, a, ia;  // the staged blob
  T a2, ca, z23;     // a^2, (2/3) a^2, (2/3) z
};

template <typename T>
__device__ __forceinline__ Target<T> make_target(const T* p) {
  Target<T> t;
  t.x = p[0];
  t.y = p[1];
  t.z = p[2];
  t.a = p[3];
  t.ia = p[4];
  t.a2 = t.a * t.a;
  t.ca = T(2.0 / 3.0) * t.a2;
  t.z23 = T(2.0 / 3.0) * t.z;
  return t;
}

// the geometry of (target t, source s) at the displacement d of a box, and
// its regime; on the free surface also its image's
template <typename T>
struct Geo {
  T dx, dy, dz, xy2, r2;
  bool far;        // r > a_t + a_s (and on the free surface |R| too)
  bool far_d;      // r > a_t + a_s
  T R2;            // the free surface's |R|^2, R = (dx, dy, z_t + z_s)
  bool far_i;      // |R| > a_t + a_s
};

template <typename T, int MODE>
__device__ __forceinline__ Geo<T> make_geo_d(const Target<T>& t, const T* s,
                                             T dx, T dy, T dz) {
  Geo<T> g;
  g.dx = dx;
  g.dy = dy;
  g.dz = dz;
  g.xy2 = g.dx * g.dx + g.dy * g.dy;
  g.r2 = g.xy2 + g.dz * g.dz;
  const T sum = t.a + s[3];
  const T sum2 = sum * sum;
  g.far_d = g.r2 > sum2;
  g.far = g.far_d;
  if (MODE == kFreeSurface) {
    const T Rz = t.z + s[2];
    g.R2 = g.xy2 + Rz * Rz;
    g.far_i = g.R2 > sum2;
    g.far = g.far_d && g.far_i;
  }
  return g;
}

template <typename T, int MODE>
__device__ __forceinline__ Geo<T> make_geo(const Target<T>& t, const T* s) {
  return make_geo_d<T, MODE>(t, s, t.x - s[0], t.y - s[1], t.z - s[2]);
}

// (c1, c2) of the different-radii RPY block at the squared distance r2
// (rpy_tt_radii). FULL = false: the far form; FULL = true: the far form,
// with the overlapping and inside regimes selected over it where `far` is
// false. r^2 = 0 (self and coincident pairs) makes the far and
// overlapping forms inf or NaN; neither is selected for them
template <typename T, bool FULL>
__device__ __forceinline__ void rpy_coeffs(T r2, bool far,
                                           const Target<T>& t, const T* s,
                                           T s2, T& c1, T& c2) {
  // RPY far form: c1 = (1 + s2 / (3 r^2)) / r, c2 = (1 - s2 / r^2) / r^3
  const T invr = rsqrt_t(r2);
  const T invr2 = invr * invr;
  const T invr3 = invr2 * invr;
  const T x = s2 * invr2;
  c1 = (T(1) + x * T(1.0 / 3.0)) * invr;
  c2 = invr3 - x * invr3;
  if (FULL) {
    const T dif = s[3] - t.a;
    const T dd2 = dif * dif;
    const T inv_ab = t.ia * s[4];
    const T q = dd2 + T(3) * r2;
    // (4/3) ((a + b) / 2 - (dd2 + 3 r^2)^2 / (32 r^3)) / (a b)
    const T c1_mid = (T(0.5) * (t.a + s[3]) - q * q * invr3 *
                      T(1.0 / 32.0)) * (T(4.0 / 3.0) * inv_ab);
    const T w = dd2 - r2;
    // (dd2 - r^2)^2 / (8 a b r^5)
    const T c2_mid = w * w * invr3 * invr2 * (T(0.125) * inv_ab);
    // 4 / (3 max(a, b))
    const T c1_in = T(4.0 / 3.0) * (t.ia < s[4] ? t.ia : s[4]);
    const bool mid = r2 > dd2;
    c1 = far ? c1 : (mid ? c1_mid : c1_in);
    c2 = far ? c2 : (mid ? c2_mid : T(0));
  }
}

// the condensed block of (target t, source s = (x, y, z_eff, a, 1/a)) at
// the geometry g. FULL = false: the far RPY form (of the pair and, on the
// free surface, its image), for steps whose pairs are all far; FULL =
// true: every regime by its own test
template <typename T, int MODE, bool FULL>
__device__ __forceinline__ Diag<T> condense(const Geo<T>& g,
                                            const Target<T>& t,
                                            const T* s) {
  const T b2 = s[3] * s[3];
  const T s2 = t.a2 + b2;
  T c1, c2;
  rpy_coeffs<T, FULL>(g.r2, g.far_d, t, s, s2, c1, c2);
  Diag<T> m;
  const T p = c2 * g.dz;
  m.A = c1;
  m.S = c2;
  m.P = p;
  m.Q = p;
  m.mzz = p * g.dz + c1;
  if (MODE == kFreeSurface) {
    T e1, e2;
    rpy_coeffs<T, FULL>(g.R2, g.far_i, t, s, s2, e1, e2);
    const T Rz = t.z + s[2];
    const T e2Rz = e2 * Rz;
    m.A += e1;
    m.S += e2;
    m.P -= e2Rz;
    m.Q += e2Rz;
    m.mzz -= e2Rz * Rz + e1;
  }
  if (MODE == kWall) {
    // wall_tt_radii on (dx, dy, Rz = zt + zs), x3 = zt, y3 = zs, with W =
    // 1/R, u = W^2, e = Rz^2 u, G = ca zs + cb zt (ca, cb = (2/3) a^2,
    // (2/3) b^2), cab = ca b^2, K, M = (a^2 + b^2) / 3 +- 2 zt zs:
    //   A_w = W (-1 - u K + u^2 (3 G Rz + cab (1 - 5 e)))
    //   S_w = W^3 (-1 + 3 u K - u^2 (15 G Rz + cab (5 - 35 e)))
    //   P_w = W^3 (-dz + u (D - E) + F),  Q_w = W^3 (-dz + u (D + E) - F)
    //   Z_w = W (-(1 + e) + u (3 e - 1) M
    //            + u^2 (G Rz (15 e - 9) + cab (-3 + 30 e - 35 e^2)))
    // with D = (a^2 - b^2) Rz, E = 3 (2 zt zs Rz + G) and F = Rz u^2 (15 G
    // Rz + cab (15 - 35 e)); each added to the RPY entry by one FMA
    const T zs = s[2];
    const T Rz = t.z + zs;
    const T Rz2 = Rz * Rz;
    const T W = rsqrt_t(Rz2 + g.xy2);
    const T u = W * W;
    const T W3 = W * u;
    const T e = Rz2 * u;
    const T x2 = T(2) * (t.z * zs);
    const T h = s2 * T(1.0 / 3.0);
    const T K = h + x2;
    const T M = h - x2;
    const T G = t.ca * zs + b2 * t.z23;
    const T GR = G * Rz;
    const T cab = t.ca * b2;
    const T cabe = cab * e;
    const T b15 = T(15) * GR - T(35) * cabe;
    const T bA = (T(3) * GR + cab) - T(5) * cabe;
    m.A = W * (u * (u * bA - K) - T(1)) + m.A;
    const T bS = b15 + T(5) * cab;
    m.S = W3 * (u * (T(3) * K - u * bS) - T(1)) + m.S;
    const T D = (t.a2 - b2) * Rz;
    const T E = T(3) * (x2 * Rz + G);
    const T F = (Rz * u) * (u * (b15 + T(15) * cab));
    // the image system's own dz is the heights' difference, whatever
    // box the pair's d is in (a box periodic in z moves d alone)
    const T dzw = t.z - zs;
    m.P = W3 * (u * (D - E) + (F - dzw)) + m.P;
    m.Q = W3 * (u * (D + E) - (F + dzw)) + m.Q;
    const T bZ = GR * (T(15) * e - T(9)) +
                 cab * ((T(30) - T(35) * e) * e - T(3));
    m.mzz = W * (u * (u * bZ + (T(3) * e - T(1)) * M) - (T(1) + e)) +
            m.mzz;
  }
  return m;
}

// a box's block added into a pair's box sum; VOTE: the far form where the
// warp's 32 pairs of the box are all far (every lane calls), else every
// regime by its test
template <typename T, int MODE, bool VOTE>
__device__ __forceinline__ void add_box(pairk::BlockSum<T>& m,
                                        const Geo<T>& g, const Target<T>& t,
                                        const T* s) {
  const bool far = VOTE && __all_sync(0xffffffffu, g.far);
  m.add(far ? condense<T, MODE, false>(g, t, s)
            : condense<T, MODE, true>(g, t, s),
        g.dx, g.dy);
}

// The pair (t, s) summed over the image boxes into one closed block: the
// minimum image in float64 (ImageBoxes::image), then every box of the
// list, each by its own vote (VOTE) or every regime (IMG_FAR is
// PlaneBoxes' alone: false here)
template <typename T, int MODE, bool VOTE, bool IMG_FAR = false>
__device__ __forceinline__ pairk::BlockSum<T> box_sum(
    const pairk::ImageBoxes<T>& g, const Target<T>& t, const T* s) {
  static_assert(!IMG_FAR, "ImageBoxes takes no tile test");
  const T dx = g.image(t.x, s[0], 0);
  const T dy = g.image(t.y, s[1], 1);
  const T dz = g.image(t.z, s[2], 2);
  pairk::BlockSum<T> m{};
#pragma unroll 1
  for (int b = 0; b < g.n; ++b)
    add_box<T, MODE, VOTE>(m, make_geo_d<T, MODE>(t, s, dx + g.off[b][0],
                                                  dy + g.off[b][1],
                                                  dz + g.off[b][2]),
                           t, s);
  m.close();
  return m;
}

// The free surface under PlaneBoxes: every box's coefficients summed into
// pairk::FsMoments, closed into one block once a pair. The home box by the
// vote (VOTE) or every regime, its image in the far form where the tile
// pair's z test settled it far (IMG_FAR; the vote then asks about the
// direct pair alone); the eight others in the far form alone, their
// in-plane offsets and squares formed once a column and a row, and dz^2,
// Rz^2 and s2 = a^2 + b^2 once a pair: a far box costs two adds, two
// rsqrt, the two far RPY forms and the moments' add
template <typename T, bool VOTE, bool IMG_FAR>
__device__ __forceinline__ pairk::BlockSum<T> fs_box_sum(
    const pairk::PlaneBoxes<T>& g, const Target<T>& t, const T* s, T dx,
    T dy, T dz) {
  const T Rz = t.z + s[2];
  const T s2 = t.a2 + s[3] * s[3];
  pairk::FsMoments<T> m{};
  {
    const Geo<T> geo = make_geo_d<T, kFreeSurface>(t, s, dx, dy, dz);
    const bool far =
        VOTE && __all_sync(0xffffffffu, IMG_FAR ? geo.far_d : geo.far);
    T c1, c2, e1, e2;
    if (far) {
      rpy_coeffs<T, false>(geo.r2, true, t, s, s2, c1, c2);
      rpy_coeffs<T, false>(geo.R2, true, t, s, s2, e1, e2);
    } else {
      rpy_coeffs<T, true>(geo.r2, geo.far_d, t, s, s2, c1, c2);
      rpy_coeffs<T, !IMG_FAR>(geo.R2, geo.far_i, t, s, s2, e1, e2);
    }
    m.add(c1, c2, e1, e2, dx, dy);
  }
  const T dz2 = dz * dz, Rz2 = Rz * Rz;
  // the eight others in pairk::PlaneBoxes' order (the home box is above)
  g.boxes(dx, dy, [&](T x, T y, T xy2, bool far) {
    if (!far) return;
    T c1, c2, e1, e2;
    rpy_coeffs<T, false>(xy2 + dz2, true, t, s, s2, c1, c2);
    rpy_coeffs<T, false>(xy2 + Rz2, true, t, s, s2, e1, e2);
    m.add(c1, c2, e1, e2, x, y);
  });
  return m.close(dz, Rz);
}

// PlaneBoxes: the home box by the vote (VOTE) or every regime, the eight
// boxes off it in the far form alone (the host's choice guarantees them
// far, images included); the free surface's by fs_box_sum
template <typename T, int MODE, bool VOTE, bool IMG_FAR = false>
__device__ __forceinline__ pairk::BlockSum<T> box_sum(
    const pairk::PlaneBoxes<T>& g, const Target<T>& t, const T* s) {
  const T dx = static_cast<T>(pairk::min_image(
      static_cast<double>(t.x) - static_cast<double>(s[0]), g.L[0],
      g.inv_L[0]));
  const T dy = static_cast<T>(pairk::min_image(
      static_cast<double>(t.y) - static_cast<double>(s[1]), g.L[1],
      g.inv_L[1]));
  const T dz = t.z - s[2];
  static_assert(!IMG_FAR || MODE == kFreeSurface,
                "the tile's z test is the free surface's");
  if constexpr (MODE == kFreeSurface) {
    return fs_box_sum<T, VOTE, IMG_FAR>(g, t, s, dx, dy, dz);
  } else {
    pairk::BlockSum<T> m{};
    add_box<T, MODE, VOTE>(m, make_geo_d<T, MODE>(t, s, dx, dy, dz), t, s);
#pragma unroll 1
    for (int k = 1; k < 9; ++k) {
      const int idx = k - 1 + (k >= 5 ? 1 : 0);
      const Geo<T> geo = make_geo_d<T, MODE>(
          t, s, dx + T(idx / 3 - 1) * g.Lx, dy + T(idx % 3 - 1) * g.Ly, dz);
      m.add(condense<T, MODE, false>(geo, t, s), geo.dx, geo.dy);
    }
    m.close();
    return m;
  }
}

// the off-diagonal tile pair (target tile of the block's rows, source tile
// tb): each quarter of tile tb rotates through the warp, 32 steps of 32
// pairs, its sums returned to its lanes; the four warps' source sums are
// left in s_sum[warp]. Open domain: TILE_FAR every step far (the tile
// boxes far apart), else each step by its warp vote; image boxes: a
// pair's box sum (box_sum, each box by its vote; TILE_FAR: the free
// surface's images settled far by images_far)
template <typename T, int B, int MODE, bool TILE_FAR, typename G>
__device__ __forceinline__ void rotate(const T* __restrict__ q,
                                       const T* __restrict__ vec, int n,
                                       int tb, const Target<T>& tgt,
                                       const T* vi, T* acc,
                                       T (*s_sum)[kTile][3 * B],
                                       const G& geom) {
  constexpr int NV = 3 * B;
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
#pragma unroll 1
  for (int quarter = 0; quarter < kWarps; ++quarter) {
    const int j = tb * kTile + quarter * kLanes + lane;
    T pj[kQ] = {T(0), T(0), T(1), T(1), T(1)}, vj[NV], accj[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      vj[c] = T(0);
      accj[c] = T(0);
    }
    if (j < n) {
#pragma unroll
      for (int c = 0; c < kQ; ++c) pj[c] = q[kQ * j + c];
#pragma unroll
      for (int c = 0; c < NV; ++c) vj[c] = vec[(size_t)j * NV + c];
    }
    const int next = (lane + 1) % kLanes;
#pragma unroll 1
    for (int step = 0; step < kLanes; ++step) {
      if constexpr (G::kImages) {
        const pairk::BlockSum<T> m =
            box_sum<T, MODE, true, TILE_FAR>(geom, tgt, pj);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          m.apply(vj + 3 * b, acc + 3 * b);
          m.apply_t(vi + 3 * b, accj + 3 * b);
        }
      } else {
        const Geo<T> g = make_geo<T, MODE>(tgt, pj);
        // one path for the warp's 32 pairs: the far form when all are far
        const bool far = TILE_FAR || __all_sync(0xffffffffu, g.far);
        const Diag<T> m = far ? condense<T, MODE, false>(g, tgt, pj)
                              : condense<T, MODE, true>(g, tgt, pj);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          pairk::diag_apply(m, g.dx, g.dy, vj + 3 * b, acc + 3 * b);
          pairk::diag_apply_t(m, g.dx, g.dy, vi + 3 * b, accj + 3 * b);
        }
      }
#pragma unroll
      for (int c = 0; c < kQ; ++c)
        pj[c] = __shfl_sync(0xffffffffu, pj[c], next);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        vj[c] = __shfl_sync(0xffffffffu, vj[c], next);
        accj[c] = __shfl_sync(0xffffffffu, accj[c], next);
      }
    }
#pragma unroll
    for (int c = 0; c < NV; ++c)
      s_sum[warp][quarter * kLanes + lane][c] = accj[c];
  }
}

// One block: one pair of tile groups (GA, GB), GA <= GB, as
// pairk::sym_kernel, on rows (x, y, z_eff, a, 1/a), in the domain MODE
// and the pair geometry G (RadiiOpen, or an image-box policy; the open
// free surface takes radii_sym2_kernel below). The tile test: the open
// domain's boxes_far, the free surface's PlaneBoxes images_far; the other
// image instances take none.
template <typename T, int B, int MODE, typename G>
__global__ void __launch_bounds__(kTile, (min_blocks<T, MODE, G>()))
radii_sym_kernel(const T* __restrict__ q, const T* __restrict__ vec,
                 T* __restrict__ ws, int n, int n_groups,
                 int tiles_per_group, G geom) {
  constexpr int NV = 3 * B;
  constexpr int L = Row<T, B>::value;
  constexpr bool kFsPlane =
      MODE == kFreeSurface && std::is_same_v<G, pairk::PlaneBoxes<T>>;
  constexpr bool kTileTest = !G::kImages || kFsPlane;
  static_assert(MODE != kFreeSurface || G::kImages,
                "the open free surface takes radii_sym2_kernel");
  __shared__ __align__(16) T s_src[kTile][L];
  __shared__ T s_sum[kWarps][kTile][NV];
  __shared__ T s_box[kWarps][7];

  int ga, gb;
  pairk::group_pair(blockIdx.x, n_groups, ga, gb);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int a_begin = ga * tiles_per_group;
  const int a_end = min(n_tiles, a_begin + tiles_per_group);
  const int b_begin = gb * tiles_per_group;
  const int b_end = min(n_tiles, b_begin + tiles_per_group);
  T* ws_a = ws + (size_t)gb * n * NV;  // target-side sums of group GA
  T* ws_b = ws + (size_t)ga * n * NV;  // source-side sums of group GB
#pragma unroll 1
  for (int t = 0; t < tiles_per_group; ++t) {
    const int ra = (a_begin + t) * kTile + threadIdx.x;
    const int rb = (b_begin + t) * kTile + threadIdx.x;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (ra < n) ws_a[(size_t)ra * NV + c] = T(0);
      if (rb < n) ws_b[(size_t)rb * NV + c] = T(0);
    }
  }

#pragma unroll 1
  for (int ta = a_begin; ta < a_end; ++ta) {
    const int i = ta * kTile + threadIdx.x;
    // rows past n: a blob of unit radius at (0, 0, 1) with a zero vector
    T pi[kQ] = {T(0), T(0), T(1), T(1), T(1)}, vi[NV], acc[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      vi[c] = T(0);
      acc[c] = T(0);
    }
    if (i < n) {
#pragma unroll
      for (int c = 0; c < kQ; ++c) pi[c] = q[kQ * i + c];
#pragma unroll
      for (int c = 0; c < NV; ++c) vi[c] = vec[(size_t)i * NV + c];
    }
    const Target<T> tgt = make_target(pi);
    Box<T> box_a;
    if constexpr (kTileTest) box_a = pairk::tile_box(pi, s_box);
#pragma unroll 1
    for (int tb = ga == gb ? ta : b_begin; tb < b_end; ++tb) {
      if (tb == ta) {  // the diagonal tile: every ordered pair, self included
        __syncthreads();  // s_src may still be read for the previous tile
        T* row = s_src[threadIdx.x];
#pragma unroll
        for (int c = 0; c < kQ; ++c) row[c] = pi[c];
#pragma unroll
        for (int c = 0; c < NV; ++c) row[kQ + c] = vi[c];
        __syncthreads();
        const int count = min(kTile, n - ta * kTile);
        // the free surface's z test on the diagonal tile too: on an H100 at
        // 21e's scene, B = 2 takes 17.7 ms with it, 19.0-19.3 without
        // (PERF.md §6)
        bool diag_far = false;
        if constexpr (kFsPlane) diag_far = images_far(box_a, box_a);
        for (int k = 0; k < count; ++k) {
          T src[L];
          pairk::load_row<L>(s_src[k], src);
          if constexpr (G::kImages) {
            pairk::BlockSum<T> m;
            if (diag_far)
              m = box_sum<T, MODE, false, kFsPlane>(geom, tgt, src);
            else
              m = box_sum<T, MODE, false>(geom, tgt, src);
#pragma unroll
            for (int b = 0; b < B; ++b)
              m.apply(src + kQ + 3 * b, acc + 3 * b);
          } else {
            const Geo<T> g = make_geo<T, MODE>(tgt, src);
            const Diag<T> m = condense<T, MODE, true>(g, tgt, src);
#pragma unroll
            for (int b = 0; b < B; ++b)
              pairk::diag_apply(m, g.dx, g.dy, src + kQ + 3 * b,
                                acc + 3 * b);
          }
        }
        continue;
      }
      // off the diagonal: the tile pair's path, then its rotations
      bool tile_far = false;
      if constexpr (kTileTest) {
        const int j = tb * kTile + threadIdx.x;
        T pj[kQ] = {T(0), T(0), T(1), T(1), T(1)};
        if (j < n) {
#pragma unroll
          for (int c = 0; c < kQ; ++c) pj[c] = q[kQ * j + c];
        }
        const Box<T> box_b = pairk::tile_box(pj, s_box);
        if constexpr (kFsPlane)
          tile_far = images_far(box_a, box_b);
        else
          tile_far = boxes_far(box_a, box_b);
      }
      if constexpr (!kTileTest)
        rotate<T, B, MODE, false>(q, vec, n, tb, tgt, vi, acc, s_sum, geom);
      else if (tile_far)
        rotate<T, B, MODE, true>(q, vec, n, tb, tgt, vi, acc, s_sum, geom);
      else
        rotate<T, B, MODE, false>(q, vec, n, tb, tgt, vi, acc, s_sum, geom);
      __syncthreads();
      pairk::add_source_sums<T, NV>(s_sum, ws_b, tb * kTile + threadIdx.x, n);
      __syncthreads();  // s_sum is refilled by the next tile pair
    }
    if (i < n) {
#pragma unroll
      for (int c = 0; c < NV; ++c) ws_a[(size_t)i * NV + c] += acc[c];
    }
  }
}

// The open free surface with two targets a lane (radii_sym2_kernel): the
// layout of pairk::sym2_kernel (64 threads, rows by pairk::row2) on rows
// (x, y, z, a, 1/a). The tile test is the open domain's (boxes_far and
// above_plane); a far tile pair rotates four coordinates of a source,
// leaving out 1/a, which only the full path reads, and unrolls its steps by
// two. Other tile pairs vote once a step for both of a lane's pairs.
template <typename T>
constexpr int min_blocks2() {
  return sizeof(T) != 4 ? 1 : 12;
}

template <typename T, int B, bool TILE_FAR>
__device__ __forceinline__ void rotate2(const T* __restrict__ q,
                                        const T* __restrict__ vec, int n,
                                        int tb, const Target<T> (&tgt)[2],
                                        T (&vi)[2][3 * B],
                                        T (&acc)[2][3 * B],
                                        T (*s_sum)[kTile][3 * B]) {
  constexpr int NV = 3 * B;
  // the far path reads a source's x, y, z and a
  constexpr int NQ = TILE_FAR ? 4 : kQ;
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int next = (lane + 1) % kLanes;
#pragma unroll 1
  for (int chunk = 0; chunk < kTile / kLanes; ++chunk) {
    const int j = tb * kTile + chunk * kLanes + lane;
    T pj[kQ] = {T(0), T(0), T(1), T(1), T(1)}, vj[NV], accj[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      vj[c] = T(0);
      accj[c] = T(0);
    }
    if (j < n) {
#pragma unroll
      for (int c = 0; c < NQ; ++c) pj[c] = q[kQ * j + c];
#pragma unroll
      for (int c = 0; c < NV; ++c) vj[c] = vec[(size_t)j * NV + c];
    }
#pragma unroll (TILE_FAR ? 2 : 1)
    for (int step = 0; step < kLanes; ++step) {
      const Geo<T> g[2] = {make_geo<T, kFreeSurface>(tgt[0], pj),
                           make_geo<T, kFreeSurface>(tgt[1], pj)};
      // one path for the warp's 64 pairs: the far form when all are far
      const bool far =
          TILE_FAR || __all_sync(0xffffffffu, g[0].far && g[1].far);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Diag<T> m =
            far ? condense<T, kFreeSurface, false>(g[h], tgt[h], pj)
                : condense<T, kFreeSurface, true>(g[h], tgt[h], pj);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          pairk::diag_apply(m, g[h].dx, g[h].dy, vj + 3 * b,
                            acc[h] + 3 * b);
          pairk::diag_apply_t(m, g[h].dx, g[h].dy, vi[h] + 3 * b,
                              accj + 3 * b);
        }
      }
#pragma unroll
      for (int c = 0; c < NQ; ++c)
        pj[c] = __shfl_sync(0xffffffffu, pj[c], next);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        vj[c] = __shfl_sync(0xffffffffu, vj[c], next);
        accj[c] = __shfl_sync(0xffffffffu, accj[c], next);
      }
    }
#pragma unroll
    for (int c = 0; c < NV; ++c)
      s_sum[warp][chunk * kLanes + lane][c] = accj[c];
  }
}

// One block of the open free surface: one pair of tile groups (GA, GB), GA
// <= GB, as pairk::sym2_kernel; the diagonal tile's directed pass with its
// self pairs takes every regime by its test
template <typename T, int B>
__global__ void __launch_bounds__(pairk::kThreads2, (min_blocks2<T>()))
radii_sym2_kernel(const T* __restrict__ q, const T* __restrict__ vec,
                  T* __restrict__ ws, int n, int n_groups,
                  int tiles_per_group) {
  constexpr int NV = 3 * B;
  constexpr int L = Row<T, B>::value;
  using pairk::row2;
  __shared__ __align__(16) T s_src[kTile][L];
  __shared__ T s_sum[pairk::kWarps2][kTile][NV];
  __shared__ T s_box[pairk::kWarps2][7];

  int ga, gb;
  pairk::group_pair(blockIdx.x, n_groups, ga, gb);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int a_begin = ga * tiles_per_group;
  const int a_end = min(n_tiles, a_begin + tiles_per_group);
  const int b_begin = gb * tiles_per_group;
  const int b_end = min(n_tiles, b_begin + tiles_per_group);
  T* ws_a = ws + (size_t)gb * n * NV;  // target-side sums of group GA
  T* ws_b = ws + (size_t)ga * n * NV;  // source-side sums of group GB
#pragma unroll 1
  for (int t = 0; t < tiles_per_group; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ra = (a_begin + t) * kTile + row2(h);
      const int rb = (b_begin + t) * kTile + row2(h);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        if (ra < n) ws_a[(size_t)ra * NV + c] = T(0);
        if (rb < n) ws_b[(size_t)rb * NV + c] = T(0);
      }
    }
  }

#pragma unroll 1
  for (int ta = a_begin; ta < a_end; ++ta) {
    // rows past n: a blob of unit radius at (0, 0, 1) with a zero vector
    T pi[2][kQ], vi[2][NV], acc[2][NV];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ta * kTile + row2(h);
      pi[h][0] = T(0);
      pi[h][1] = T(0);
      pi[h][2] = T(1);
      pi[h][3] = T(1);
      pi[h][4] = T(1);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        vi[h][c] = T(0);
        acc[h][c] = T(0);
      }
      if (i < n) {
#pragma unroll
        for (int c = 0; c < kQ; ++c) pi[h][c] = q[kQ * i + c];
#pragma unroll
        for (int c = 0; c < NV; ++c) vi[h][c] = vec[(size_t)i * NV + c];
      }
    }
    const Target<T> tgt[2] = {make_target(pi[0]), make_target(pi[1])};
    const Box<T> box_a = pairk::tile_box2(pi[0], pi[1], s_box);
#pragma unroll 1
    for (int tb = ga == gb ? ta : b_begin; tb < b_end; ++tb) {
      if (tb == ta) {  // the diagonal tile: every ordered pair, self included
        __syncthreads();  // s_src may still be read for the previous tile
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          T* row = s_src[row2(h)];
#pragma unroll
          for (int c = 0; c < kQ; ++c) row[c] = pi[h][c];
#pragma unroll
          for (int c = 0; c < NV; ++c) row[kQ + c] = vi[h][c];
        }
        __syncthreads();
        const int count = min(kTile, n - ta * kTile);
        for (int k = 0; k < count; ++k) {
          T src[L];
          pairk::load_row<L>(s_src[k], src);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const Geo<T> g = make_geo<T, kFreeSurface>(tgt[h], src);
            const Diag<T> m = condense<T, kFreeSurface, true>(g, tgt[h], src);
#pragma unroll
            for (int b = 0; b < B; ++b)
              pairk::diag_apply(m, g.dx, g.dy, src + kQ + 3 * b,
                                acc[h] + 3 * b);
          }
        }
        continue;
      }
      // off the diagonal: the tile pair's path, then its rotations
      T pj[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = tb * kTile + row2(h);
        pj[h][0] = T(0);
        pj[h][1] = T(0);
        pj[h][2] = T(1);
        pj[h][3] = T(1);
        if (j < n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) pj[h][c] = q[kQ * j + c];
        }
      }
      const Box<T> box_b = pairk::tile_box2(pj[0], pj[1], s_box);
      if (boxes_far(box_a, box_b) && above_plane(box_a, box_b))
        rotate2<T, B, true>(q, vec, n, tb, tgt, vi, acc, s_sum);
      else
        rotate2<T, B, false>(q, vec, n, tb, tgt, vi, acc, s_sum);
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tb * kTile + row2(h);
        if (row < n) {
#pragma unroll
          for (int c = 0; c < NV; ++c)
            ws_b[(size_t)row * NV + c] +=
                s_sum[0][row2(h)][c] + s_sum[1][row2(h)][c];
        }
      }
      __syncthreads();  // s_sum is refilled by the next tile pair
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ta * kTile + row2(h);
      if (i < n) {
#pragma unroll
        for (int c = 0; c < NV; ++c) ws_a[(size_t)i * NV + c] += acc[h][c];
      }
    }
  }
}

template <typename T, int B, int MODE, typename G>
int launch_bm(const T* q, const T* vec, T* out, T* ws, int n, int n_groups,
              int tiles_per_group, const G& geom, cudaStream_t s) {
  const long long n_pairs =
      static_cast<long long>(n_groups) * (n_groups + 1) / 2;
  if constexpr (MODE == kFreeSurface && !G::kImages)
    radii_sym2_kernel<T, B>
        <<<static_cast<unsigned>(n_pairs), pairk::kThreads2, 0, s>>>(
            q, vec, ws, n, n_groups, tiles_per_group);
  else
    radii_sym_kernel<T, B, MODE, G>
        <<<static_cast<unsigned>(n_pairs), kTile, 0, s>>>(
            q, vec, ws, n, n_groups, tiles_per_group, geom);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long len = static_cast<long long>(n) * 3 * B;
  pairk::slice_sum_kernel<T>
      <<<static_cast<unsigned>((len + 255) / 256), 256, 0, s>>>(
          ws, out, n_groups, len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int B, typename G>
int launch_b(const T* q, const T* vec, T* out, T* ws, int n, int n_groups,
             int tiles_per_group, int mode, const G& geom, cudaStream_t s) {
  switch (mode) {
    case kOpen:
      return launch_bm<T, B, kOpen>(q, vec, out, ws, n, n_groups,
                                    tiles_per_group, geom, s);
    case kWall:
      return launch_bm<T, B, kWall>(q, vec, out, ws, n, n_groups,
                                    tiles_per_group, geom, s);
    case kFreeSurface:
      return launch_bm<T, B, kFreeSurface>(q, vec, out, ws, n, n_groups,
                                           tiles_per_group, geom, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q (n,5) rows (x, y, z_eff, a, 1/a), vec (n, 3 n_rhs) b-major columns, out
// (n, 3 n_rhs), ws (n_groups, n, 3 n_rhs); all contiguous on the device;
// n > 0, n_rhs 1 or 2, groups of tiles_per_group 128-blob tiles covering
// n; mode 0 (open), 1 (wall) or 2 (free surface). Returns the CUDA error
// code of the launches.
template <typename T, typename G>
int launch(const T* q, const T* vec, T* out, T* ws, int n, int n_rhs,
           int n_groups, int tiles_per_group, int mode, const G& geom,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || ws == nullptr || n_groups < 1 || n_groups > 65535 ||
      tiles_per_group < 1 ||
      static_cast<long long>(n_groups) * tiles_per_group * kTile < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rhs == 1)
    return launch_b<T, 1>(q, vec, out, ws, n, n_groups, tiles_per_group,
                          mode, geom, s);
  if (n_rhs == 2)
    return launch_b<T, 2>(q, vec, out, ws, n, n_groups, tiles_per_group,
                          mode, geom, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the image boxes of the host arrays L (3,) and off (n_boxes, 3) in
// physical units: PlaneBoxes when the list is the in-plane one with both
// lengths above kPlaneFarMin times the largest radius a_max, ImageBoxes
// otherwise
template <typename T>
int launch_img(const T* q, const T* vec, T* out, T* ws, int n, int n_rhs,
               int n_groups, int tiles_per_group, int mode, const double* L,
               int n_boxes, const double* off, double a_max, void* stream) {
  pairk::PlaneBoxes<T> plane{};
  if (a_max > 0.0 && pairk::plane_boxes(L, n_boxes, off, plane,
                                        pairk::kPlaneFarMin * a_max))
    return launch<T>(q, vec, out, ws, n, n_rhs, n_groups, tiles_per_group,
                     mode, plane, stream);
  pairk::ImageBoxes<T> g{};
  if (!pairk::image_boxes(L, n_boxes, off, g))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<T>(q, vec, out, ws, n, n_rhs, n_groups, tiles_per_group,
                   mode, g, stream);
}

}  // namespace

extern "C" int pair_radii_sym_f32(const float* q, const float* vec,
                                  float* out, float* ws, int n, int n_rhs,
                                  int n_groups, int tiles_per_group,
                                  int mode, void* stream) {
  return launch<float>(q, vec, out, ws, n, n_rhs, n_groups, tiles_per_group,
                       mode, RadiiOpen(), stream);
}

extern "C" int pair_radii_sym_f64(const double* q, const double* vec,
                                  double* out, double* ws, int n, int n_rhs,
                                  int n_groups, int tiles_per_group,
                                  int mode, void* stream) {
  return launch<double>(q, vec, out, ws, n, n_rhs, n_groups,
                        tiles_per_group, mode, RadiiOpen(), stream);
}

// the image-box instances: the same arguments, then L (3,), the box in
// physical units (0 on an open axis), the count and the boxes' offsets b
// L (host arrays, the home box first), and the largest radius
extern "C" int pair_radii_sym_img_f32(const float* q, const float* vec,
                                      float* out, float* ws, int n,
                                      int n_rhs, int n_groups,
                                      int tiles_per_group, int mode,
                                      const double* L, int n_boxes,
                                      const double* off, double a_max,
                                      void* stream) {
  return launch_img<float>(q, vec, out, ws, n, n_rhs, n_groups,
                           tiles_per_group, mode, L, n_boxes, off, a_max,
                           stream);
}

extern "C" int pair_radii_sym_img_f64(const double* q, const double* vec,
                                      double* out, double* ws, int n,
                                      int n_rhs, int n_groups,
                                      int tiles_per_group, int mode,
                                      const double* L, int n_boxes,
                                      const double* off, double a_max,
                                      void* stream) {
  return launch_img<double>(q, vec, out, ws, n, n_rhs, n_groups,
                            tiles_per_group, mode, L, n_boxes, off, a_max,
                            stream);
}
