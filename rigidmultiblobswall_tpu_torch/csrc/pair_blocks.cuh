// Kernel K1: the direct O(N^2) pair product of the RPY mobility with the
// Swan-Brady single-wall corrections, for every coupling:
//   tt    U = M_tt F          tr  U = M_tr T
//   rt    W = M_rt F          rr  W = M_rr T
//   grand (U, W a) = [[M_tt, M_tr], [M_rt, M_rr]] (F, T / a) in one pass
// on B stacked right-hand sides.
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/pair_kernels.py
// (_pair_kernel; wrapper pair_matvec_pallas). Same units: lengths are in
// blob radii, heights already shifted to max(z, a) and the vector already
// damped by the caller, which also applies 1/(8 pi eta a^k) and the target
// damping. csrc/pair_tt.cu instantiates the tt coupling, and
// csrc/pair_couplings.cu the others; both include this header.
//
// What bounds it on the H100: instruction issue, not bytes. The inputs
// are 12-24 bytes a source against ~70 float operations a pair to
// condense a 3x3 block into a few scalars (two rsqrt, the wall polynomial
// set) and ~10 a block and right-hand side to apply it; grand condenses
// all four blocks (28 scalars) from one shared geometry. So neither TMA
// nor cp.async staging is a lever, and a per-pair nonlinear sum has no
// matrix product for wgmma or the tensor cores. In the SASS the sliced tt
// loop issues ~85 instructions a pair and grand's ~240, and the measured
// rates (tools/torch_profile_kernels.py, PERF.md) put both near the SMs' issue
// rate: the lever is fewer instructions a pair, hence the symmetric sweep
// (sym_kernel below) that every square product takes (ops/pair_kernels.py
// pair_matvec with q_tgt None): it condenses each unordered pair once,
// and for tr and rt also the other cross block of the pair, which shares
// all of its terms but three FMAs (cross_shared).
//
// Design of the sliced sweep (pair_kernel), for a card of 132 SMs that one
// thread per target cannot fill (49,152 targets are 384 blocks of 4
// warps, ~12 warps an SM of 64):
// - the grid is (target tiles x S source slices); each block sums its
//   slice of whole 128-source tiles and writes one partial row per target
//   into a workspace (S, Nt, nc B) that the wrapper allocates; a second
//   small kernel adds the S partials in slice order. No atomics, so every
//   instance is bit-identical on repeat. S comes from the wrapper's plan
//   (ops/pair_kernels.py plan_slices) from Nt, Ns, the SM count and the
//   resident blocks an SM holds (pair_*_shape below); S = 1 writes the
//   output directly;
// - one thread per target row, sources staged through shared memory a
//   tile at a time as padded rows (position, then the vector),
//   so a pair reads its source with broadcast 16-byte loads; per-tile
//   partial sums keep the f32 rounding of an N-term sum near
//   sqrt(N / 128) steps;
// - no division in the pair loop: the wall coefficients are written on
//   h e_z = h / R, h e_z^2 = h Rz / R^2, h(1 - h) e_z^2 = zs zt / R^2 and
//   h^2 e_z^2 = zs^2 / R^2 (h = zs / Rz or zt / Rz), with the 1/3 factors
//   folded into constants; one geometry a pair, with one rsqrt of r^2 and
//   one of R^2 (rsqrt.approx.ftz in float32), serves every block; the
//   near and self forms sit in one rarely entered branch;
// - __launch_bounds__ asks for 8 resident blocks an SM in float32 (Shape
//   below): 64 registers a thread at most (ptxas on sm_90a, PERF.md §6
//   lists each instance's count); the image-box instances 6, 80
//   registers; the open free surface's two-targets sweep (sym2_kernel)
//   12 blocks of 64 threads at B = 1 (80 registers), 10 at B = 2 (96;
//   Shape2). float64 is not capped.
// Ragged edges are masked by index; there is no padding of the inputs.
//
// Near/far switch: the near forms for r <= 2 (the JAX package switches
// rr and the cross blocks at r >= 2; both forms agree at r = 2), taken in
// one rarely entered branch. Self pair (i == j with self_interaction) and
// coincident distinct blobs (r^2 == 0, i != j): the tt core is 4/3 and 0,
// the rr core 1 and 0, the cross core 0 and 0. The wall terms evaluated at
// the self geometry (dx = dy = 0, Rz = 2z) ARE the wall self-mobility of
// every block and are kept.
//
// Image-box instances (the pseudo-periodic boxes of the JAX package's
// ops/mobility.py pairwise_matvec with a periodic_length, XLA there): both
// sweeps take a pair geometry policy, OpenBox for the open domain and
// ImageBoxes or PlaneBoxes for a box of lengths L (in blob radii, 0 on an
// open axis). Each takes d = r_t - r_s to the minimum image in the
// truncation form d - trunc(d/L + sign(d)/2) L, in float64, in the home
// box, then condenses the block of every box d + b L of the wrapper's list
// (b in {-1, 0, 1} on each periodic axis, (0, 0, 0) first, at most 27): the
// offset is added to the home box's d, which the minimum image keeps within
// L/2, so d + b L rounds once from it. No box is pruned (the blocks decay
// as 1/r). The self pair is the self block in the home box only; in every
// other box a blob's own image is an ordinary pair at d = b L with both
// heights z_i, whose blocks do not cancel, so the diagonal tile's directed
// pass adds them. The symmetric sweep applies a pair's box sum both ways,
// as in the open domain: min_image is odd in d and the box list is
// symmetric under b -> -b, so pair (j, i) in box -b has the displacement
// -(d + b L) and its block M(-(d + b L); z_j, z_i) = M(d + b L; z_i, z_j)^T
// (the reciprocity of every single block that the open sweep rests on).
// - PlaneBoxes, chosen on the host (with_boxes; ops/pair_kernels.py
//   plane_far mirrors the choice for the launch plan) for the 3 x 3 list of
//   a box periodic in x and y and open in z with both L above
//   kPlaneFarMin: z is never imaged, so dz, Rz and the heights' products
//   are the same in every box, and the in-plane offsets and their squares
//   are formed once a column and a row; the boxes off the home box lie at r
//   >= L/2 > 2 and take the far form alone, their near, zero and self
//   predicates compiled out. ImageBoxes takes every other list (a box
//   periodic in z, L <= kPlaneFarMin, one periodic axis).
// - The diagonal couplings (tt, rr) sum a pair's boxes into one 3 x 3 block
//   (BlockSum, ~10 multiply-adds a box) and apply it once to the target and
//   once transposed to the source, 9 B multiply-adds each way, in place of
//   the 2 x 10 B of applying each box both ways. The cross and grand
//   couplings apply each box both ways into a sum of the pair's own (a box
//   sum of grand's four blocks would hold 36 sums). Either way a pair's
//   boxes are summed apart and join the running sums once, so the float32
//   rounding of a row's sum does not grow with the number of boxes.
// - The free surface's tt (FreeSurface) under PlaneBoxes sums no block:
//   dz and Rz are the same in every box, so each box adds the four
//   coefficients of the pair and of its image into FsMoments' eleven sums,
//   and dz and Rz are folded in once a pair when they close into the
//   pair's block (sum_blocks).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace pairk {

constexpr int kTile = 128;

// rsqrt.approx with denormals flushed: rsqrtf's own denormal scaling
// costs four more instructions a call, and no pair geometry is denormal
__device__ __forceinline__ float rsqrt_t(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// a multiply-add the compiler keeps fused whatever it makes of a * b + c
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// geometry of one (target, source) pair, shared by every block
template <typename T>
struct Pair {
  T dx, dy, dz, r2;
  T invr;                 // 1/r (inf when r == 0)
  bool self, zero;        // zero: self pair or coincident blobs
  bool near;              // r <= 2, zero pairs included: the rare branch
  T zt, zs, Rz, invR;     // wall image: Rz = zt + zs, invR = 1/|R|
  T R2;                   // |R|^2, R = (dx, dy, Rz)
  bool img_near;          // |R| <= 2 (the free surface's image)
};

// the pair of displacement (dx, dy, dz) = r_t - r_s at the heights zt and
// zs from its squared in-plane distance xy2; with `far` (a constant where
// the caller's loop unrolls: PlaneBoxes' boxes off the home box) the pair
// is known to lie at r > 2, and its self, zero and near flags are the
// constant false that folds the couplings' near branches away
template <typename T, bool WALL>
__device__ __forceinline__ Pair<T> box_pair(T dx, T dy, T xy2, T dz, T zt,
                                            T zs, bool self, bool far) {
  Pair<T> p;
  p.dx = dx;
  p.dy = dy;
  p.dz = dz;
  p.r2 = xy2 + dz * dz;
  p.self = !far && self;
  p.zero = !far && (self || (p.r2 == T(0)));
  p.near = !far && !(p.r2 > T(4));
  p.invr = rsqrt_t(p.r2);
  p.zt = zt;
  p.zs = zs;
  if (WALL) {
    p.Rz = zt + zs;
    p.R2 = p.Rz * p.Rz + xy2;
    p.invR = rsqrt_t(p.R2);
    // a far box lies at xy2 > 4, and so does its image
    p.img_near = !far && !(p.R2 > T(4));
  }
  return p;
}

// the pair of displacement (dx, dy, dz) = r_t - r_s (of an image box, where
// it is not the difference of the heights) at the heights zt and zs
template <typename T, bool WALL>
__device__ __forceinline__ Pair<T> make_pair_d(T dx, T dy, T dz, T zt, T zs,
                                               bool self) {
  return box_pair<T, WALL>(dx, dy, dx * dx + dy * dy, dz, zt, zs, self,
                           false);
}

template <typename T, bool WALL>
__device__ __forceinline__ Pair<T> make_pair(T xt, T yt, T zt, T xs, T ys,
                                             T zs, bool self) {
  return make_pair_d<T, WALL>(xt - xs, yt - ys, zt - zs, zt, zs, self);
}

// The pair geometry policies of the sweeps: visit hands the coupling the
// pair (or pairs) of a target and a source; Stage is the type a caller that
// forms the positions itself (kernel K3) forms them in. OpenBox: the open
// domain, one pair.
template <typename T>
struct OpenBox {
  using Stage = T;
  static constexpr bool kImages = false;
  template <bool WALL, typename F>
  __device__ __forceinline__ void visit(T xt, T yt, T zt, T xs, T ys, T zs,
                                        bool self, F&& f) const {
    f(make_pair<T, WALL>(xt, yt, zt, xs, ys, zs, self));
  }
};

// d - trunc(d/L + sign(d)/2) L on a periodic axis (the JAX package's
// _min_image), in float64 whatever the instance's type: d = x_t - x_s is
// exact there for float32 inputs, so the float32 instances pick the image
// that the float64 plain version picks from the same inputs. (Formed in
// float32, d/L would round across the half-box of some pairs and pick the
// other image; the box sum jumps there, by the cross and wall blocks' odd
// parts at 1.5 L, since the list holds b in {-1, 0, 1} only.) The quotient
// is d (1/L) with 1/L rounded once on the host, against the plain
// version's d / L: the two choices differ only for d/L within a float64
// ulp of a half-integer. The image is odd in d, ties included.
__device__ __forceinline__ double min_image(double d, double L,
                                            double inv_L) {
  const double half = d > 0.0 ? 0.5 : (d < 0.0 ? -0.5 : 0.0);
  return d - trunc(d * inv_L + half) * L;
}

// ImageBoxes: the minimum image in the home box, then one pair a box of
// the list, the self flag in the home box (off[0] = 0) only.
constexpr int kMaxBoxes = 27;
template <typename T>
struct ImageBoxes {
  using Stage = double;
  static constexpr bool kImages = true;
  double L[3];           // box lengths / a, 0 on an open axis
  double inv_L[3];       // 1 / L, 0 on an open axis
  int n;                 // boxes in the list, 1..kMaxBoxes
  T off[kMaxBoxes][3];   // b L / a, the home box first
  // the minimum image on a periodic axis, d itself on an open one
  template <typename U>
  __device__ __forceinline__ T image(U xt, U xs, int a) const {
    if (!(L[a] > 0.0)) return T(xt) - T(xs);
    return static_cast<T>(min_image(static_cast<double>(xt) -
                                        static_cast<double>(xs),
                                    L[a], inv_L[a]));
  }
  // positions of type U: T, or float64 where the caller forms them (K3);
  // the boxes run in a loop whatever UNROLL asks
  template <bool WALL, bool UNROLL = true, typename U, typename F>
  __device__ __forceinline__ void visit(U xt, U yt, U zt, U xs, U ys, U zs,
                                        bool self, F&& f) const {
    const T dx = image(xt, xs, 0);
    const T dy = image(yt, ys, 1);
    const T dz = image(zt, zs, 2);
#pragma unroll 1
    for (int b = 0; b < n; ++b)
      f(make_pair_d<T, WALL>(dx + off[b][0], dy + off[b][1], dz + off[b][2],
                             T(zt), T(zs), self && b == 0));
  }
};

// PlaneBoxes: the nine boxes of L = (Lx, Ly, 0) in box_offsets' order,
// each L above kPlaneFarMin blob radii (plane_boxes checks both). The minimum
// image keeps |dx| <= Lx/2 and |dy| <= Ly/2, so every box but the home one
// lies at r >= min(Lx, Ly)/2 > 2.02, outside the near forms with a margin
// that no float32 rounding of d + b L crosses: those boxes take the far
// form alone (box_pair: no near, zero or self predicate; the couplings'
// near branches fold away). The loop over the boxes is unrolled, so dz, Rz
// and zs zt are formed once a pair and shared, and the columns' dx + bx Lx
// and rows' dy + by Ly with their squares once each: a box costs xy2, r^2,
// R^2, the two rsqrt and the condense. A caller whose per-box work holds
// many sums (grand's four blocks applied both ways) asks for UNROLL
// false: the home box, then the eight far boxes in a loop, each forming
// its own offsets, which keeps its registers from spilling.
constexpr double kPlaneFarMin = 4.04;
template <typename T>
struct PlaneBoxes {
  using Stage = double;
  static constexpr bool kImages = true;
  double L[2];           // Lx / a, Ly / a
  double inv_L[2];
  T Lx, Ly;              // the same rounded to T: the offsets b L
  template <bool WALL, bool UNROLL = true, typename U, typename F>
  __device__ __forceinline__ void visit(U xt, U yt, U zt, U xs, U ys, U zs,
                                        bool self, F&& f) const {
    const T dx = static_cast<T>(min_image(
        static_cast<double>(xt) - static_cast<double>(xs), L[0], inv_L[0]));
    const T dy = static_cast<T>(min_image(
        static_cast<double>(yt) - static_cast<double>(ys), L[1], inv_L[1]));
    const T zt_ = T(zt), zs_ = T(zs);
    const T dz = zt_ - zs_;
    if constexpr (!UNROLL) {
      f(make_pair_d<T, WALL>(dx, dy, dz, zt_, zs_, self));
#pragma unroll 1
      for (int k = 1; k < 9; ++k) {
        const int idx = k - 1 + (k >= 5 ? 1 : 0);
        // b L exact, so dx + b Lx rounds as the unrolled dx -+ Lx does
        const T x = dx + T(idx / 3 - 1) * Lx;
        const T y = dy + T(idx % 3 - 1) * Ly;
        f(box_pair<T, WALL>(x, y, x * x + y * y, dz, zt_, zs_, false,
                            true));
      }
      return;
    }
    boxes(dx, dy, [&](T x, T y, T xy2, bool far) {
      f(box_pair<T, WALL>(x, y, xy2, dz, zt_, zs_, self, far));
    });
  }
  // f(x, y, x^2 + y^2, far) on the nine boxes of the minimum image (dx,
  // dy): the home box (column 1, row 1; far false), then (bx, by)
  // row-major over {-1, 0, 1}^2 without (0, 0), x = dx + bx Lx and y = dy
  // + by Ly; the offsets and their squares formed once a column and a row,
  // and unrolled, so every index is a constant
  template <typename F>
  __device__ __forceinline__ void boxes(T dx, T dy, F&& f) const {
    const T ox[3] = {dx - Lx, dx, dx + Lx};
    const T oy[3] = {dy - Ly, dy, dy + Ly};
    T ox2[3], oy2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ox2[c] = ox[c] * ox[c];
      oy2[c] = oy[c] * oy[c];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int idx = k == 0 ? 4 : k - 1 + (k >= 5 ? 1 : 0);
      const int c = idx / 3, r = idx % 3;
      f(ox[c], oy[r], ox2[c] + oy2[r], k != 0);
    }
  }
};

// condensed diagonal block (tt, rr): m_ab v_b with five scalars
template <typename T>
struct Diag {
  T A, S, P, Q, mzz;
};

// condensed cross block (tr, rt): the core coefficient c and the wall
// terms F1, K, G3, H (cross_condense below)
template <typename T>
struct Cross {
  T c, F1, K, G3, H;
};

// unbounded RPY core: m_ab = c1 delta_ab + c2 d_a d_b; tt_near replaces
// the far form (c1, c2) in the rare near branch
template <typename T>
__device__ __forceinline__ void tt_near(const Pair<T>& p, T& c1, T& c2) {
  if (__builtin_expect(p.near, 0)) {
    if (p.zero) {
      c1 = p.self ? T(4.0 / 3.0) : T(0);
      c2 = T(0);
    } else {  // 4/3 (1 - 9 r / 32), (4/3) (3/32) / r
      c1 = T(4.0 / 3.0) - T(0.375) * (p.r2 * p.invr);
      c2 = T(0.125) * p.invr;
    }
  }
}

// the far form (c1, c2) at 1/r = w by explicit multiply-adds: written as
// tt_condense writes it, 2 w^2 compiles to w^2 + w^2 and 1 - 2 w^2 to a
// second add (the free surface's box sums, sum_blocks)
template <typename T>
__device__ __forceinline__ void rpy_far(T w, T& c1, T& c2) {
  const T w2 = w * w;
  c1 = fma_t(T(2.0 / 3.0), w2, T(1)) * w;
  c2 = fma_t(T(-2), w2, T(1)) * (w2 * w);
}

template <typename T, bool WALL>
__device__ __forceinline__ Diag<T> tt_condense(const Pair<T>& p) {
  const T invr = p.invr;
  const T invr2 = invr * invr;
  T c1 = (T(1) + T(2.0 / 3.0) * invr2) * invr;
  T c2 = (T(1) - T(2) * invr2) * invr2 * invr;
  tt_near(p, c1, c2);
  Diag<T> m;
  if (WALL) {
    // Swan-Brady image system of ops/rpy.py's wall_tt on raw (dx, dy, Rz)
    // products, with W = 1/R, u = 1/R^2, e = e_z^2, k = h(1 - h) e_z^2
    // = zs zt u and s = h e_z / R = zs u for h = zs / Rz, the 1/3 factors
    // folded into constants and every step a multiply-add:
    //   f1 = -W n1, f2 = -W n2, f5 = -W n5, g2 = f2 u, g3 = W f3, g4 = W f4
    const T Rz = p.Rz, W = p.invR, dz = p.dz;
    const T u = W * W;
    const T Ru = Rz * u;
    const T e = Ru * Rz;
    const T k = p.zs * p.zt * u;
    const T s = p.zs * u;
    const T s2 = s + s;
    const T n1 = u * ((e * T(10.0 / 3.0) - T(2.0 / 3.0)) * u +
                      (T(2.0 / 3.0) - T(2) * e)) +
                 (T(2) * k + T(1));
    const T n2 = (T(1) - T(6) * k) -
                 u * ((e * T(70.0 / 3.0) - T(10.0 / 3.0)) * u +
                      (T(2) - T(10) * e));
    const T f3 = Ru * (T(-12) * k +
                       u * ((T(40.0 / 3.0) - e * T(140.0 / 3.0)) * u +
                            (e * T(20) - T(4)))) +
                 s2;
    const T f4 = (Ru * u) * (T(-20.0 / 3.0) * u) + s2;
    const T n5 = (p.zs * s) * T(4) +
                 u * ((T(8.0 / 3.0) - e * T(20)) * u + T(4) * e);
    const T g2 = -(W * u) * n2;
    const T g3 = W * f3;
    const T g4 = W * f4;
    const T c2dz = c2 * dz;
    const T g2Rz = g2 * Rz;
    m.A = c1 - W * n1;
    m.S = c2 + g2;
    const T base_pq = c2dz + g2Rz;
    m.P = base_pq + g3;
    m.Q = base_pq + g4;
    m.mzz = (m.A + c2dz * dz) + Rz * (g2Rz + g3 + g4) - W * n5;
  } else {
    m.A = c1;
    m.S = c2;
    m.P = c2 * p.dz;
    m.Q = m.P;
    m.mzz = c1 + c2 * p.dz * p.dz;
  }
  return m;
}

// The free-surface tt block (a slip plane at z = 0; ops/rpy.py
// free_surface_tt): the RPY block at d plus the RPY block at the image
// R = (dx, dy, Rz), Rz = zt + zs, with its z column reflected, M_RPY(R)
// diag(1, 1, -1). With the image's coefficients e1, e2 the reflected
// block is [[e1 + e2 dx^2, e2 dx dy, -e2 Rz dx], [.., e1 + e2 dy^2,
// -e2 Rz dy], [e2 Rz dx, e2 Rz dy, -(e1 + e2 Rz^2)]]: K1's condensed
// Diag with A += e1, S += e2, P -= e2 Rz, Q += e2 Rz, mzz -= e1 + e2 Rz^2.
// Under d -> -d (the pair (j, i)) Rz stays, so P and Q trade places up to
// sign and M(j, i) = M(i, j)^T: the symmetric sweep and a pair's box sum
// hold as for tt. The image takes no self rule: at |R| <= 2 its near form
// (the self pair's included), at R = 0 (both blobs on the plane, one
// above the other's image) the coincident pair's 0. The pair geometry is
// the wall's (WALL = true): Rz, 1/|R| and the image's near flag; the
// heights are not shifted and nothing is damped.
template <typename T>
__device__ __forceinline__ void fs_image_near(const Pair<T>& p, T& e1,
                                              T& e2) {
  if (__builtin_expect(p.img_near, 0)) {
    if (p.R2 == T(0)) {
      e1 = T(0);
      e2 = T(0);
    } else {
      e1 = T(4.0 / 3.0) - T(0.375) * (p.R2 * p.invR);
      e2 = T(0.125) * p.invR;
    }
  }
}

template <typename T>
__device__ __forceinline__ Diag<T> fs_condense(const Pair<T>& p) {
  Diag<T> m = tt_condense<T, false>(p);
  const T W = p.invR;
  const T W2 = W * W;
  T e1 = (T(1) + T(2.0 / 3.0) * W2) * W;
  T e2 = (T(1) - T(2) * W2) * W2 * W;
  fs_image_near(p, e1, e2);
  const T e2Rz = e2 * p.Rz;
  m.A += e1;
  m.S += e2;
  m.P -= e2Rz;
  m.Q += e2Rz;
  m.mzz -= e2Rz * p.Rz + e1;
  return m;
}

// The free-surface block of the open sweep with two targets a lane
// (sym2_kernel): the RPY core's and its image's coefficients at w = 1/r and
// W = 1/|R| as c1 = w + (2/3) w^3 and c2 = (1 - 2 w^2) w^3, five
// instructions each, the near and zero forms where the pair's flags ask
// (the constant false in a far tile pair), and the Diag folded as
// fs_condense's: A = c1 + e1, S = c2 + e2, P = c2 dz - e2 Rz, Q = c2 dz +
// e2 Rz, mzz = c1 + c2 dz^2 - (e1 + e2 Rz^2)
template <typename T>
__device__ __forceinline__ void fs_coeffs(T w, T& c1, T& c2) {
  const T w2 = w * w;
  const T w3 = w2 * w;
  c1 = fma_t(T(2.0 / 3.0), w3, w);
  c2 = fma_t(T(-2), w2, T(1)) * w3;
}

template <typename T>
__device__ __forceinline__ Diag<T> fs_condense2(const Pair<T>& p) {
  T c1, c2, e1, e2;
  fs_coeffs(p.invr, c1, c2);
  tt_near(p, c1, c2);
  fs_coeffs(p.invR, e1, e2);
  fs_image_near(p, e1, e2);
  const T cdz = c2 * p.dz, eRz = e2 * p.Rz;
  Diag<T> m;
  m.A = c1 + e1;
  m.S = c2 + e2;
  m.P = cdz - eRz;
  m.Q = cdz + eRz;
  m.mzz = fma_t(cdz, p.dz, c1) - fma_t(eRz, p.Rz, e1);
  return m;
}

template <typename T, bool WALL>
__device__ __forceinline__ Diag<T> rr_condense(const Pair<T>& p) {
  const T invr = p.invr;
  const T invr2 = invr * invr;
  const T invr3 = invr2 * invr;
  T c1 = T(-0.5) * invr3;
  T c2 = T(1.5) * invr2 * invr3;
  if (__builtin_expect(p.near, 0)) {  // the two forms agree at r = 2
    if (p.zero) {
      c1 = p.self ? T(1) : T(0);
      c2 = T(0);
    } else {
      const T r = p.r2 * invr;
      c1 = T(1) - T(0.84375) * r + T(0.078125) * (p.r2 * r);
      c2 = T(0.28125) * invr - T(0.046875) * r;
    }
  }
  Diag<T> m;
  const T dz = p.dz;
  if (WALL) {
    // rpy.wall_rr folded onto raw products: G2 = f2 / R^2,
    // G24 = (f2 - f4) / R^2, g3 = f3 e_x / dx
    const T Rz = p.Rz, invR = p.invR;
    const T invR2 = invR * invR;
    const T invR3 = invR * invR2;
    const T ez2 = Rz * Rz * invR2;
    const T f1 = T(0.5) * (T(1) - T(6) * ez2) * invR3;
    const T f2 = T(-1.5) * invR3;
    const T f4 = T(3) * invR3;
    const T g3 = (T(3) * invR3 * Rz * invR) * invR;
    const T G2 = f2 * invR2;
    const T G24 = (f2 - f4) * invR2;
    m.A = c1 + (f1 + f4 * (T(1) - ez2));
    m.S = c2 + G24;
    m.P = c2 * dz + G2 * Rz;
    m.Q = m.P + g3;
    m.mzz = c1 + c2 * dz * dz + f1 + G2 * Rz * Rz + g3 * Rz;
  } else {
    m.A = c1;
    m.S = c2;
    m.P = c2 * dz;
    m.Q = m.P;
    m.mzz = c1 + c2 * dz * dz;
  }
  return m;
}

// The cross blocks. The wall part of tr's block is -Mw and of rt's -Mw^T,
// Mw the UT pattern of rpy._wall_cross_core in the in-plane displacement
// u (-d for tr, d for rt) and the wall height h (zt for tr, zs for rt).
// Folded onto raw (dx, dy, Rz) with W = 1/R, u2 = 1/R^2, e = e_z^2 and
// h_hat e_z = h W (F1 = f1 / R = W u2, F2 = f2 / R, G3 = f3 / R^2), every
// entry of Mw comes from F1 and three functions of h, each one FMA from
// terms of the pair alone:
//   K = F1 Rz + f4 = F1 Rz (1 + 2 u2) - 2 F1 h
//   G3 = -2 F1 u2 (3 h - 5 Rz u2) = -6 F1 u2 h + 10 F1 u2^2 Rz
//   H = F1 + F2 + G3 Rz = F1 (1 + 2 u2 (1 - 5 e)) + 6 F1 u2 Rz h
// and with w = ux vy - uy vx, pr = ux vx + uy vy
//   -Mw v   = (K vy - F1 uy vz - G3 ux w, -K vx + F1 ux vz - G3 uy w, -H w)
//   -Mw^T v = (G3 uy pr - K vy + H uy vz, -G3 ux pr + K vx - H ux vz, F1 w).
// The two cross blocks of one pair (tr's and rt's) share all but K, G3
// and H: CrossShared holds what they share, cross_block adds a height.
template <typename T>
struct CrossShared {
  T c, F1;           // the core coefficient, W u2
  T K0, Kh;          // K = K0 + Kh h
  T G0, Gh;          // G3 = G0 + Gh h
  T H0, Hh;          // H = H0 + Hh h
};

template <typename T, bool WALL>
__device__ __forceinline__ CrossShared<T> cross_shared(const Pair<T>& p) {
  CrossShared<T> s{};
  s.c = p.invr * p.invr * p.invr;
  if (__builtin_expect(p.near, 0))  // the two forms agree at r = 2
    s.c = p.zero ? T(0) : T(0.5) * (T(1) - T(0.375) * (p.r2 * p.invr));
  if (WALL) {
    const T Rz = p.Rz, W = p.invR;
    const T u2 = W * W;
    const T e = Rz * Rz * u2;
    s.F1 = W * u2;
    const T F1u2 = s.F1 * u2;
    s.K0 = s.F1 * Rz * (T(1) + T(2) * u2);
    s.Kh = T(-2) * s.F1;
    s.G0 = T(10) * F1u2 * (Rz * u2);
    s.Gh = T(-6) * F1u2;
    s.H0 = s.F1 + T(2) * F1u2 * (T(1) - T(5) * e);
    s.Hh = T(6) * F1u2 * Rz;
  }
  return s;
}

// the block at wall height h (tr: zt, rt: zs)
template <typename T, bool WALL>
__device__ __forceinline__ Cross<T> cross_block(const CrossShared<T>& s,
                                                T h) {
  Cross<T> m{};
  m.c = s.c;
  if (WALL) {
    m.F1 = s.F1;
    m.K = s.Kh * h + s.K0;
    m.G3 = s.Gh * h + s.G0;
    m.H = s.Hh * h + s.H0;
  }
  return m;
}

// IS_TR: tr, U from T, wall height z_target and reflected in-plane
// displacement; otherwise rt, W from F, wall height z_source
template <typename T, bool WALL, bool IS_TR>
__device__ __forceinline__ Cross<T> cross_condense(const Pair<T>& p) {
  return cross_block<T, WALL>(cross_shared<T, WALL>(p), IS_TR ? p.zt : p.zs);
}

// the apply steps add into the sums by multiply-adds, two a component
template <typename T>
__device__ __forceinline__ void diag_apply(const Diag<T>& m, T dx, T dy,
                                           const T* v, T* acc) {
  const T w = dx * v[0] + dy * v[1];
  const T u = m.S * w + m.P * v[2];
  acc[0] = dx * u + (m.A * v[0] + acc[0]);
  acc[1] = dy * u + (m.A * v[1] + acc[1]);
  acc[2] = m.Q * w + (m.mzz * v[2] + acc[2]);
}

// the transposed block, M^T v: P and Q trade places (the tt mobility is
// symmetric, M_ji = M_ij^T, so this is the source's share of a pair)
template <typename T>
__device__ __forceinline__ void diag_apply_t(const Diag<T>& m, T dx, T dy,
                                             const T* v, T* acc) {
  const T w = dx * v[0] + dy * v[1];
  const T u = m.S * w + m.Q * v[2];
  acc[0] = dx * u + (m.A * v[0] + acc[0]);
  acc[1] = dy * u + (m.A * v[1] + acc[1]);
  acc[2] = m.P * w + (m.mzz * v[2] + acc[2]);
}

// A pair's diagonal blocks (tt, rr) summed over its boxes as one 3 x 3
// matrix: diag_apply's block is [[A + S dx^2, S dx dy, P dx], [S dx dy, A
// + S dy^2, P dy], [Q dx, Q dy, mzz]], so the sum keeps sum A, sum S dx^2,
// sum S dx dy, sum S dy^2, sum P dx, sum P dy, sum Q dx, sum Q dy and
// sum mzz (add: two multiplies, six multiply-adds and two adds a box);
// close() folds sum A into the diagonal once a pair.
template <typename T>
struct BlockSum {
  T a, xx, xy, yy, xz, yz, zx, zy, zz;
  __device__ __forceinline__ void add(const Diag<T>& m, T dx, T dy) {
    const T sdx = m.S * dx, sdy = m.S * dy;
    a += m.A;
    xx = sdx * dx + xx;
    xy = sdx * dy + xy;
    yy = sdy * dy + yy;
    xz = m.P * dx + xz;
    yz = m.P * dy + yz;
    zx = m.Q * dx + zx;
    zy = m.Q * dy + zy;
    zz += m.mzz;
  }
  __device__ __forceinline__ void close() {
    xx += a;
    yy += a;
  }
  // acc += M v (closed)
  __device__ __forceinline__ void apply(const T* v, T* acc) const {
    acc[0] = xx * v[0] + (xy * v[1] + (xz * v[2] + acc[0]));
    acc[1] = xy * v[0] + (yy * v[1] + (yz * v[2] + acc[1]));
    acc[2] = zx * v[0] + (zy * v[1] + (zz * v[2] + acc[2]));
  }
  // acc += M^T v (closed): the source's share of the pair
  __device__ __forceinline__ void apply_t(const T* v, T* acc) const {
    acc[0] = xx * v[0] + (xy * v[1] + (zx * v[2] + acc[0]));
    acc[1] = xy * v[0] + (yy * v[1] + (zy * v[2] + acc[1]));
    acc[2] = xz * v[0] + (yz * v[1] + (zz * v[2] + acc[2]));
  }
};

// The free surface's block (fs_condense; P1's with per-blob radii alike)
// summed over PlaneBoxes' boxes by its coefficients. A box's block is
// BlockSum's with A = c1 + e1, S = c2 + e2, P = c2 dz - e2 Rz, Q = c2 dz +
// e2 Rz and mzz = c1 - e1 + c2 dz^2 - e2 Rz^2, (c1, c2) the RPY core's and
// (e1, e2) its image's, and z is never imaged: dz and Rz are the same in
// every box. So the box sum needs only the sums of c1, e1, c2, e2, (c2 +
// e2) dx^2, (c2 + e2) dx dy, (c2 + e2) dy^2, c2 dx, c2 dy, e2 dx and e2 dy
// (add: one add, two multiplies, four adds and seven multiply-adds a box),
// and close() folds dz and Rz in once a pair.
template <typename T>
struct FsMoments {
  T c1, e1, c2, e2;
  T xx, xy, yy;      // of (c2 + e2) dx^2, dx dy, dy^2
  T cx, cy, ex, ey;  // of c2 dx, c2 dy, e2 dx, e2 dy
  __device__ __forceinline__ void add(T c1_, T c2_, T e1_, T e2_, T dx,
                                      T dy) {
    const T s = c2_ + e2_;
    const T sdx = s * dx, sdy = s * dy;
    c1 += c1_;
    e1 += e1_;
    c2 += c2_;
    e2 += e2_;
    xx = sdx * dx + xx;
    xy = sdx * dy + xy;
    yy = sdy * dy + yy;
    cx = c2_ * dx + cx;
    cy = c2_ * dy + cy;
    ex = e2_ * dx + ex;
    ey = e2_ * dy + ey;
  }
  // the closed box sum (BlockSum after its close())
  __device__ __forceinline__ BlockSum<T> close(T dz, T Rz) const {
    BlockSum<T> m;
    m.a = c1 + e1;
    m.xx = xx + m.a;
    m.xy = xy;
    m.yy = yy + m.a;
    const T cxz = cx * dz, cyz = cy * dz;
    m.xz = cxz - ex * Rz;
    m.yz = cyz - ey * Rz;
    m.zx = ex * Rz + cxz;
    m.zy = ey * Rz + cyz;
    m.zz = ((c1 - e1) + c2 * (dz * dz)) - e2 * (Rz * Rz);
    return m;
  }
};

// TRANSPOSE applies the block's transpose: the core c [d x] changes sign
// and the wall pattern flips between -Mw and -Mw^T (cross_shared above)
template <typename T, bool WALL, bool IS_TR, bool TRANSPOSE = false>
__device__ __forceinline__ void cross_apply(const Cross<T>& m,
                                            const Pair<T>& p, const T* v,
                                            T* acc) {
  const T vx = v[0], vy = v[1], vz = v[2];
  const T c = TRANSPOSE ? -m.c : m.c;
  T ox = c * (p.dz * vy - p.dy * vz) + acc[0];
  T oy = c * (p.dx * vz - p.dz * vx) + acc[1];
  T oz = c * (p.dy * vx - p.dx * vy) + acc[2];
  if (WALL) {
    const T ux = IS_TR ? -p.dx : p.dx;
    const T uy = IS_TR ? -p.dy : p.dy;
    if (IS_TR != TRANSPOSE) {  // -Mw v: tr, or rt transposed
      const T w = ux * vy - uy * vx;
      ox = ox + m.K * vy - (m.F1 * uy) * vz - (m.G3 * ux) * w;
      oy = oy - m.K * vx + (m.F1 * ux) * vz - (m.G3 * uy) * w;
      oz = oz - m.H * w;
    } else {  // -Mw^T v: rt, or tr transposed
      const T pr = ux * vx + uy * vy;
      ox = ox + (m.G3 * uy) * pr - m.K * vy + (m.H * uy) * vz;
      oy = oy - (m.G3 * ux) * pr + m.K * vx - (m.H * ux) * vz;
      oz = oz + m.F1 * (ux * vy - uy * vx);
    }
  }
  acc[0] = ox;
  acc[1] = oy;
  acc[2] = oz;
}

// Couplings: input/output components per right-hand side, the largest B
// the paths launch (the template instances), and the per-pair update of
// the partial sums from one source's vector entries v (b-major, kComp a
// right-hand side); each also gives both shares of a pair, the target's
// from the source's entries and the source's from the target's
// (accumulate_both, for sym_kernel), from the blocks of (i, j) alone:
// M_tt and M_rr are symmetric (M(j,i) = M(i,j)^T), and the cross blocks
// trade places, M_tr(j,i) = M_rt(i,j)^T.
template <bool IS_RR>
struct DiagCoupling {
  static constexpr bool kDiag = true;   // image boxes: one BlockSum a pair
  static constexpr bool kFreeSurface = false;
  static constexpr int kComp = 3;
  static constexpr int kMaxRhs = 2;
  template <typename T, bool WALL>
  __device__ __forceinline__ static Diag<T> condense(const Pair<T>& p) {
    if constexpr (IS_RR)
      return rr_condense<T, WALL>(p);
    else
      return tt_condense<T, WALL>(p);
  }
  template <typename T, int B, bool WALL>
  __device__ static void accumulate(const Pair<T>& p, const T* v, T* part) {
    const Diag<T> m = condense<T, WALL>(p);
#pragma unroll
    for (int b = 0; b < B; ++b) diag_apply(m, p.dx, p.dy, v + 3 * b,
                                           part + 3 * b);
  }
  // M_ij v_j to the target, M_ij^T v_i to the source, from one Diag
  template <typename T, int B, bool WALL>
  __device__ static void accumulate_both(const Pair<T>& p, const T* vj,
                                         T* acc_i, const T* vi, T* acc_j) {
    const Diag<T> m = condense<T, WALL>(p);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      diag_apply(m, p.dx, p.dy, vj + 3 * b, acc_i + 3 * b);
      diag_apply_t(m, p.dx, p.dy, vi + 3 * b, acc_j + 3 * b);
    }
  }
};
using TT = DiagCoupling<false>;
using RR = DiagCoupling<true>;

// The free surface's tt coupling (csrc/pair_fs.cu): fs_condense on the
// wall's pair geometry (kFreeSurface: its instances are launched with
// WALL = true whatever the wall flag), applied as tt's; its open
// symmetric sweep is sym2_kernel's (two targets a lane, the tile far test,
// fs_condense2)
struct FreeSurface {
  static constexpr bool kDiag = true;
  static constexpr bool kFreeSurface = true;
  static constexpr int kComp = 3;
  static constexpr int kMaxRhs = 2;
  template <typename T, bool WALL>
  __device__ __forceinline__ static Diag<T> condense(const Pair<T>& p) {
    static_assert(WALL, "the free surface takes the wall's pair geometry");
    return fs_condense<T>(p);
  }
  template <typename T, int B, bool WALL>
  __device__ static void accumulate(const Pair<T>& p, const T* v, T* part) {
    const Diag<T> m = condense<T, WALL>(p);
#pragma unroll
    for (int b = 0; b < B; ++b) diag_apply(m, p.dx, p.dy, v + 3 * b,
                                           part + 3 * b);
  }
};

template <bool IS_TR, int MAX_RHS>
struct CrossCoupling {
  static constexpr bool kDiag = false;
  static constexpr bool kFreeSurface = false;
  static constexpr bool kUnrollBoxes = true;   // PlaneBoxes' boxes
  static constexpr int kComp = 3;
  static constexpr int kMaxRhs = MAX_RHS;
  template <typename T, int B, bool WALL>
  __device__ static void accumulate(const Pair<T>& p, const T* v, T* part) {
    const Cross<T> m = cross_condense<T, WALL, IS_TR>(p);
#pragma unroll
    for (int b = 0; b < B; ++b)
      cross_apply<T, WALL, IS_TR>(m, p, v + 3 * b, part + 3 * b);
  }
  // the coupling's block of (i, j) to the target; to the source the other
  // cross block of (i, j), transposed (tr: M_tr(j,i) T_i = M_rt(i,j)^T
  // T_i; rt: M_rt(j,i) F_i = M_tr(i,j)^T F_i), both from one CrossShared
  template <typename T, int B, bool WALL>
  __device__ static void accumulate_both(const Pair<T>& p, const T* vj,
                                         T* acc_i, const T* vi, T* acc_j) {
    const CrossShared<T> s = cross_shared<T, WALL>(p);
    const Cross<T> own = cross_block<T, WALL>(s, IS_TR ? p.zt : p.zs);
    const Cross<T> other = cross_block<T, WALL>(s, IS_TR ? p.zs : p.zt);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      cross_apply<T, WALL, IS_TR>(own, p, vj + 3 * b, acc_i + 3 * b);
      cross_apply<T, WALL, !IS_TR, true>(other, p, vi + 3 * b,
                                         acc_j + 3 * b);
    }
  }
};
using TR = CrossCoupling<true, 2>;
using RT = CrossCoupling<false, 1>;

struct Grand {
  static constexpr bool kDiag = false;
  static constexpr bool kFreeSurface = false;
  // PlaneBoxes' far boxes in a loop: unrolled, grand's four blocks both
  // ways spill and run 10 % slower at 4096 spheres (no faster at 32,768)
  static constexpr bool kUnrollBoxes = false;
  static constexpr int kComp = 6;
  static constexpr int kMaxRhs = 1;
  template <typename T, int B, bool WALL>
  __device__ static void accumulate(const Pair<T>& p, const T* v, T* part) {
    const Diag<T> mtt = tt_condense<T, WALL>(p);
    const CrossShared<T> s = cross_shared<T, WALL>(p);
    const Cross<T> mtr = cross_block<T, WALL>(s, p.zt);
    const Cross<T> mrt = cross_block<T, WALL>(s, p.zs);
    const Diag<T> mrr = rr_condense<T, WALL>(p);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const T* f = v + 6 * b;      // F
      const T* t = f + 3;          // T / a
      T* out_u = part + 6 * b;     // U = M_tt F + M_tr T
      T* out_w = out_u + 3;        // W a = M_rt F + M_rr T
      diag_apply(mtt, p.dx, p.dy, f, out_u);
      cross_apply<T, WALL, true>(mtr, p, t, out_u);
      cross_apply<T, WALL, false>(mrt, p, f, out_w);
      diag_apply(mrr, p.dx, p.dy, t, out_w);
    }
  }
  // both shares of a pair; the source's is M_ij^T (F_i, T_i / a):
  // U_j += tt^T F_i + rt^T T_i / a, W_j a += tr^T F_i + rr^T T_i / a
  template <typename T, int B, bool WALL>
  __device__ static void accumulate_both(const Pair<T>& p, const T* vj,
                                         T* acc_i, const T* vi, T* acc_j) {
    const Diag<T> mtt = tt_condense<T, WALL>(p);
    const CrossShared<T> s = cross_shared<T, WALL>(p);
    const Cross<T> mtr = cross_block<T, WALL>(s, p.zt);
    const Cross<T> mrt = cross_block<T, WALL>(s, p.zs);
    const Diag<T> mrr = rr_condense<T, WALL>(p);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const T* f = vj + 6 * b;
      const T* t = f + 3;
      diag_apply(mtt, p.dx, p.dy, f, acc_i + 6 * b);
      cross_apply<T, WALL, true>(mtr, p, t, acc_i + 6 * b);
      cross_apply<T, WALL, false>(mrt, p, f, acc_i + 6 * b + 3);
      diag_apply(mrr, p.dx, p.dy, t, acc_i + 6 * b + 3);
      const T* fi = vi + 6 * b;
      const T* ti = fi + 3;
      diag_apply_t(mtt, p.dx, p.dy, fi, acc_j + 6 * b);
      cross_apply<T, WALL, false, true>(mrt, p, ti, acc_j + 6 * b);
      cross_apply<T, WALL, true, true>(mtr, p, fi, acc_j + 6 * b + 3);
      diag_apply_t(mrr, p.dx, p.dy, ti, acc_j + 6 * b + 3);
    }
  }
};

// resident blocks an SM that __launch_bounds__ asks for: 8 in float32 (64
// registers a thread at most), 6 (80 registers) for the image boxes, none
// in float64 (off the hot paths). At 8 the in-plane tt instances spill at
// B = 2 and run 2.5 % (B = 1) and 8.5 % (B = 2) slower at 49,152 blobs
// (tools/torch_profile_kernels.py, PERF.md §6); the free surface's image
// instances run as fast at 4, 5 and 8 as at 6
template <typename T, typename G = OpenBox<T>>
struct Shape {
  static constexpr int kMinBlocks = sizeof(T) != 4 ? 1 : (G::kImages ? 6 : 8);
};

// a staged source row: x, y, z and the NV vector entries, padded to whole
// 16-byte vectors (four floats, two doubles)
template <typename T, int NV>
struct RowLen {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  static constexpr int value = ((3 + NV + kPer - 1) / kPer) * kPer;
};

template <int L>
__device__ __forceinline__ void load_row(const float* row, float* dst) {
#pragma unroll
  for (int c = 0; c < L; c += 4) {
    const float4 q = *reinterpret_cast<const float4*>(row + c);
    dst[c] = q.x;
    dst[c + 1] = q.y;
    dst[c + 2] = q.z;
    dst[c + 3] = q.w;
  }
}

template <int L>
__device__ __forceinline__ void load_row(const double* row, double* dst) {
#pragma unroll
  for (int c = 0; c < L; c += 2) {
    const double2 q = *reinterpret_cast<const double2*>(row + c);
    dst[c] = q.x;
    dst[c + 1] = q.y;
  }
}

// A pair's boxes as one block: the diagonal couplings' BlockSum over every
// box of the policy (the home box's self flag from `self`); the free
// surface's under PlaneBoxes by its coefficients (FsMoments), the home box
// with its near and zero forms, the others in the far form
template <typename T, typename C, bool WALL, typename G, typename U>
__device__ __forceinline__ BlockSum<T> sum_blocks(const G& geom, U xt, U yt,
                                                  U zt, U xs, U ys, U zs,
                                                  bool self) {
  if constexpr (C::kFreeSurface && std::is_same_v<G, PlaneBoxes<T>>) {
    static_assert(WALL, "the free surface takes the wall's pair geometry");
    FsMoments<T> s{};
    geom.template visit<WALL>(xt, yt, zt, xs, ys, zs, self,
                              [&](const Pair<T>& p) {
                                T c1, c2, e1, e2;
                                rpy_far(p.invr, c1, c2);
                                tt_near(p, c1, c2);
                                rpy_far(p.invR, e1, e2);
                                fs_image_near(p, e1, e2);
                                s.add(c1, c2, e1, e2, p.dx, p.dy);
                              });
    // PlaneBoxes' own dz and Rz (visit, box_pair)
    const T zt_ = T(zt), zs_ = T(zs);
    return s.close(zt_ - zs_, zt_ + zs_);
  } else {
    BlockSum<T> m{};
    geom.template visit<WALL>(xt, yt, zt, xs, ys, zs, self,
                              [&](const Pair<T>& p) {
                                m.add(C::template condense<T, WALL>(p), p.dx,
                                      p.dy);
                              });
    m.close();
    return m;
  }
}

// The pairs of a target and a source in every box of the policy added into
// the target's sums acc (M v_s, vs the source's B vectors): the open
// domain's one pair straight in; with image boxes a pair's boxes summed
// apart first, into one BlockSum (tt, rr) or a sum of the pair's own.
template <typename T, typename C, int B, bool WALL, typename G>
__device__ __forceinline__ void add_pair(const G& geom, T xt, T yt, T zt,
                                         T xs, T ys, T zs, bool self,
                                         const T* vs, T* acc) {
  if constexpr (!G::kImages) {
    geom.template visit<WALL>(xt, yt, zt, xs, ys, zs, self,
                              [&](const Pair<T>& p) {
                                C::template accumulate<T, B, WALL>(p, vs,
                                                                   acc);
                              });
  } else if constexpr (C::kDiag) {
    const BlockSum<T> m =
        sum_blocks<T, C, WALL>(geom, xt, yt, zt, xs, ys, zs, self);
#pragma unroll
    for (int b = 0; b < B; ++b) m.apply(vs + 3 * b, acc + 3 * b);
  } else {
    constexpr int NV = C::kComp * B;
    T sum[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) sum[c] = T(0);
    geom.template visit<WALL, C::kUnrollBoxes>(
        xt, yt, zt, xs, ys, zs, self, [&](const Pair<T>& p) {
          C::template accumulate<T, B, WALL>(p, vs, sum);
        });
#pragma unroll
    for (int c = 0; c < NV; ++c) acc[c] += sum[c];
  }
}

// Both shares of a pair i != j of the symmetric sweep: M_ij v_j into acc_i
// and the source's share into acc_j (accumulate_both), the boxes summed
// apart as in add_pair; a diagonal coupling's box sum M is applied as M
// to v_j and as M^T to v_i.
template <typename T, typename C, int B, bool WALL, typename G>
__device__ __forceinline__ void add_pair_both(const G& geom, T xi, T yi,
                                              T zi, T xj, T yj, T zj,
                                              const T* vj, T* acc_i,
                                              const T* vi, T* acc_j) {
  if constexpr (!G::kImages) {
    geom.template visit<WALL>(xi, yi, zi, xj, yj, zj, false,
                              [&](const Pair<T>& p) {
                                C::template accumulate_both<T, B, WALL>(
                                    p, vj, acc_i, vi, acc_j);
                              });
  } else if constexpr (C::kDiag) {
    const BlockSum<T> m =
        sum_blocks<T, C, WALL>(geom, xi, yi, zi, xj, yj, zj, false);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      m.apply(vj + 3 * b, acc_i + 3 * b);
      m.apply_t(vi + 3 * b, acc_j + 3 * b);
    }
  } else {
    constexpr int NV = C::kComp * B;
    T sum_i[NV], sum_j[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) sum_i[c] = sum_j[c] = T(0);
    geom.template visit<WALL, C::kUnrollBoxes>(
        xi, yi, zi, xj, yj, zj, false, [&](const Pair<T>& p) {
          C::template accumulate_both<T, B, WALL>(p, vj, sum_i, vi, sum_j);
        });
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      acc_i[c] += sum_i[c];
      acc_j[c] += sum_j[c];
    }
  }
}

// One block: 128 target rows against the sources of slice blockIdx.y,
// sources [blockIdx.y * tiles_per_slice * 128, +tiles_per_slice * 128)
// clipped to n_src. Writes out[blockIdx.y][i][:] (the workspace when
// S > 1). Target i is source row0 + i for the self pair.
template <typename T, typename C, int B, bool WALL, typename G>
__global__ void __launch_bounds__(kTile, (Shape<T, G>::kMinBlocks))
pair_kernel(const T* __restrict__ q_src, const T* __restrict__ q_tgt,
            const T* __restrict__ vec, T* __restrict__ out, int n_src,
            int n_tgt, int tiles_per_slice, int self_interaction, int row0,
            G geom) {
  constexpr int NV = C::kComp * B;
  constexpr int L = RowLen<T, NV>::value;
  __shared__ __align__(16) T s_src[kTile][L];

  const int i = blockIdx.x * kTile + threadIdx.x;
  const int j_begin = blockIdx.y * tiles_per_slice * kTile;
  const int j_end = min(n_src, j_begin + tiles_per_slice * kTile);
  T xt = T(0), yt = T(0), zt = T(1);
  if (i < n_tgt) {
    xt = q_tgt[3 * i + 0];
    yt = q_tgt[3 * i + 1];
    zt = q_tgt[3 * i + 2];
  }
  T acc[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) acc[c] = T(0);

  for (int base = j_begin; base < j_end; base += kTile) {
    const int j = base + threadIdx.x;
    if (j < j_end) {
      T* row = s_src[threadIdx.x];
      row[0] = q_src[3 * j + 0];
      row[1] = q_src[3 * j + 1];
      row[2] = q_src[3 * j + 2];
#pragma unroll
      for (int c = 0; c < NV; ++c) row[3 + c] = vec[(size_t)j * NV + c];
    }
    __syncthreads();
    const int count = min(kTile, j_end - base);
    // the tile index of the target's self pair, source row0 + i (never
    // matched when that source is not in this tile); row0 > 0 when the
    // targets are rows [row0, row0 + n_tgt) of the sources (a rank's share)
    const int self_k = self_interaction ? i + row0 - base : -1;
    // per-tile partial sums, added once per tile
    T part[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) part[c] = T(0);
    for (int k = 0; k < count; ++k) {
      T src[L];
      load_row<L>(s_src[k], src);
      add_pair<T, C, B, WALL>(geom, xt, yt, zt, src[0], src[1], src[2],
                              k == self_k, src + 3, part);
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) acc[c] += part[c];
    __syncthreads();
  }
  if (i < n_tgt) {
    T* o = out + (size_t)blockIdx.y * n_tgt * NV + (size_t)i * NV;
#pragma unroll
    for (int c = 0; c < NV; ++c) o[c] = acc[c];
  }
}

// out[i] = sum over s of ws[s][i], in slice order (bit-identical on
// repeat), by runs of 16 slices so the rounding of hundreds of slices
// grows like their square root
template <typename T>
__global__ void __launch_bounds__(256)
slice_sum_kernel(const T* __restrict__ ws, T* __restrict__ out,
                 int n_slices, long long n) {
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  if (idx >= n) return;
  T s = T(0);
  for (int k0 = 0; k0 < n_slices; k0 += 16) {
    T run = ws[k0 * n + idx];
    for (int k = k0 + 1; k < min(k0 + 16, n_slices); ++k)
      run += ws[k * n + idx];
    s += run;
  }
  out[idx] = s;
}

// The symmetric sweep of a square product (targets = sources), for every
// coupling (accumulate_both): each unordered pair is condensed once and
// applied both ways, halving the condensing that bounds the sliced
// sweep.
// - The 128-blob tiles fall into G groups of tiles_per_group tiles; a
//   block takes one pair of groups (GA, GB), GA <= GB, of the upper
//   triangle and sweeps its tile pairs (a, b), a in GA and b in GB (b >= a
//   when GA = GB). Off the diagonal each warp holds 32 targets of tile a
//   and, for each 32-source quarter of b, one source a lane: 32 steps
//   rotate the sources (and their running sums M_ij^T v_i) one lane down
//   with shuffles, so every (target, source) pair of the warp meets once
//   and each source's sum comes back to its lane; the four warps' source
//   sums are added in shared memory in warp order. A diagonal tile pair
//   (a, a) runs the directed sweep over its own tile, self pairs included
//   when self_interaction is set.
// - The workspace (G, N, nc B) holds one slice a group: the block owns
//   slice GB of the rows of group GA (target-side sums) and slice GA of
//   the rows of group GB (source-side sums). It zeroes them and adds each
//   tile pair's sums in sweep order, every row by the thread of its
//   position in the tile. Each (slice, row) entry belongs to one block, no
//   atomics, and the slice sum adds the G slices of every row in order, so
//   the product is bit-identical on repeat. G comes from the wrapper's
//   plan (ops/pair_kernels.py plan_groups), which fills the card whatever
//   N is: the workspace grows with N, not with N^2.
constexpr int kLanes = 32;
constexpr int kWarps = kTile / kLanes;

// (A, B) of upper-triangle pair p in row-major order over n groups
__device__ __forceinline__ void group_pair(long long p, int n, int& a,
                                           int& b) {
  auto start = [n](long long row) { return row * n - row * (row - 1) / 2; };
  const double t = 2.0 * n + 1.0;
  int r = static_cast<int>((t - sqrt(t * t - 8.0 * p)) * 0.5);
  while (r > 0 && start(r) > p) --r;
  while (r + 1 < n && start(r + 1) <= p) ++r;
  a = r;
  b = r + static_cast<int>(p - start(r));
}

// adds the block's four warps' source-side sums s_sum[w][t] to row
// `row` of slice `dst` (the calling thread's own row)
template <typename T, int NV>
__device__ __forceinline__ void add_source_sums(T (*s_sum)[kTile][NV], T* dst,
                                                int row, int n) {
  if (row >= n) return;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    T sum = s_sum[0][threadIdx.x][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += s_sum[w][threadIdx.x][c];
    dst[(size_t)row * NV + c] += sum;
  }
}

// The tile far test of the free surface's sweeps (sym2_kernel here, and
// csrc/pair_radii.cu's): the bounding box of a tile's rows and their
// largest radius (1 in K1's units of a), and tests on two tiles' boxes.
template <typename T>
struct Box {
  T hi[3], lo[3], amax;
};

// the box of a tile from each thread's maxima v = (x, y, z, -x, -y, -z, a)
// over its rows, on every thread of the block's NW warps; s_box is free on
// entry and on return
template <typename T, int NW>
__device__ __forceinline__ Box<T> tile_box_v(T (&v)[7], T (*s_box)[7]) {
#pragma unroll
  for (int c = 0; c < 7; ++c) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      v[c] = max(v[c], __shfl_xor_sync(0xffffffffu, v[c], off));
  }
  if (threadIdx.x % kLanes == 0) {
#pragma unroll
    for (int c = 0; c < 7; ++c) s_box[threadIdx.x / kLanes][c] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    v[c] = s_box[0][c];
#pragma unroll
    for (int w = 1; w < NW; ++w) v[c] = max(v[c], s_box[w][c]);
  }
  __syncthreads();
  Box<T> b;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b.hi[k] = v[k];
    b.lo[k] = -v[3 + k];
  }
  b.amax = v[6];
  return b;
}

// the box of a 128-row tile one row a thread of kWarps warps, p = (x, y,
// z, a) the calling thread's row (rows past n as staged)
template <typename T>
__device__ __forceinline__ Box<T> tile_box(const T* p, T (*s_box)[7]) {
  T v[7] = {p[0], p[1], p[2], -p[0], -p[1], -p[2], p[3]};
  return tile_box_v<T, kWarps>(v, s_box);
}

// every pair of the two tiles far: the boxes further apart than the sum of
// their largest radii, with a margin for the rounding of each pair's own
// r^2 and (a + b)^2
template <typename T>
__device__ __forceinline__ bool boxes_far(const Box<T>& a, const Box<T>& b) {
  // (the free surface's instances also ask above_plane or images_far)
  T d2 = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T g = max(max(a.lo[k] - b.hi[k], b.lo[k] - a.hi[k]), T(0));
    d2 += g * g;
  }
  const T s = a.amax + b.amax;
  return d2 > s * s * T(1.0001);
}

// both tiles at z >= 0: then every pair's image lies at |R| >= r
template <typename T>
__device__ __forceinline__ bool above_plane(const Box<T>& a,
                                            const Box<T>& b) {
  return a.lo[2] >= T(0) && b.lo[2] >= T(0);
}

// every pair's image of the two tiles far (the free surface; in every image
// box, z being never imaged): z_t + z_s > a_t + a_s from the tiles' lowest
// heights and largest radii alone (|R| >= z_t + z_s), with boxes_far's
// margin for the rounding of each pair's |R|^2 and (a + b)^2
template <typename T>
__device__ __forceinline__ bool images_far(const Box<T>& a,
                                           const Box<T>& b) {
  const T z = a.lo[2] + b.lo[2];
  const T s = a.amax + b.amax;
  return z > T(0) && z * z > s * s * T(1.0001);
}

// Two targets a lane (sym2_kernel, radii_sym2_kernel): a block of
// kThreads2 threads, two warps, over a 128-row tile; the tile row a thread
// holds as its target h (0 or 1), and stages, sums and writes: lane l of
// warp w holds rows 64 w + l and 64 w + 32 + l
constexpr int kThreads2 = 2 * kLanes;
constexpr int kWarps2 = kThreads2 / kLanes;
__device__ __forceinline__ int row2(int h) {
  return (threadIdx.x / kLanes) * 2 * kLanes + h * kLanes +
         threadIdx.x % kLanes;
}

// the box of a 128-row tile held two rows a thread (row2), p0 and p1 = (x,
// y, z, a)
template <typename T>
__device__ __forceinline__ Box<T> tile_box2(const T* p0, const T* p1,
                                            T (*s_box)[7]) {
  T v[7];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = max(p0[k], p1[k]);
    v[3 + k] = max(-p0[k], -p1[k]);
  }
  v[6] = max(p0[3], p1[3]);
  return tile_box_v<T, kWarps2>(v, s_box);
}

template <typename T, typename C, int B, bool WALL, typename G>
__global__ void __launch_bounds__(kTile, (Shape<T, G>::kMinBlocks))
sym_kernel(const T* __restrict__ q, const T* __restrict__ vec,
           T* __restrict__ ws, int n, int n_groups, int tiles_per_group,
           int self_interaction, long long pair0, G geom) {
  constexpr int NV = C::kComp * B;
  constexpr int L = RowLen<T, NV>::value;
  __shared__ __align__(16) T s_src[kTile][L];
  __shared__ T s_sum[kWarps][kTile][NV];

  int ga, gb;
  group_pair(pair0 + blockIdx.x, n_groups, ga, gb);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int a_begin = ga * tiles_per_group;
  const int a_end = min(n_tiles, a_begin + tiles_per_group);
  const int b_begin = gb * tiles_per_group;
  const int b_end = min(n_tiles, b_begin + tiles_per_group);
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
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
    T xi = T(0), yi = T(0), zi = T(1), vi[NV], acc[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      vi[c] = T(0);
      acc[c] = T(0);
    }
    if (i < n) {
      xi = q[3 * i + 0];
      yi = q[3 * i + 1];
      zi = q[3 * i + 2];
#pragma unroll
      for (int c = 0; c < NV; ++c) vi[c] = vec[(size_t)i * NV + c];
    }
#pragma unroll 1
    for (int tb = ga == gb ? ta : b_begin; tb < b_end; ++tb) {
      if (tb == ta) {  // the diagonal tile: every ordered pair
        __syncthreads();  // s_src may still be read for the previous tile
        T* row = s_src[threadIdx.x];
        row[0] = xi;
        row[1] = yi;
        row[2] = zi;
#pragma unroll
        for (int c = 0; c < NV; ++c) row[3 + c] = vi[c];
        __syncthreads();
        const int count = min(kTile, n - ta * kTile);
        const int self_k = self_interaction ? static_cast<int>(threadIdx.x)
                                            : -1;
        for (int k = 0; k < count; ++k) {
          T src[L];
          load_row<L>(s_src[k], src);
          add_pair<T, C, B, WALL>(geom, xi, yi, zi, src[0], src[1], src[2],
                                  k == self_k, src + 3, acc);
        }
        continue;
      }
      // off the diagonal: each quarter of tile b rotates through the warp
#pragma unroll 1
      for (int quarter = 0; quarter < kWarps; ++quarter) {
        const int j = tb * kTile + quarter * kLanes + lane;
        T xj = T(0), yj = T(0), zj = T(1), vj[NV], accj[NV];
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          vj[c] = T(0);
          accj[c] = T(0);
        }
        if (j < n) {
          xj = q[3 * j + 0];
          yj = q[3 * j + 1];
          zj = q[3 * j + 2];
#pragma unroll
          for (int c = 0; c < NV; ++c) vj[c] = vec[(size_t)j * NV + c];
        }
        const int next = (lane + 1) % kLanes;
        // an image pair's boxes (PlaneBoxes: 9 unrolled condenses) take
        // one step a turn
        constexpr int kStepUnroll = G::kImages ? 1 : 2;
#pragma unroll (kStepUnroll)
        for (int step = 0; step < kLanes; ++step) {
          add_pair_both<T, C, B, WALL>(geom, xi, yi, zi, xj, yj, zj, vj, acc,
                                       vi, accj);
          xj = __shfl_sync(0xffffffffu, xj, next);
          yj = __shfl_sync(0xffffffffu, yj, next);
          zj = __shfl_sync(0xffffffffu, zj, next);
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
      __syncthreads();
      add_source_sums<T, NV>(s_sum, ws_b, tb * kTile + threadIdx.x, n);
      __syncthreads();  // s_sum is refilled by the next tile pair
    }
    if (i < n) {
#pragma unroll
      for (int c = 0; c < NV; ++c) ws_a[(size_t)i * NV + c] += acc[c];
    }
  }
}

// The open free surface's symmetric sweep (C::kFreeSurface without image
// boxes), two targets a lane: the group pairs, 128-row tiles and workspace
// slices of sym_kernel, each row by the thread that holds it (row2). Off the
// diagonal each warp holds 64 targets of tile a, and each 32-source chunk of
// tile b rotates through it: a step condenses a source against both of a
// lane's targets, so one shuffle of its position, vector and running sum
// serves two pairs. Each pair's block is fs_condense2's (fs_condense's
// coefficients in fewer instructions). A tile pair whose boxes pass the far
// test (every pair at r > 2 and every image at |R| > 2, radius 1: boxes_far
// and images_far) takes the far form alone (box_pair with every flag the
// constant false: tt_near and fs_image_near fold away); other tile pairs,
// and the diagonal tile's directed pass with its self pairs, take the full
// form. A far pair gets the same bits either way, and each sum is added in a
// fixed order, so the product is bit-identical on repeat.

// resident blocks of 64 threads an SM that sym2_kernel asks for in float32
// (over ops/pair_kernels.py plan_groups' groups, as sym_kernel): B = 1 12, 80
// registers (10 and 16 no faster); B = 2 10, 96 registers, ~5 % faster than
// at 12 (80) or 16 (64, spilling) at 21a's 49,152 blobs; a step loop not
// unrolled no faster (PERF.md §6)
template <typename T, int B>
struct Shape2 {
  static constexpr int kMinBlocks = sizeof(T) != 4 ? 1 : (B == 1 ? 12 : 10);
};
constexpr int kStepUnroll2 = 2;

// the chunks of source tile tb rotated through the warp against its 2 x 32
// targets (xi, yi, zi, vi); the chunks' source sums left in s_sum[warp]
template <typename T, int B, bool FAR>
__device__ __forceinline__ void rotate2(const T* __restrict__ q,
                                        const T* __restrict__ vec, int n,
                                        int tb, const T (&xi)[2],
                                        const T (&yi)[2], const T (&zi)[2],
                                        T (&vi)[2][3 * B],
                                        T (&acc)[2][3 * B],
                                        T (*s_sum)[kTile][3 * B]) {
  constexpr int NV = 3 * B;
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int next = (lane + 1) % kLanes;
#pragma unroll 1
  for (int chunk = 0; chunk < kTile / kLanes; ++chunk) {
    const int j = tb * kTile + chunk * kLanes + lane;
    T xj = T(0), yj = T(0), zj = T(1), vj[NV], accj[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      vj[c] = T(0);
      accj[c] = T(0);
    }
    if (j < n) {
      xj = q[3 * j + 0];
      yj = q[3 * j + 1];
      zj = q[3 * j + 2];
#pragma unroll
      for (int c = 0; c < NV; ++c) vj[c] = vec[(size_t)j * NV + c];
    }
#pragma unroll (kStepUnroll2)
    for (int step = 0; step < kLanes; ++step) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T dx = xi[h] - xj, dy = yi[h] - yj;
        const Diag<T> m = fs_condense2(box_pair<T, true>(
            dx, dy, dx * dx + dy * dy, zi[h] - zj, zi[h], zj, false, FAR));
#pragma unroll
        for (int b = 0; b < B; ++b) {
          diag_apply(m, dx, dy, vj + 3 * b, acc[h] + 3 * b);
          diag_apply_t(m, dx, dy, vi[h] + 3 * b, accj + 3 * b);
        }
      }
      xj = __shfl_sync(0xffffffffu, xj, next);
      yj = __shfl_sync(0xffffffffu, yj, next);
      zj = __shfl_sync(0xffffffffu, zj, next);
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

template <typename T, int B>
__global__ void __launch_bounds__(kThreads2, (Shape2<T, B>::kMinBlocks))
sym2_kernel(const T* __restrict__ q, const T* __restrict__ vec,
            T* __restrict__ ws, int n, int n_groups, int tiles_per_group,
            int self_interaction, long long pair0) {
  constexpr int NV = 3 * B;
  constexpr int L = RowLen<T, NV>::value;
  __shared__ __align__(16) T s_src[kTile][L];
  __shared__ T s_sum[kWarps2][kTile][NV];
  __shared__ T s_box[kWarps2][7];

  int ga, gb;
  group_pair(pair0 + blockIdx.x, n_groups, ga, gb);
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
    // rows past n: a blob at (0, 0, 1) with a zero vector
    T pi[2][4], vi[2][NV], acc[2][NV];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ta * kTile + row2(h);
      pi[h][0] = T(0);
      pi[h][1] = T(0);
      pi[h][2] = T(1);
      pi[h][3] = T(1);  // the radius, in units of a
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        vi[h][c] = T(0);
        acc[h][c] = T(0);
      }
      if (i < n) {
#pragma unroll
        for (int c = 0; c < 3; ++c) pi[h][c] = q[3 * i + c];
#pragma unroll
        for (int c = 0; c < NV; ++c) vi[h][c] = vec[(size_t)i * NV + c];
      }
    }
    const T xi[2] = {pi[0][0], pi[1][0]};
    const T yi[2] = {pi[0][1], pi[1][1]};
    const T zi[2] = {pi[0][2], pi[1][2]};
    const Box<T> box_a = tile_box2(pi[0], pi[1], s_box);
#pragma unroll 1
    for (int tb = ga == gb ? ta : b_begin; tb < b_end; ++tb) {
      if (tb == ta) {  // the diagonal tile: every ordered pair
        __syncthreads();  // s_src may still be read for the previous tile
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          T* row = s_src[row2(h)];
          row[0] = xi[h];
          row[1] = yi[h];
          row[2] = zi[h];
#pragma unroll
          for (int c = 0; c < NV; ++c) row[3 + c] = vi[h][c];
        }
        __syncthreads();
        const int count = min(kTile, n - ta * kTile);
        for (int k = 0; k < count; ++k) {
          T src[L];
          load_row<L>(s_src[k], src);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const Pair<T> p = make_pair<T, true>(
                xi[h], yi[h], zi[h], src[0], src[1], src[2],
                self_interaction && k == row2(h));
            const Diag<T> m = fs_condense2(p);
#pragma unroll
            for (int b = 0; b < B; ++b)
              diag_apply(m, p.dx, p.dy, src + 3 + 3 * b, acc[h] + 3 * b);
          }
        }
        continue;
      }
      // off the diagonal: the tile pair's far test, then its rotations
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
          for (int c = 0; c < 3; ++c) pj[h][c] = q[3 * j + c];
        }
      }
      const Box<T> box_b = tile_box2(pj[0], pj[1], s_box);
      if (boxes_far(box_a, box_b) && images_far(box_a, box_b))
        rotate2<T, B, true>(q, vec, n, tb, xi, yi, zi, vi, acc, s_sum);
      else
        rotate2<T, B, false>(q, vec, n, tb, xi, yi, zi, vi, acc, s_sum);
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

template <typename T, typename C, int B, bool WALL, typename G>
int launch_bw(const T* q_src, const T* q_tgt, const T* vec, T* out, T* ws,
              int n_src, int n_tgt, int n_slices, int tiles_per_slice,
              int self_interaction, int row0, const G& geom,
              cudaStream_t s) {
  const dim3 grid((n_tgt + kTile - 1) / kTile, n_slices);
  pair_kernel<T, C, B, WALL, G><<<grid, kTile, 0, s>>>(
      q_src, q_tgt, vec, n_slices > 1 ? ws : out, n_src, n_tgt,
      tiles_per_slice, self_interaction, row0, geom);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_slices == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(n_tgt) * C::kComp * B;
  slice_sum_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      ws, out, n_slices, n);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<bool, WALL>) for the domain code `mode` of
// the entry points (0 open, 1 wall, 2 free surface): the couplings serve
// 0 and 1, the free surface 2 alone, on the wall's pair geometry (its
// WALL = false instances are never compiled); any other code is refused
template <typename C, typename F>
int with_wall(int mode, F&& f) {
  if constexpr (C::kFreeSurface)
    return mode == 2 ? f(std::true_type{})
                     : static_cast<int>(cudaErrorInvalidValue);
  else
    return mode == 1   ? f(std::true_type{})
           : mode == 0 ? f(std::false_type{})
                       : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename C, int B, typename G>
int launch_b(const T* q_src, const T* q_tgt, const T* vec, T* out, T* ws,
             int n_src, int n_tgt, int n_slices, int tiles_per_slice,
             int wall, int self_interaction, int row0, const G& geom,
             cudaStream_t s) {
  return with_wall<C>(wall, [&](auto w) {
    return launch_bw<T, C, B, decltype(w)::value>(
        q_src, q_tgt, vec, out, ws, n_src, n_tgt, n_slices, tiles_per_slice,
        self_interaction, row0, geom, s);
  });
}

// q_src (n_src,3), q_tgt (n_tgt,3), vec (n_src, kComp*n_rhs) b-major
// columns, out (n_tgt, kComp*n_rhs), ws (n_slices, n_tgt, kComp*n_rhs)
// when n_slices > 1 (else unused); all contiguous on the device;
// 1 <= n_rhs <= kMaxRhs, n_src, n_tgt > 0, slices of tiles_per_slice
// 128-source tiles covering n_src; target i is source row0 + i for the
// self pair (0 <= row0). Returns the CUDA error code of the launches (0
// on success).
template <typename T, typename C, typename G>
int launch(const T* q_src, const T* q_tgt, const T* vec, T* out, T* ws,
           int n_src, int n_tgt, int n_rhs, int n_slices,
           int tiles_per_slice, int wall, int self_interaction, int row0,
           const G& geom, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_slices < 1 || n_slices > 65535 || tiles_per_slice < 1 || row0 < 0 ||
      static_cast<long long>(n_slices) * tiles_per_slice * kTile < n_src ||
      (n_slices > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rhs == 1)
    return launch_b<T, C, 1>(q_src, q_tgt, vec, out, ws, n_src, n_tgt,
                             n_slices, tiles_per_slice, wall,
                             self_interaction, row0, geom, s);
  if constexpr (C::kMaxRhs >= 2) {
    if (n_rhs == 2)
      return launch_b<T, C, 2>(q_src, q_tgt, vec, out, ws, n_src, n_tgt,
                               n_slices, tiles_per_slice, wall,
                               self_interaction, row0, geom, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename K>
int resident(K kernel, int* blocks_per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kTile, 0));
}

template <typename T, typename C, typename G>
int shape_g(int n_rhs, int wall, int* blocks_per_sm) {
  return with_wall<C>(wall, [&](auto w) {
    constexpr bool W = decltype(w)::value;
    if (n_rhs == 1) return resident(pair_kernel<T, C, 1, W, G>, blocks_per_sm);
    if constexpr (C::kMaxRhs >= 2) {
      if (n_rhs == 2)
        return resident(pair_kernel<T, C, 2, W, G>, blocks_per_sm);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// the launch shape the wrapper plans with: resident blocks an SM holds of
// the instance, images 0 (open), 1 (ImageBoxes) or 2 (PlaneBoxes)
template <typename T, typename C>
int shape(int n_rhs, int wall, int images, int* blocks_per_sm) {
  if (images == 2)
    return shape_g<T, C, PlaneBoxes<T>>(n_rhs, wall, blocks_per_sm);
  return images ? shape_g<T, C, ImageBoxes<T>>(n_rhs, wall, blocks_per_sm)
                : shape_g<T, C, OpenBox<T>>(n_rhs, wall, blocks_per_sm);
}

template <typename T, typename C, int B, bool WALL, typename G>
int launch_sym_bw(const T* q, const T* vec, T* out, T* ws, int n,
                  int n_groups, int tiles_per_group, int self_interaction,
                  long long pair0, long long n_pairs, const G& geom,
                  cudaStream_t s) {
  // a rank's share launches no block when its range is empty: its
  // (zeroed) workspace still sums into a zero partial
  if (n_pairs > 0) {
    if constexpr (C::kFreeSurface && !G::kImages)
      sym2_kernel<T, B>
          <<<static_cast<unsigned>(n_pairs), kThreads2, 0, s>>>(
              q, vec, ws, n, n_groups, tiles_per_group, self_interaction,
              pair0);
    else
      sym_kernel<T, C, B, WALL, G>
          <<<static_cast<unsigned>(n_pairs), kTile, 0, s>>>(
              q, vec, ws, n, n_groups, tiles_per_group, self_interaction,
              pair0, geom);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long len = static_cast<long long>(n) * C::kComp * B;
  slice_sum_kernel<T><<<static_cast<unsigned>((len + 255) / 256), 256, 0, s>>>(
      ws, out, n_groups, len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C, int B, typename G>
int launch_sym_b(const T* q, const T* vec, T* out, T* ws, int n,
                 int n_groups, int tiles_per_group, int wall,
                 int self_interaction, long long pair0, long long n_pairs,
                 const G& geom, cudaStream_t s) {
  return with_wall<C>(wall, [&](auto w) {
    return launch_sym_bw<T, C, B, decltype(w)::value>(
        q, vec, out, ws, n, n_groups, tiles_per_group, self_interaction,
        pair0, n_pairs, geom, s);
  });
}

// q (n,3), vec (n, kComp*n_rhs) b-major columns, out (n, kComp*n_rhs), ws
// (n_groups, n, kComp*n_rhs); all contiguous on the device; n > 0,
// 1 <= n_rhs <= kMaxRhs, groups of tiles_per_group 128-blob tiles
// covering n. The sweep takes the group pairs [pair0, pair0 + n_pairs) of
// the G (G + 1) / 2 (a rank's share; all of them for the whole product):
// out is then that share's partial product, provided the caller zeroed
// ws (the slices of the pairs left out are never written). Returns the
// CUDA error code of the launches.
template <typename T, typename C, typename G>
int launch_sym(const T* q, const T* vec, T* out, T* ws, int n, int n_rhs,
               int n_groups, int tiles_per_group, int wall,
               int self_interaction, int pair0, int n_pairs, const G& geom,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total =
      static_cast<long long>(n_groups) * (n_groups + 1) / 2;
  if (n < 1 || ws == nullptr || n_groups < 1 || n_groups > 65535 ||
      tiles_per_group < 1 ||
      static_cast<long long>(n_groups) * tiles_per_group * kTile < n ||
      pair0 < 0 || n_pairs < 0 ||
      static_cast<long long>(pair0) + n_pairs > total)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rhs == 1)
    return launch_sym_b<T, C, 1>(q, vec, out, ws, n, n_groups,
                                 tiles_per_group, wall, self_interaction,
                                 pair0, n_pairs, geom, s);
  if constexpr (C::kMaxRhs >= 2) {
    if (n_rhs == 2)
      return launch_sym_b<T, C, 2>(q, vec, out, ws, n, n_groups,
                                   tiles_per_group, wall, self_interaction,
                                   pair0, n_pairs, geom, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the image boxes of the host arrays L (3,) and off (n_boxes, 3), both in
// blob radii; false when they are missing, the count is out of range or
// the first box is not the home box
template <typename T>
bool image_boxes(const double* L, int n_boxes, const double* off,
                 ImageBoxes<T>& g) {
  if (L == nullptr || off == nullptr || n_boxes < 1 || n_boxes > kMaxBoxes ||
      off[0] != 0.0 || off[1] != 0.0 || off[2] != 0.0)
    return false;
  for (int a = 0; a < 3; ++a) {
    g.L[a] = L[a] > 0.0 ? L[a] : 0.0;
    g.inv_L[a] = L[a] > 0.0 ? 1.0 / L[a] : 0.0;
  }
  g.n = n_boxes;
  for (int b = 0; b < n_boxes; ++b)
    for (int a = 0; a < 3; ++a) g.off[b][a] = T(off[3 * b + a]);
  return true;
}

// the same list as PlaneBoxes: false unless L = (Lx, Ly, 0) with Lx and Ly
// above min_len (kPlaneFarMin blob radii; P1 scales it by its largest
// radius) and off is box_offsets' nine boxes b L in its order
template <typename T>
bool plane_boxes(const double* L, int n_boxes, const double* off,
                 PlaneBoxes<T>& g, double min_len = kPlaneFarMin) {
  if (L == nullptr || off == nullptr || n_boxes != 9 ||
      !(L[0] > min_len) || !(L[1] > min_len) || L[2] != 0.0)
    return false;
  for (int k = 0; k < 9; ++k) {
    const int idx = k == 0 ? 4 : k - 1 + (k >= 5 ? 1 : 0);
    if (off[3 * k] != (idx / 3 - 1) * L[0] ||
        off[3 * k + 1] != (idx % 3 - 1) * L[1] || off[3 * k + 2] != 0.0)
      return false;
  }
  for (int a = 0; a < 2; ++a) {
    g.L[a] = L[a];
    g.inv_L[a] = 1.0 / L[a];
  }
  g.Lx = T(L[0]);
  g.Ly = T(L[1]);
  return true;
}

// runs launch_fn(policy) with the list's policy: PlaneBoxes when the list
// is one (plane_boxes), ImageBoxes otherwise
template <typename T, typename F>
int with_boxes(const double* L, int n_boxes, const double* off,
               F&& launch_fn) {
  PlaneBoxes<T> plane{};
  if (plane_boxes(L, n_boxes, off, plane)) return launch_fn(plane);
  ImageBoxes<T> g{};
  if (!image_boxes(L, n_boxes, off, g))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fn(g);
}

template <typename T, typename C>
int launch_img(const T* q_src, const T* q_tgt, const T* vec, T* out, T* ws,
               int n_src, int n_tgt, int n_rhs, int n_slices,
               int tiles_per_slice, int wall, int self_interaction, int row0,
               const double* L, int n_boxes, const double* off, void* stream) {
  return with_boxes<T>(L, n_boxes, off, [&](const auto& g) {
    return launch<T, C>(q_src, q_tgt, vec, out, ws, n_src, n_tgt, n_rhs,
                        n_slices, tiles_per_slice, wall, self_interaction,
                        row0, g, stream);
  });
}

template <typename T, typename C>
int launch_sym_img(const T* q, const T* vec, T* out, T* ws, int n, int n_rhs,
                   int n_groups, int tiles_per_group, int wall,
                   int self_interaction, int pair0, int n_pairs,
                   const double* L, int n_boxes, const double* off,
                   void* stream) {
  return with_boxes<T>(L, n_boxes, off, [&](const auto& g) {
    return launch_sym<T, C>(q, vec, out, ws, n, n_rhs, n_groups,
                            tiles_per_group, wall, self_interaction, pair0,
                            n_pairs, g, stream);
  });
}

}  // namespace pairk

// per coupling: one f32 and one f64 C entry point with the signature
// (q_src, q_tgt, vec, out, ws, n_src, n_tgt, n_rhs, n_slices,
// tiles_per_slice, wall, self_interaction, row0, stream), `wall` the
// domain code of with_wall (the couplings 0 or 1, the free surface 2),
// row0 the source row of target 0 for the self pair (0, or a rank's first
// row when its targets are a share of the sources), their image-box
// instances NAME_img_f32 / _f64 with (L, n_boxes, off) before the stream
// (host arrays in blob radii: the box, 0 on an open axis, and the boxes'
// offsets b L, the home box first; with_boxes picks the policy), and
// NAME_shape(f64, n_rhs, wall, images, &blocks_per_sm), images 0, 1 or 2
// (open, ImageBoxes, PlaneBoxes)
#define PAIRK_ENTRY(NAME, COUPLING)                                          \
  extern "C" int NAME##_f32(const float* q_src, const float* q_tgt,          \
                            const float* vec, float* out, float* ws,         \
                            int n_src, int n_tgt, int n_rhs, int n_slices,   \
                            int tiles_per_slice, int wall,                   \
                            int self_interaction, int row0, void* stream) {  \
    return pairk::launch<float, COUPLING>(                                   \
        q_src, q_tgt, vec, out, ws, n_src, n_tgt, n_rhs, n_slices,           \
        tiles_per_slice, wall, self_interaction, row0,                       \
        pairk::OpenBox<float>(), stream);                                    \
  }                                                                          \
  extern "C" int NAME##_f64(const double* q_src, const double* q_tgt,        \
                            const double* vec, double* out, double* ws,      \
                            int n_src, int n_tgt, int n_rhs, int n_slices,   \
                            int tiles_per_slice, int wall,                   \
                            int self_interaction, int row0, void* stream) {  \
    return pairk::launch<double, COUPLING>(                                  \
        q_src, q_tgt, vec, out, ws, n_src, n_tgt, n_rhs, n_slices,           \
        tiles_per_slice, wall, self_interaction, row0,                       \
        pairk::OpenBox<double>(), stream);                                   \
  }                                                                          \
  extern "C" int NAME##_img_f32(                                             \
      const float* q_src, const float* q_tgt, const float* vec, float* out,  \
      float* ws, int n_src, int n_tgt, int n_rhs, int n_slices,              \
      int tiles_per_slice, int wall, int self_interaction, int row0,         \
      const double* L, int n_boxes, const double* off, void* stream) {       \
    return pairk::launch_img<float, COUPLING>(                               \
        q_src, q_tgt, vec, out, ws, n_src, n_tgt, n_rhs, n_slices,           \
        tiles_per_slice, wall, self_interaction, row0, L, n_boxes, off,      \
        stream);                                                             \
  }                                                                          \
  extern "C" int NAME##_img_f64(                                             \
      const double* q_src, const double* q_tgt, const double* vec,           \
      double* out, double* ws, int n_src, int n_tgt, int n_rhs,              \
      int n_slices, int tiles_per_slice, int wall, int self_interaction,     \
      int row0, const double* L, int n_boxes, const double* off,             \
      void* stream) {                                                        \
    return pairk::launch_img<double, COUPLING>(                              \
        q_src, q_tgt, vec, out, ws, n_src, n_tgt, n_rhs, n_slices,           \
        tiles_per_slice, wall, self_interaction, row0, L, n_boxes, off,      \
        stream);                                                             \
  }                                                                          \
  extern "C" int NAME##_shape(int f64, int n_rhs, int wall, int images,      \
                              int* blocks_per_sm) {                          \
    return f64 ? pairk::shape<double, COUPLING>(n_rhs, wall, images,         \
                                                blocks_per_sm)               \
               : pairk::shape<float, COUPLING>(n_rhs, wall, images,          \
                                               blocks_per_sm);               \
  }

// the symmetric sweep of a square product: NAME_f32 / NAME_f64 (q, vec,
// out, ws, n, n_rhs, n_groups, tiles_per_group, wall, self_interaction,
// pair0, n_pairs, stream), the group pairs [pair0, pair0 + n_pairs) of
// launch_sym, and its image-box instances NAME_img_f32 / _f64 with (L,
// n_boxes, off) before the stream
#define PAIRK_SYM_ENTRY(NAME, COUPLING)                                      \
  extern "C" int NAME##_f32(const float* q, const float* vec, float* out,    \
                            float* ws, int n, int n_rhs, int n_groups,       \
                            int tiles_per_group, int wall,                   \
                            int self_interaction, int pair0, int n_pairs,    \
                            void* stream) {                                  \
    return pairk::launch_sym<float, COUPLING>(                               \
        q, vec, out, ws, n, n_rhs, n_groups, tiles_per_group, wall,          \
        self_interaction, pair0, n_pairs, pairk::OpenBox<float>(), stream);  \
  }                                                                          \
  extern "C" int NAME##_f64(const double* q, const double* vec, double* out, \
                            double* ws, int n, int n_rhs, int n_groups,      \
                            int tiles_per_group, int wall,                   \
                            int self_interaction, int pair0, int n_pairs,    \
                            void* stream) {                                  \
    return pairk::launch_sym<double, COUPLING>(                              \
        q, vec, out, ws, n, n_rhs, n_groups, tiles_per_group, wall,          \
        self_interaction, pair0, n_pairs, pairk::OpenBox<double>(), stream); \
  }                                                                          \
  extern "C" int NAME##_img_f32(                                             \
      const float* q, const float* vec, float* out, float* ws, int n,        \
      int n_rhs, int n_groups, int tiles_per_group, int wall,                \
      int self_interaction, int pair0, int n_pairs, const double* L,         \
      int n_boxes, const double* off, void* stream) {                        \
    return pairk::launch_sym_img<float, COUPLING>(                           \
        q, vec, out, ws, n, n_rhs, n_groups, tiles_per_group, wall,          \
        self_interaction, pair0, n_pairs, L, n_boxes, off, stream);          \
  }                                                                          \
  extern "C" int NAME##_img_f64(                                             \
      const double* q, const double* vec, double* out, double* ws, int n,    \
      int n_rhs, int n_groups, int tiles_per_group, int wall,                \
      int self_interaction, int pair0, int n_pairs, const double* L,         \
      int n_boxes, const double* off, void* stream) {                        \
    return pairk::launch_sym_img<double, COUPLING>(                          \
        q, vec, out, ws, n, n_rhs, n_groups, tiles_per_group, wall,          \
        self_interaction, pair0, n_pairs, L, n_boxes, off, stream);          \
  }
