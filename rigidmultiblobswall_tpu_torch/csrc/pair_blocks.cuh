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
// What bounds it on the H100: FP32 issue rate, not bytes. Each pair costs
// ~60-80 flops to condense a 3x3 block into a few scalars (two rsqrt, one
// division, the wall polynomial set), ~10 per block and right-hand side to
// apply it; grand condenses all four blocks (28 scalars) from one shared
// geometry. A source tile of 128 blobs is read once from device memory per
// block and then served from shared memory to all 128 targets of the block.
//
// Design: one thread per target row, sources streamed through shared
// memory in tiles (the classic n-body pattern), sums kept in registers,
// per-tile partial sums. Each pair is condensed once and the result applied
// to every right-hand side, as the TPU kernel does. Ragged edges are masked
// by index; there is no padding.
//
// Near/far switch: r > 2 for tt, r >= 2 for rr and the cross blocks.
// Self pair (i == j with self_interaction) and coincident distinct blobs
// (r^2 == 0, i != j): the tt core is 4/3 and 0, the rr core 1 and 0, the
// cross core 0 and 0. The wall terms evaluated at the self geometry
// (dx = dy = 0, Rz = 2z) ARE the wall self-mobility of every block and are
// kept.

#pragma once

#include <cuda_runtime.h>

namespace pairk {

constexpr int kTile = 128;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// geometry of one (target, source) pair, shared by every block
template <typename T>
struct Pair {
  T dx, dy, dz, xy2, r2;
  T invr;                 // 1/r, valid when !zero, set by with_rsqrt
  bool self, zero;
  T zt, zs, Rz, invR;     // wall image: Rz = zt + zs, invR = 1/|R|
};

// the two rsqrts the rr and cross blocks (and grand) share; tt takes
// its own (see tt_condense)
template <typename T, bool WALL>
__device__ __forceinline__ Pair<T> with_rsqrt(Pair<T> p) {
  p.invr = p.zero ? T(0) : rsqrt_t(p.r2);
  if (WALL) p.invR = rsqrt_t(p.xy2 + p.Rz * p.Rz);
  return p;
}

// condensed diagonal block (tt, rr): m_ab v_b with five scalars
template <typename T>
struct Diag {
  T A, S, P, Q, mzz;
};

// condensed cross block (tr, rt): core coefficient plus the 8 wall
// entries of the UT pattern (subtracted; rt applies the transpose)
template <typename T>
struct Cross {
  T c, cxx, cxy, cxz, cyx, cyy, cyz, czx, czy;
};

// tt takes its rsqrts inside its own branches, not from with_rsqrt: so
// the tt kernel's per-pair code is the one it had before the other
// couplings joined, its results bit-identical (checked on the H100).
// Grand evaluates the same rsqrt arguments again here.
template <typename T, bool WALL>
__device__ __forceinline__ Diag<T> tt_condense(const Pair<T>& p) {
  const T one = T(1), two = T(2), three = T(3);
  const T four_thirds = T(4.0 / 3.0);
  // unbounded RPY core: m_ab = c1 delta_ab + c2 d_a d_b
  T c1, c2;
  if (p.zero) {
    c1 = p.self ? four_thirds : T(0);
    c2 = T(0);
  } else {
    const T invr = rsqrt_t(p.r2);
    const T invr2 = invr * invr;
    const T r = p.r2 * invr;
    if (r > two) {
      c1 = (one + T(2.0 / 3.0) * invr2) * invr;
      c2 = (one - two * invr2) * invr2 * invr;
    } else {
      c1 = four_thirds * (one - T(0.28125) * r);
      c2 = four_thirds * T(0.09375) * invr;
    }
  }
  Diag<T> m;
  if (WALL) {
    // Swan-Brady image system on raw (dx, dy, Rz) products
    const T Rz = p.Rz, zs = p.zs;
    const T R2 = p.xy2 + Rz * Rz;
    const T invR = rsqrt_t(R2);
    const T invR2 = invR * invR;
    const T invR3 = invR * invR2;
    const T invR5 = invR3 * invR2;
    const T ez = Rz * invR;
    const T ez2 = ez * ez;
    const T h_hat = zs / Rz;
    const T hh = h_hat * (one - h_hat);
    const T f1 = -(three * (one + two * hh * ez2) * invR +
                   two * (one - three * ez2) * invR3 -
                   two * (one - T(5) * ez2) * invR5) /
                 three;
    const T f2 = -(three * (one - T(6) * hh * ez2) * invR -
                   T(6) * (one - T(5) * ez2) * invR3 +
                   T(10) * (one - T(7) * ez2) * invR5) /
                 three;
    const T f3 =
        ez *
        (three * h_hat * (one - T(6) * (one - h_hat) * ez2) * invR -
         T(6) * (one - T(5) * ez2) * invR3 +
         T(10) * (two - T(7) * ez2) * invR5) *
        T(2.0 / 3.0);
    const T f4 = ez * (three * h_hat * invR - T(10) * invR5) * T(2.0 / 3.0);
    const T f5 = -(three * h_hat * h_hat * ez2 * invR +
                   three * ez2 * invR3 + (two - T(15) * ez2) * invR5) *
                 T(4.0 / 3.0);
    const T g2 = f2 * invR2;
    const T g3 = f3 * invR;
    const T g4 = f4 * invR;
    const T dz = p.dz;
    m.A = c1 + f1;
    m.S = c2 + g2;
    const T base_pq = c2 * dz + g2 * Rz;
    m.P = base_pq + g3;
    m.Q = base_pq + g4;
    m.mzz = m.A + c2 * dz * dz + g2 * Rz * Rz + (g3 + g4) * Rz + f5;
  } else {
    m.A = c1;
    m.S = c2;
    m.P = c2 * p.dz;
    m.Q = m.P;
    m.mzz = c1 + c2 * p.dz * p.dz;
  }
  return m;
}

template <typename T, bool WALL>
__device__ __forceinline__ Diag<T> rr_condense(const Pair<T>& p) {
  T c1, c2;
  if (p.zero) {
    c1 = p.self ? T(1) : T(0);
    c2 = T(0);
  } else {
    const T invr = p.invr;
    const T invr2 = invr * invr;
    const T invr3 = invr2 * invr;
    const T r = p.r2 * invr;
    if (r >= T(2)) {
      c1 = T(-0.5) * invr3;
      c2 = T(1.5) * invr2 * invr3;
    } else {
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

// IS_TR: tr, U from T, wall height z_target and reflected in-plane
// displacement; otherwise rt, W from F, wall height z_source
template <typename T, bool WALL, bool IS_TR>
__device__ __forceinline__ Cross<T> cross_condense(const Pair<T>& p) {
  Cross<T> m;
  if (p.zero) {
    m.c = T(0);
  } else {
    const T invr = p.invr;
    const T r = p.r2 * invr;
    m.c = r >= T(2) ? invr * invr * invr : T(0.5) * (T(1) - T(0.375) * r);
  }
  if (WALL) {
    // rpy._wall_cross_core folded onto raw (dx, dy, Rz):
    // F1 = f1 / R, F2 = f2 / R, G3 = f3 / R^2
    const T Rz = p.Rz, invR = p.invR;
    const T h = IS_TR ? p.zt : p.zs;
    const T invR2 = invR * invR;
    const T invR4 = invR2 * invR2;
    const T ez = Rz * invR;
    const T ez2 = ez * ez;
    const T h_hat = h / Rz;
    const T F1 = invR2 * invR;
    const T F2 =
        (T(6) * h_hat * ez2 * invR2 + (T(1) - T(10) * ez2) * invR4) * T(2) *
        invR;
    const T G3 = -ez * (T(3) * h_hat * invR2 - T(5) * invR4) * T(2) * invR2;
    const T f4 = -ez * (h_hat * invR2 - invR4) * T(2);
    const T ux = IS_TR ? -p.dx : p.dx;
    const T uy = IS_TR ? -p.dy : p.dy;
    m.cxx = -G3 * ux * uy;
    m.cxy = -F1 * Rz + G3 * ux * ux - f4;
    m.cxz = F1 * uy;
    m.cyx = F1 * Rz - G3 * uy * uy + f4;
    m.cyy = G3 * ux * uy;
    m.cyz = -F1 * ux;
    m.czx = -(F1 + F2) * uy - G3 * uy * Rz;
    m.czy = (F1 + F2) * ux + G3 * ux * Rz;
  }
  return m;
}

template <typename T>
__device__ __forceinline__ void diag_apply(const Diag<T>& m, T dx, T dy,
                                           T vx, T vy, T vz, T& ox, T& oy,
                                           T& oz) {
  const T w = dx * vx + dy * vy;
  const T u = m.S * w + m.P * vz;
  ox = dx * u + m.A * vx;
  oy = dy * u + m.A * vy;
  oz = m.Q * w + m.mzz * vz;
}

template <typename T, bool WALL, bool IS_TR>
__device__ __forceinline__ void cross_apply(const Cross<T>& m, const Pair<T>& p,
                                            T vx, T vy, T vz, T& ox, T& oy,
                                            T& oz) {
  ox = m.c * (p.dz * vy - p.dy * vz);
  oy = m.c * (p.dx * vz - p.dz * vx);
  oz = m.c * (p.dy * vx - p.dx * vy);
  if (WALL) {
    if (IS_TR) {
      ox -= m.cxx * vx + m.cxy * vy + m.cxz * vz;
      oy -= m.cyx * vx + m.cyy * vy + m.cyz * vz;
      oz -= m.czx * vx + m.czy * vy;
    } else {  // rt: transposed pattern
      ox -= m.cxx * vx + m.cyx * vy + m.czx * vz;
      oy -= m.cxy * vx + m.cyy * vy + m.czy * vz;
      oz -= m.cxz * vx + m.cyz * vy;
    }
  }
}

// Couplings: input/output components per right-hand side, the largest B
// the paths launch (the template instances), and the per-pair update of
// the partial sums from the shared-memory source tile.
struct TT {
  static constexpr int kComp = 3;
  static constexpr int kMaxRhs = 2;
  template <typename T, int B, bool WALL>
  __device__ static void accumulate(const Pair<T>& p,
                                    T (*sv)[kTile], int k, T* part) {
    const Diag<T> m = tt_condense<T, WALL>(p);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const T vx = sv[3 * b + 0][k];
      const T vy = sv[3 * b + 1][k];
      const T vz = sv[3 * b + 2][k];
      const T w = p.dx * vx + p.dy * vy;
      const T u = m.S * w + m.P * vz;
      part[3 * b + 0] += p.dx * u + m.A * vx;
      part[3 * b + 1] += p.dy * u + m.A * vy;
      part[3 * b + 2] += m.Q * w + m.mzz * vz;
    }
  }
};

struct RR {
  static constexpr int kComp = 3;
  static constexpr int kMaxRhs = 2;
  template <typename T, int B, bool WALL>
  __device__ static void accumulate(const Pair<T>& p0,
                                    T (*sv)[kTile], int k, T* part) {
    const Pair<T> p = with_rsqrt<T, WALL>(p0);
    const Diag<T> m = rr_condense<T, WALL>(p);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      T ox, oy, oz;
      diag_apply(m, p.dx, p.dy, sv[3 * b][k], sv[3 * b + 1][k],
                 sv[3 * b + 2][k], ox, oy, oz);
      part[3 * b + 0] += ox;
      part[3 * b + 1] += oy;
      part[3 * b + 2] += oz;
    }
  }
};

template <bool IS_TR, int MAX_RHS>
struct CrossCoupling {
  static constexpr int kComp = 3;
  static constexpr int kMaxRhs = MAX_RHS;
  template <typename T, int B, bool WALL>
  __device__ static void accumulate(const Pair<T>& p0,
                                    T (*sv)[kTile], int k, T* part) {
    const Pair<T> p = with_rsqrt<T, WALL>(p0);
    const Cross<T> m = cross_condense<T, WALL, IS_TR>(p);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      T ox, oy, oz;
      cross_apply<T, WALL, IS_TR>(m, p, sv[3 * b][k], sv[3 * b + 1][k],
                                  sv[3 * b + 2][k], ox, oy, oz);
      part[3 * b + 0] += ox;
      part[3 * b + 1] += oy;
      part[3 * b + 2] += oz;
    }
  }
};
using TR = CrossCoupling<true, 2>;
using RT = CrossCoupling<false, 1>;

struct Grand {
  static constexpr int kComp = 6;
  static constexpr int kMaxRhs = 1;
  template <typename T, int B, bool WALL>
  __device__ static void accumulate(const Pair<T>& p0,
                                    T (*sv)[kTile], int k, T* part) {
    const Pair<T> p = with_rsqrt<T, WALL>(p0);
    const Diag<T> mtt = tt_condense<T, WALL>(p);
    const Cross<T> mtr = cross_condense<T, WALL, true>(p);
    const Cross<T> mrt = cross_condense<T, WALL, false>(p);
    const Diag<T> mrr = rr_condense<T, WALL>(p);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const T fx = sv[6 * b + 0][k], fy = sv[6 * b + 1][k],
              fz = sv[6 * b + 2][k];
      const T tx = sv[6 * b + 3][k], ty = sv[6 * b + 4][k],
              tz = sv[6 * b + 5][k];
      T ax, ay, az, bx, by, bz;
      // U = M_tt F + M_tr T
      diag_apply(mtt, p.dx, p.dy, fx, fy, fz, ax, ay, az);
      cross_apply<T, WALL, true>(mtr, p, tx, ty, tz, bx, by, bz);
      part[6 * b + 0] += ax + bx;
      part[6 * b + 1] += ay + by;
      part[6 * b + 2] += az + bz;
      // W = M_rt F + M_rr T
      cross_apply<T, WALL, false>(mrt, p, fx, fy, fz, ax, ay, az);
      diag_apply(mrr, p.dx, p.dy, tx, ty, tz, bx, by, bz);
      part[6 * b + 3] += ax + bx;
      part[6 * b + 4] += ay + by;
      part[6 * b + 5] += az + bz;
    }
  }
};

template <typename T, typename C, int B, bool WALL>
__global__ void __launch_bounds__(kTile)
pair_kernel(const T* __restrict__ q_src, const T* __restrict__ q_tgt,
            const T* __restrict__ vec, T* __restrict__ out, int n_src,
            int n_tgt, int self_interaction) {
  constexpr int NV = C::kComp * B;
  __shared__ T s_pos[3][kTile];
  __shared__ T s_vec[NV][kTile];

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool active = i < n_tgt;
  T xt = T(0), yt = T(0), zt = T(1);
  if (active) {
    xt = q_tgt[3 * i + 0];
    yt = q_tgt[3 * i + 1];
    zt = q_tgt[3 * i + 2];
  }
  T acc[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) acc[c] = T(0);

  for (int base = 0; base < n_src; base += kTile) {
    const int j_load = base + threadIdx.x;
    if (j_load < n_src) {
      s_pos[0][threadIdx.x] = q_src[3 * j_load + 0];
      s_pos[1][threadIdx.x] = q_src[3 * j_load + 1];
      s_pos[2][threadIdx.x] = q_src[3 * j_load + 2];
#pragma unroll
      for (int c = 0; c < NV; ++c)
        s_vec[c][threadIdx.x] = vec[(size_t)j_load * NV + c];
    }
    __syncthreads();
    const int count = min(kTile, n_src - base);
    if (active) {
      // per-tile partial sums, added once per tile: keeps f32 rounding
      // of the N-term sum near sqrt(N / kTile) instead of sqrt(N) steps
      T part[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) part[c] = T(0);
      for (int k = 0; k < count; ++k) {
        const T xs = s_pos[0][k], ys = s_pos[1][k], zs = s_pos[2][k];
        Pair<T> p;
        p.dx = xt - xs;
        p.dy = yt - ys;
        p.dz = zt - zs;
        p.xy2 = p.dx * p.dx + p.dy * p.dy;
        p.r2 = p.xy2 + p.dz * p.dz;
        p.self = self_interaction && (base + k == i);
        p.zero = p.self || (p.r2 == T(0));
        if (WALL) {
          p.zt = zt;
          p.zs = zs;
          p.Rz = zt + zs;
        }
        C::template accumulate<T, B, WALL>(p, s_vec, k, part);
      }
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[c] += part[c];
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < NV; ++c) out[(size_t)i * NV + c] = acc[c];
  }
}

template <typename T, typename C, int B>
void launch_b(const T* q_src, const T* q_tgt, const T* vec, T* out,
              int n_src, int n_tgt, int wall, int self_interaction,
              cudaStream_t stream) {
  const dim3 grid((n_tgt + kTile - 1) / kTile);
  if (wall)
    pair_kernel<T, C, B, true><<<grid, kTile, 0, stream>>>(
        q_src, q_tgt, vec, out, n_src, n_tgt, self_interaction);
  else
    pair_kernel<T, C, B, false><<<grid, kTile, 0, stream>>>(
        q_src, q_tgt, vec, out, n_src, n_tgt, self_interaction);
}

// q_src (n_src,3), q_tgt (n_tgt,3), vec (n_src, kComp*n_rhs) b-major
// columns, out (n_tgt, kComp*n_rhs); all contiguous on the device;
// 1 <= n_rhs <= kMaxRhs, n_src, n_tgt > 0. Returns the CUDA error code of
// the launch (0 on success).
template <typename T, typename C>
int launch(const T* q_src, const T* q_tgt, const T* vec, T* out, int n_src,
           int n_tgt, int n_rhs, int wall, int self_interaction,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rhs == 1) {
    launch_b<T, C, 1>(q_src, q_tgt, vec, out, n_src, n_tgt, wall,
                      self_interaction, s);
  } else if constexpr (C::kMaxRhs >= 2) {
    if (n_rhs != 2) return static_cast<int>(cudaErrorInvalidValue);
    launch_b<T, C, 2>(q_src, q_tgt, vec, out, n_src, n_tgt, wall,
                      self_interaction, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pairk

// one f32 and one f64 C entry point per coupling, all with the signature
// (q_src, q_tgt, vec, out, n_src, n_tgt, n_rhs, wall, self_interaction,
// stream)
#define PAIRK_ENTRY(NAME, COUPLING)                                          \
  extern "C" int NAME##_f32(const float* q_src, const float* q_tgt,          \
                            const float* vec, float* out, int n_src,         \
                            int n_tgt, int n_rhs, int wall,                  \
                            int self_interaction, void* stream) {            \
    return pairk::launch<float, COUPLING>(q_src, q_tgt, vec, out, n_src,     \
                                          n_tgt, n_rhs, wall,                \
                                          self_interaction, stream);         \
  }                                                                          \
  extern "C" int NAME##_f64(const double* q_src, const double* q_tgt,        \
                            const double* vec, double* out, int n_src,       \
                            int n_tgt, int n_rhs, int wall,                  \
                            int self_interaction, void* stream) {            \
    return pairk::launch<double, COUPLING>(q_src, q_tgt, vec, out, n_src,    \
                                           n_tgt, n_rhs, wall,               \
                                           self_interaction, stream);        \
  }
