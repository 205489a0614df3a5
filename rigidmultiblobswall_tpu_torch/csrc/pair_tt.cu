// Kernel K1: direct O(N^2) translation-translation mobility product,
// RPY core plus Swan-Brady single-wall corrections, for B stacked
// right-hand sides.
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/pair_kernels.py
// (_pair_kernel, coupling "tt"; wrapper pair_matvec_pallas). Same units:
// lengths are in blob radii, heights already shifted to max(z, a) and the
// vector already damped by the caller, which also applies 1/(8 pi eta a)
// and the target damping.
//
// What bounds it on the H100: FP32 issue rate, not bytes. Each pair costs
// ~60-80 flops to condense the 3x3 block into five scalars (two rsqrt,
// one division, the wall polynomial set) plus ~10 per right-hand side;
// a source tile of 128 blobs is read once from device memory per block
// and then served from shared memory to all 128 targets of the block.
//
// Design: one thread per target row, sources streamed through shared
// memory in tiles (the classic n-body pattern), sums kept in registers.
// The block coefficients are condensed once per pair and applied to every
// right-hand side, as the TPU kernel does. Ragged edges are masked by
// index; there is no padding.
//
// Self pair (i == j with self_interaction): only the unbounded core is
// replaced (c1 = 4/3, c2 = 0); the wall terms evaluated at the self
// geometry ARE the wall self-mobility and are kept. Coincident distinct
// blobs (r^2 == 0, i != j) get no core term.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <typename T, int B, bool WALL>
__global__ void __launch_bounds__(kTile)
pair_tt_kernel(const T* __restrict__ q_src, const T* __restrict__ q_tgt,
               const T* __restrict__ vec, T* __restrict__ out, int n_src,
               int n_tgt, int self_interaction) {
  __shared__ T s_pos[3][kTile];
  __shared__ T s_vec[3 * B][kTile];

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool active = i < n_tgt;
  T xt = T(0), yt = T(0), zt = T(1);
  if (active) {
    xt = q_tgt[3 * i + 0];
    yt = q_tgt[3 * i + 1];
    zt = q_tgt[3 * i + 2];
  }
  T acc[3 * B];
#pragma unroll
  for (int c = 0; c < 3 * B; ++c) acc[c] = T(0);

  const T one = T(1), two = T(2), three = T(3);
  const T four_thirds = T(4.0 / 3.0);

  for (int base = 0; base < n_src; base += kTile) {
    const int j_load = base + threadIdx.x;
    if (j_load < n_src) {
      s_pos[0][threadIdx.x] = q_src[3 * j_load + 0];
      s_pos[1][threadIdx.x] = q_src[3 * j_load + 1];
      s_pos[2][threadIdx.x] = q_src[3 * j_load + 2];
#pragma unroll
      for (int c = 0; c < 3 * B; ++c)
        s_vec[c][threadIdx.x] = vec[(size_t)j_load * (3 * B) + c];
    }
    __syncthreads();
    const int count = min(kTile, n_src - base);
    if (active) {
      // per-tile partial sums, added once per tile: keeps f32 rounding
      // of the N-term sum near sqrt(N / kTile) instead of sqrt(N) steps
      T part[3 * B];
#pragma unroll
      for (int c = 0; c < 3 * B; ++c) part[c] = T(0);
      for (int k = 0; k < count; ++k) {
        const T xs = s_pos[0][k], ys = s_pos[1][k], zs = s_pos[2][k];
        const T dx = xt - xs, dy = yt - ys, dz = zt - zs;
        const T xy2 = dx * dx + dy * dy;
        const T r2 = xy2 + dz * dz;
        const bool self = self_interaction && (base + k == i);
        const bool zero = self || (r2 == T(0));

        // unbounded RPY core: m_ab = c1 delta_ab + c2 d_a d_b
        T c1, c2;
        if (zero) {
          c1 = self ? four_thirds : T(0);
          c2 = T(0);
        } else {
          const T invr = rsqrt_t(r2);
          const T invr2 = invr * invr;
          const T r = r2 * invr;
          if (r > two) {
            c1 = (one + T(2.0 / 3.0) * invr2) * invr;
            c2 = (one - two * invr2) * invr2 * invr;
          } else {
            c1 = four_thirds * (one - T(0.28125) * r);
            c2 = four_thirds * T(0.09375) * invr;
          }
        }

        T A, S, P, Q, mzz;
        if (WALL) {
          // Swan-Brady image system on raw (dx, dy, Rz) products
          const T Rz = zt + zs;
          const T R2 = xy2 + Rz * Rz;
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
          const T f4 =
              ez * (three * h_hat * invR - T(10) * invR5) * T(2.0 / 3.0);
          const T f5 = -(three * h_hat * h_hat * ez2 * invR +
                         three * ez2 * invR3 + (two - T(15) * ez2) * invR5) *
                       T(4.0 / 3.0);
          const T g2 = f2 * invR2;
          const T g3 = f3 * invR;
          const T g4 = f4 * invR;
          A = c1 + f1;
          S = c2 + g2;
          const T base_pq = c2 * dz + g2 * Rz;
          P = base_pq + g3;
          Q = base_pq + g4;
          mzz = A + c2 * dz * dz + g2 * Rz * Rz + (g3 + g4) * Rz + f5;
        } else {
          A = c1;
          S = c2;
          P = c2 * dz;
          Q = P;
          mzz = c1 + c2 * dz * dz;
        }

#pragma unroll
        for (int b = 0; b < B; ++b) {
          const T vx = s_vec[3 * b + 0][k];
          const T vy = s_vec[3 * b + 1][k];
          const T vz = s_vec[3 * b + 2][k];
          const T w = dx * vx + dy * vy;
          const T u = S * w + P * vz;
          part[3 * b + 0] += dx * u + A * vx;
          part[3 * b + 1] += dy * u + A * vy;
          part[3 * b + 2] += Q * w + mzz * vz;
        }
      }
#pragma unroll
      for (int c = 0; c < 3 * B; ++c) acc[c] += part[c];
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < 3 * B; ++c) out[(size_t)i * (3 * B) + c] = acc[c];
  }
}

template <typename T, int B>
void launch_b(const T* q_src, const T* q_tgt, const T* vec, T* out, int n_src,
              int n_tgt, int wall, int self_interaction, cudaStream_t stream) {
  const dim3 grid((n_tgt + kTile - 1) / kTile);
  if (wall)
    pair_tt_kernel<T, B, true><<<grid, kTile, 0, stream>>>(
        q_src, q_tgt, vec, out, n_src, n_tgt, self_interaction);
  else
    pair_tt_kernel<T, B, false><<<grid, kTile, 0, stream>>>(
        q_src, q_tgt, vec, out, n_src, n_tgt, self_interaction);
}

template <typename T>
int launch(const T* q_src, const T* q_tgt, const T* vec, T* out, int n_src,
           int n_tgt, int n_rhs, int wall, int self_interaction,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_rhs) {
    case 1: launch_b<T, 1>(q_src, q_tgt, vec, out, n_src, n_tgt, wall, self_interaction, s); break;
    case 2: launch_b<T, 2>(q_src, q_tgt, vec, out, n_src, n_tgt, wall, self_interaction, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_src (n_src,3), q_tgt (n_tgt,3), vec (n_src,3*n_rhs) b-major columns,
// out (n_tgt,3*n_rhs); all contiguous on the device; n_rhs is 1 or 2.
// Returns the CUDA error code of the launch (0 on success). Requires
// n_src, n_tgt > 0.
extern "C" int pair_tt_f32(const float* q_src, const float* q_tgt,
                           const float* vec, float* out, int n_src, int n_tgt,
                           int n_rhs, int wall, int self_interaction,
                           void* stream) {
  return launch<float>(q_src, q_tgt, vec, out, n_src, n_tgt, n_rhs, wall,
                       self_interaction, stream);
}

extern "C" int pair_tt_f64(const double* q_src, const double* q_tgt,
                           const double* vec, double* out, int n_src,
                           int n_tgt, int n_rhs, int wall,
                           int self_interaction, void* stream) {
  return launch<double>(q_src, q_tgt, vec, out, n_src, n_tgt, n_rhs, wall,
                        self_interaction, stream);
}
