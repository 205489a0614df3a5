// Kernel L1: the Laplace boundary-integral layer sums of the phoretic
// model, over all (target, source) pairs with optional wall images, each
// source weighted by its quadrature weight, prefactor 1/(4 pi):
//   S  (single layer)     out_i   = sum_j c_j w_j (1/r + 1/R)
//   D  (double layer)     out_i   = sum_j c_j w_j ((r.n_j)/r^3 + (R.n~_j)/R^3)
//   dD (its derivative)   out_i^a = sum_j c_j w_j (L(r) n_j + L(R) n~_j)^a,
//                         L = (I - 3 rhat rhat)/r^3 with Lzz = -Lxx - Lyy
//   T  (dipole)           out_i^a = sum_j c_j w_j (r^a/r^3 + R^a/R^3)
// and two fused sums of the phoretic solve, each one sweep:
//   bvp  out_i   = c_i/2 - D[c]_i + S[k c / Dc]_i   (the BVP operator)
//   grad out_i^a = 2 dD[c]_i^a - 2 T[(q - k c)/Dc]_i^a (surface gradient)
// r = x_i - y_j, R = (r_x, r_y, z_i + z_j) its image distance, n~ = n with
// n_z reflected. Masks, as rigidmultiblobswall_tpu/ops/laplace.py sets
// them: a real pair is skipped at zero distance or, with the self mask, at
// index coincidence i == j; an image only at zero image distance, where
// the single layer takes 1/R = 1 (that module's _inv_r) and the others 0.
//
// Replaces no Pallas kernel: the JAX package computes these sums as XLA
// on materialized (Nt, Ns, 3) pair tensors (rigidmultiblobswall_tpu/ops/
// laplace.py:18-130), 29 GB a tensor in float32 at 49,152 blobs, so the
// port needs them as a kernel to run the phoretic path at all.
//
// What bounds it on the H100: instruction issue and the special-function
// unit. A pair needs one rsqrt for the real source and one for its image
// (MUFU.RSQ, 16 a clock an SM against 128 float32 operations) beside
// 10-50 float32 operations; bytes are 16-40 a source and 4-24 a target.
//
// Two instances (ops/laplace.py picks one; the public API does not
// change):
// - The symmetric sweep (l1_sym), wherever the targets are the sources:
//   the BVP operator, the surface gradient, and S, D, dD and T called with
//   r_tgt the same tensor as r_src. There 1/r, 1/R, |d|^2 and L(r) are the
//   same for (i, j) and (j, i), so each unordered pair's geometry, both
//   rsqrts and L are formed once and its terms added to both ends
//   (pair<BOTH>): seen from j, r_ji = -r_ij and R_ji = (-dx, -dy, z_i +
//   z_j), so L(r) is even, the image's L_xz and L_yz change sign, T's real
//   term flips whole and its image only in x and y, and D, dD and the BVP
//   operator take i's normal (n_z reflected in the image) and
//   coefficients. The 128-blob tiles fall into K1's tile groups
//   (ops/pair_kernels.py plan_groups); a block takes one pair of groups
//   (GA <= GB) of the upper triangle (pairk::group_pair) and sweeps its
//   tile pairs; a diagonal tile runs the directed loop over its own tile,
//   where the zero-distance mask holds i == j. Off the diagonal each
//   thread holds one target of tile a and every lane reads the same
//   staged source of tile b (x, y, z, a | a n, b: one or two broadcast
//   16-byte loads; each normal is staged times a = c w, which saves the
//   multiply by a in every term). The source's share from the warp's 32
//   targets comes back by a reduce-scatter over 2^kLevels sources at a
//   time (sweep_broadcast): a shuffle, an add and two selects a pair and
//   output component, against the 5-11 shuffles a pair of rotating the
//   source and its sums through the lanes as K1 and K2 do, which measured
//   slower on the H100 (PERF.md section 6). The four warps' source sums
//   are added in shared memory in warp order.
// - The directed sweep (l1_directed), for targets that are not the
//   sources (the concentration field's D and S on grid points): one
//   target a thread, 128 targets a block, the sources in S slices of
//   whole 128-source tiles (ops/laplace.py plan_slices) so that the grid
//   fills the 132 SMs, staged as the same padded rows.
// Both sum each tile pair in registers (float32 in the float32 instances)
// and add the tile's sums into float64: the symmetric sweep into the rows
// of a workspace (G, N, C), each (slice, row) entry owned by one block
// (the target-side sums of group GA in slice GB, the source-side sums of
// group GB in slice GA); the directed sweep writes its slice's rows of
// (S, Nt, C). reduce_kernel adds the slices in order and scales: no
// atomics, so every launch is bit-identical on repeat. Masked pairs take
// 1/r = 0, which zeroes every term without a branch; padding rows (past N
// in the last tile) carry zero coefficients, so their terms vanish both
// ways. rsqrt is pairk::rsqrt_t (rsqrt.approx.ftz in float32).
#include <cuda_runtime.h>

#include "pair_blocks.cuh"

namespace {

using pairk::kLanes;
using pairk::kTile;
using pairk::kWarps;

enum Op { kS = 0, kD = 1, kDD = 2, kT = 3, kBvp = 4, kGrad = 5 };

template <int OP>
struct Traits {
  static constexpr int kOut = (OP == kDD || OP == kT || OP == kGrad) ? 3 : 1;
  static constexpr bool kNormals =
      OP == kD || OP == kDD || OP == kBvp || OP == kGrad;
  static constexpr bool kTwo = OP == kBvp || OP == kGrad;
  // a staged row: x, y, z, a = c w, then nx, ny, nz, b with normals
  static constexpr int kRow = kNormals ? 8 : 4;
  // sources a reduce-scatter batch of the symmetric sweep: 2^kLevels
  static constexpr int kLevels = kOut == 1 ? 4 : 3;
};

// a blob as a pair reads it: position, a = c w, the normal times a (every
// operator that reads normals weights them by a) and b (the operator's
// second coefficient); the fields an operator does not read stay 0
template <typename T>
struct Blob {
  T x, y, z, a, nx, ny, nz, b;
};

// blob j of the inputs, or for j >= n a padding blob: zero coefficients
// at a finite position, whose terms vanish
template <int OP, typename T>
__device__ __forceinline__ Blob<T> blob(const T* r, const T* nrm, const T* c,
                                        const T* w, const T* k, const T* q,
                                        T dc, int j, int n) {
  Blob<T> s{T(0), T(0), T(1), T(0), T(0), T(0), T(0), T(0)};
  if (j < n) {
    s.x = r[3 * j + 0];
    s.y = r[3 * j + 1];
    s.z = r[3 * j + 2];
    const T cj = c[j], wj = w[j];
    s.a = cj * wj;
    if constexpr (Traits<OP>::kNormals) {
      s.nx = s.a * nrm[3 * j + 0];
      s.ny = s.a * nrm[3 * j + 1];
      s.nz = s.a * nrm[3 * j + 2];
    }
    if constexpr (OP == kBvp) s.b = (k[j] * cj / dc) * wj;
    if constexpr (OP == kGrad) s.b = ((q[j] - k[j] * cj) / dc) * wj;
  }
  return s;
}

template <int OP, typename T>
__device__ __forceinline__ void store_row(const Blob<T>& s, T* row) {
  row[0] = s.x;
  row[1] = s.y;
  row[2] = s.z;
  row[3] = s.a;
  if constexpr (Traits<OP>::kRow == 8) {
    row[4] = s.nx;
    row[5] = s.ny;
    row[6] = s.nz;
    row[7] = s.b;
  }
}

template <int OP, typename T>
__device__ __forceinline__ Blob<T> read_row(const T* row) {
  T v[Traits<OP>::kRow];
  pairk::load_row<Traits<OP>::kRow>(row, v);
  Blob<T> s{v[0], v[1], v[2], v[3], T(0), T(0), T(0), T(0)};
  if constexpr (Traits<OP>::kNormals) {
    s.nx = v[4];
    s.ny = v[5];
    s.nz = v[6];
  }
  if constexpr (Traits<OP>::kTwo) s.b = v[7];
  return s;
}

// what a pair's geometry gives both of its directions: the single layer's
// 1/r (1 for an image at zero distance), 1/r^3 and the components of L;
// all 0 for a masked pair (1/r = 0)
template <typename T>
struct Terms {
  T inv_s, inv3, lxx, lxy, lxz, lyy, lyz, lzz;
};

template <int OP, typename T>
__device__ __forceinline__ Terms<T> pair_terms(T dx, T dy, T dz, T inv,
                                               T inv_s) {
  Terms<T> t{};
  t.inv_s = inv_s;
  if constexpr (OP != kS) {
    const T inv2 = inv * inv;
    t.inv3 = inv2 * inv;
    if constexpr (OP == kDD || OP == kGrad) {
      const T fo = T(-3) * inv2;
      t.lxx = (T(1) + fo * dx * dx) * t.inv3;
      t.lxy = (fo * dx * dy) * t.inv3;
      t.lxz = (fo * dx * dz) * t.inv3;
      t.lyy = (T(1) + fo * dy * dy) * t.inv3;
      t.lyz = (fo * dy * dz) * t.inv3;
      t.lzz = -t.lxx - t.lyy;
    }
  }
  return t;
}

// one direction's terms into acc, each product by one FFMA: (ex, ey, ez)
// the displacement from the source to the target, (nx, ny, nz) the
// source's normal times a (n_z reflected for an image), a and b its
// coefficients; ODD: L_xz and L_yz change sign (an image seen from its
// other end, e = (-dx, -dy, z_i + z_j))
template <int OP, bool ODD, typename T>
__device__ __forceinline__ void apply(const Terms<T>& t, T ex, T ey, T ez,
                                      T nx, T ny, T nz, T a, T b, T* acc) {
  if constexpr (OP == kS) {
    acc[0] += a * t.inv_s;
  } else if constexpr (OP == kD || OP == kBvp) {
    const T rn = ex * nx + ey * ny + ez * nz;
    if constexpr (OP == kBvp) acc[0] += b * t.inv_s;
    acc[0] += (OP == kD ? rn : -rn) * t.inv3;
  } else if constexpr (OP == kT) {
    const T s = a * t.inv3;
    acc[0] += s * ex;
    acc[1] += s * ey;
    acc[2] += s * ez;
  } else {  // kDD, kGrad
    const T lxz = ODD ? -t.lxz : t.lxz;
    const T lyz = ODD ? -t.lyz : t.lyz;
    acc[0] += t.lxx * nx;
    acc[0] += t.lxy * ny;
    acc[0] += lxz * nz;
    acc[1] += t.lxy * nx;
    acc[1] += t.lyy * ny;
    acc[1] += lyz * nz;
    acc[2] += lxz * nx;
    acc[2] += lyz * ny;
    acc[2] += t.lzz * nz;
    if constexpr (OP == kGrad) {
      const T s = b * t.inv3;
      acc[0] -= s * ex;
      acc[1] -= s * ey;
      acc[2] -= s * ez;
    }
  }
}

// The pair (target i, source j): i's terms from j into acc_i and, with
// BOTH, j's terms from i into acc_j, from one geometry and one rsqrt for the
// real pair and one for its image. `self` masks the real pair as zero
// distance does. The BVP operator's and L's several products a term are
// summed over the real and the image term of each direction first (from
// -0, which the compiler drops), so each direction rounds once at the
// running sum's scale.
template <int OP, bool WALL, bool BOTH, typename T>
__device__ __forceinline__ void pair(const Blob<T>& ti, const Blob<T>& sj,
                                     bool self, T* acc_i, T* acc_j) {
  constexpr int C = Traits<OP>::kOut;
  constexpr bool kLocal = OP == kBvp || OP == kDD || OP == kGrad;
  T gi[C], gj[C];
#pragma unroll
  for (int e = 0; e < C; ++e) gi[e] = gj[e] = T(-0.0);
  T* acc = kLocal ? gi : acc_i;
  T* cj = kLocal ? gj : acc_j;
  const T dx = ti.x - sj.x;
  const T dy = ti.y - sj.y;
  const T dz = ti.z - sj.z;
  const T xy2 = dx * dx + dy * dy;
  const T d2 = xy2 + dz * dz;
  const T inv = (d2 == T(0) || self) ? T(0) : pairk::rsqrt_t(d2);
  const Terms<T> t = pair_terms<OP>(dx, dy, dz, inv, inv);
  apply<OP, false>(t, dx, dy, dz, sj.nx, sj.ny, sj.nz, sj.a, sj.b, acc);
  if constexpr (BOTH)
    apply<OP, false>(t, -dx, -dy, -dz, ti.nx, ti.ny, ti.nz, ti.a, ti.b, cj);
  if constexpr (WALL) {
    const T rz = ti.z + sj.z;
    const T d2w = xy2 + rz * rz;
    const bool zero = d2w == T(0);
    const T invw = zero ? T(0) : pairk::rsqrt_t(d2w);
    // the single layer's image keeps 1/R = 1 at zero image distance
    const Terms<T> tw =
        pair_terms<OP>(dx, dy, rz, invw, zero ? T(1) : invw);
    apply<OP, false>(tw, dx, dy, rz, sj.nx, sj.ny, -sj.nz, sj.a, sj.b,
                     acc);
    if constexpr (BOTH)
      apply<OP, true>(tw, -dx, -dy, rz, ti.nx, ti.ny, -ti.nz, ti.a, ti.b,
                      cj);
  }
  if constexpr (kLocal) {
#pragma unroll
    for (int e = 0; e < C; ++e) {
      acc_i[e] += gi[e];
      if constexpr (BOTH) acc_j[e] += gj[e];
    }
  }
}

// target ti against `count` staged rows, every ordered pair; self_k: the
// row of the target's own index (-1, or out of range, for none)
template <int OP, bool WALL, typename T>
__device__ __forceinline__ void directed_tile(
    const T (*s_src)[Traits<OP>::kRow], int count, const Blob<T>& ti,
    int self_k, T* acc) {
#pragma unroll 4
  for (int kk = 0; kk < count; ++kk) {
    const Blob<T> sj = read_row<OP>(s_src[kk]);
    pair<OP, WALL, false>(ti, sj, kk == self_k, acc,
                          static_cast<T*>(nullptr));
  }
}

// Off the diagonal of the symmetric sweep: every lane of the warp reads the
// same staged source, adds its target's terms into acc and forms the
// source's share from its target. A binary counter over a batch of B =
// 2^L sources merges those shares as they come: merging level l (lane
// mask 16 >> l) pairs the pending sum of sources with bit l clear and the
// new one with it set; the lanes with the mask bit keep the latter and
// send the former, the others the reverse, so each step halves the values
// a lane holds with one shuffle. After L levels lane l holds source src
// (bit m of src = lane bit 4 - m) summed over the lanes that share its
// upper L bits, and a butterfly over the lower 5 - L bits completes the
// warp's sum, which the lanes with those bits 0 write to sums[source].
// Rows past the tile's count are padding (zero coefficients).
template <int OP, bool WALL, typename T>
__device__ __forceinline__ void sweep_broadcast(
    const T (*s_src)[Traits<OP>::kRow], int count, const Blob<T>& ti,
    T* acc, T (*sums)[Traits<OP>::kOut], int lane) {
  constexpr int C = Traits<OP>::kOut;
  constexpr int L = Traits<OP>::kLevels;
  constexpr int B = 1 << L;
  constexpr int G = kLanes >> L;  // lanes sharing one source's sum
  int src = 0;
#pragma unroll
  for (int m = 0; m < L; ++m) src |= ((lane >> (4 - m)) & 1) << m;
#pragma unroll 1
  for (int kb = 0; kb < count; kb += B) {
    T pend[L][C];
    T val[C];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const Blob<T> sj = read_row<OP>(s_src[kb + k]);
#pragma unroll
      for (int c = 0; c < C; ++c) val[c] = T(0);
      pair<OP, WALL, true>(ti, sj, false, acc, val);
      bool carry = true;
#pragma unroll
      for (int m = 0; m < L; ++m) {
        if (!carry) break;
        if ((k >> m) & 1) {
          const int mask = 16 >> m;
          const bool hi = (lane & mask) != 0;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const T send = hi ? pend[m][c] : val[c];
            const T keep = hi ? val[c] : pend[m][c];
            val[c] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
          }
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) pend[m][c] = val[c];
          carry = false;
        }
      }
    }
#pragma unroll
    for (int mask = 1; mask < G; mask <<= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        val[c] += __shfl_xor_sync(0xffffffffu, val[c], mask);
    }
    if ((lane & (G - 1)) == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) sums[kb + src][c] = val[c];
    }
  }
}

// The symmetric sweep: block p takes the group pair (GA, GB) =
// pairk::group_pair(p) and owns slice GB of the rows of group GA (target
// side) and slice GA of the rows of group GB (source side) of ws (G, n,
// C); it zeroes them and adds each tile pair's sums in sweep order, every
// row by the thread of its position in the tile.
template <typename T, int OP, bool WALL>
__global__ void __launch_bounds__(kTile, (pairk::Shape<T>::kMinBlocks))
    l1_sym(const T* __restrict__ r, const T* __restrict__ nrm,
           const T* __restrict__ c, const T* __restrict__ w,
           const T* __restrict__ k, const T* __restrict__ q, T dc, int n,
           int n_groups, int tiles_per_group, double* __restrict__ ws) {
  constexpr int C = Traits<OP>::kOut;
  __shared__ __align__(16) T s_src[kTile][Traits<OP>::kRow];
  __shared__ T s_sum[kWarps][kTile][C];

  int ga, gb;
  pairk::group_pair(blockIdx.x, n_groups, ga, gb);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int a_begin = ga * tiles_per_group;
  const int a_end = min(n_tiles, a_begin + tiles_per_group);
  const int b_begin = gb * tiles_per_group;
  const int b_end = min(n_tiles, b_begin + tiles_per_group);
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  double* ws_a = ws + (size_t)gb * n * C;  // target-side sums of group GA
  double* ws_b = ws + (size_t)ga * n * C;  // source-side sums of group GB
#pragma unroll 1
  for (int t = 0; t < tiles_per_group; ++t) {
    const int ra = (a_begin + t) * kTile + threadIdx.x;
    const int rb = (b_begin + t) * kTile + threadIdx.x;
#pragma unroll
    for (int e = 0; e < C; ++e) {
      if (ra < n) ws_a[(size_t)ra * C + e] = 0.0;
      if (rb < n) ws_b[(size_t)rb * C + e] = 0.0;
    }
  }

#pragma unroll 1
  for (int ta = a_begin; ta < a_end; ++ta) {
    const int i = ta * kTile + threadIdx.x;
    const Blob<T> ti = blob<OP>(r, nrm, c, w, k, q, dc, i, n);
    double run[C];
#pragma unroll
    for (int e = 0; e < C; ++e) run[e] = 0.0;
#pragma unroll 1
    for (int tb = ga == gb ? ta : b_begin; tb < b_end; ++tb) {
      const int row = tb * kTile + threadIdx.x;
      const int count = min(kTile, n - tb * kTile);
      __syncthreads();  // s_src and s_sum may still be read
      store_row<OP>(blob<OP>(r, nrm, c, w, k, q, dc, row, n),
                    s_src[threadIdx.x]);
      __syncthreads();
      T acc[C];
#pragma unroll
      for (int e = 0; e < C; ++e) acc[e] = T(0);
      if (tb == ta) {  // the diagonal tile: every ordered pair
        directed_tile<OP, WALL>(s_src, count, ti, -1, acc);
      } else {
        sweep_broadcast<OP, WALL>(s_src, count, ti, acc, s_sum[warp], lane);
        __syncthreads();
        if (row < n) {
#pragma unroll
          for (int e = 0; e < C; ++e) {
            double s = s_sum[0][threadIdx.x][e];
#pragma unroll
            for (int v = 1; v < kWarps; ++v) s += s_sum[v][threadIdx.x][e];
            ws_b[(size_t)row * C + e] += s;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < C; ++e) run[e] += static_cast<double>(acc[e]);
    }
    if (i < n) {
#pragma unroll
      for (int e = 0; e < C; ++e) ws_a[(size_t)i * C + e] += run[e];
    }
  }
}

// The directed sweep, each block 128 targets x one source slice: src,
// nrm (Ns, 3); tgt (Nt, 3); c, w, k, q (Ns,); ws (S, Nt, C).
template <typename T, int OP, bool WALL, bool SELF>
__global__ void __launch_bounds__(kTile, (pairk::Shape<T>::kMinBlocks))
    l1_directed(const T* __restrict__ src, const T* __restrict__ tgt,
                const T* __restrict__ nrm, const T* __restrict__ c,
                const T* __restrict__ w, const T* __restrict__ k,
                const T* __restrict__ q, T dc, int ns, int nt,
                int tiles_per_slice, double* __restrict__ ws) {
  constexpr int C = Traits<OP>::kOut;
  __shared__ __align__(16) T s_src[kTile][Traits<OP>::kRow];

  const int i = blockIdx.x * kTile + threadIdx.x;
  const int slice = blockIdx.y;
  const int n_tiles = (ns + kTile - 1) / kTile;
  const int t_begin = slice * tiles_per_slice;
  const int t_end = min(n_tiles, t_begin + tiles_per_slice);
  Blob<T> ti{T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  if (i < nt) {
    ti.x = tgt[3 * i + 0];
    ti.y = tgt[3 * i + 1];
    ti.z = tgt[3 * i + 2];
  }
  double run[C];
#pragma unroll
  for (int e = 0; e < C; ++e) run[e] = 0.0;

#pragma unroll 1
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int j0 = tile * kTile;
    __syncthreads();  // the previous tile may still be read
    store_row<OP>(blob<OP>(src, nrm, c, w, k, q, dc, j0 + threadIdx.x, ns),
                  s_src[threadIdx.x]);
    __syncthreads();
    T acc[C];
#pragma unroll
    for (int e = 0; e < C; ++e) acc[e] = T(0);
    directed_tile<OP, WALL>(s_src, min(kTile, ns - j0), ti,
                            SELF ? i - j0 : -1, acc);
#pragma unroll
    for (int e = 0; e < C; ++e) run[e] += static_cast<double>(acc[e]);
  }
  if (i < nt) {
    double* out = ws + ((size_t)slice * nt + i) * C;
#pragma unroll
    for (int e = 0; e < C; ++e) out[e] = run[e];
  }
}

// out (Nt, C) = scale * sum_s ws[s] in slice order, plus c_i / 2 for the
// BVP operator
template <typename T>
__global__ void reduce_kernel(const double* __restrict__ ws, int slices,
                              int n, double scale, const T* __restrict__ half,
                              T* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  double s = 0.0;
  for (int sl = 0; sl < slices; ++sl) s += ws[(size_t)sl * n + e];
  T v = static_cast<T>(scale * s);
  if (half != nullptr) v = T(0.5) * half[e] + v;
  out[e] = v;
}

template <typename T, int OP>
int reduce(const double* ws, int slices, int nt, const T* c, T* out,
           cudaStream_t st) {
  const int n = nt * Traits<OP>::kOut;
  // 1/(4 pi); the surface gradient's two layers enter twice
  const double scale = (OP == kGrad ? 0.5 : 0.25) / 3.14159265358979323846;
  reduce_kernel<T><<<(n + 255) / 256, 256, 0, st>>>(
      ws, slices, n, scale, OP == kBvp ? c : nullptr, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int OP, bool WALL, bool SELF>
int launch_directed(const T* src, const T* tgt, const T* nrm, const T* c,
                    const T* w, const T* k, const T* q, double dc, int ns,
                    int nt, int slices, int tiles_per_slice, double* ws,
                    T* out, cudaStream_t st) {
  dim3 grid((nt + kTile - 1) / kTile, slices);
  l1_directed<T, OP, WALL, SELF><<<grid, kTile, 0, st>>>(
      src, tgt, nrm, c, w, k, q, static_cast<T>(dc), ns, nt,
      tiles_per_slice, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce<T, OP>(ws, slices, nt, c, out, st);
}

template <typename T, int OP, bool WALL>
int launch_sym(const T* r, const T* nrm, const T* c, const T* w, const T* k,
               const T* q, double dc, int n, int n_groups, int tiles_per_group,
               double* ws, T* out, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((long long)n_groups * (n_groups + 1) / 2);
  l1_sym<T, OP, WALL><<<blocks, kTile, 0, st>>>(
      r, nrm, c, w, k, q, static_cast<T>(dc), n, n_groups, tiles_per_group,
      ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce<T, OP>(ws, n_groups, n, c, out, st);
}

#define L1_OPS(CASE) \
  CASE(kS)           \
  CASE(kD)           \
  CASE(kDD)          \
  CASE(kT)           \
  CASE(kBvp)         \
  CASE(kGrad)

template <typename T>
int dispatch_directed(int op, int wall, int self, const T* src, const T* tgt,
                      const T* nrm, const T* c, const T* w, const T* k,
                      const T* q, double dc, int ns, int nt, int slices,
                      int tiles_per_slice, double* ws, T* out, void* stream) {
  if (nt <= 0 || ns <= 0 || slices <= 0 || slices > 65535 ||
      tiles_per_slice <= 0 ||
      (long long)slices * tiles_per_slice * kTile < ns)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define L1_CASE(OP, W, S)                                                     \
  if (op == OP && (wall != 0) == W && (self != 0) == S)                       \
    return launch_directed<T, OP, W, S>(src, tgt, nrm, c, w, k, q, dc, ns,    \
                                        nt, slices, tiles_per_slice, ws, out, \
                                        st);
#define L1_OP(OP)           \
  L1_CASE(OP, false, false) \
  L1_CASE(OP, false, true)  \
  L1_CASE(OP, true, false)  \
  L1_CASE(OP, true, true)
  L1_OPS(L1_OP)
#undef L1_OP
#undef L1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_sym(int op, int wall, const T* r, const T* nrm, const T* c,
                 const T* w, const T* k, const T* q, double dc, int n,
                 int n_groups, int tiles_per_group, double* ws, T* out,
                 void* stream) {
  if (n <= 0 || n_groups <= 0 || tiles_per_group <= 0 ||
      (long long)n_groups * tiles_per_group * kTile < n ||
      (long long)n_groups * (n_groups + 1) / 2 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define L1_CASE(OP, W)                                                    \
  if (op == OP && (wall != 0) == W)                                       \
    return launch_sym<T, OP, W>(r, nrm, c, w, k, q, dc, n, n_groups,      \
                                tiles_per_group, ws, out, st);
#define L1_OP(OP)     \
  L1_CASE(OP, false)  \
  L1_CASE(OP, true)
  L1_OPS(L1_OP)
#undef L1_OP
#undef L1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The directed sweep. op: 0 S, 1 D, 2 dD, 3 T, 4 bvp, 5 grad
// (ops/laplace.py OPS); wall, self: the images and the self mask, 0 or 1.
// src, nrm (ns, 3), tgt (nt, 3); c, w (ns,) the field and the weights; k,
// q (ns,) the reaction and emission rates (bvp and grad; bvp's targets are
// its sources, c_i / 2 read from c); dc the diffusion coefficient Dc;
// slices x tiles_per_slice 128-source tiles covering ns (ops/laplace.py
// plan_slices); ws (slices, nt, C) float64; out (nt, C), C = 3 for dD, T
// and grad, else 1; all contiguous on the device. Returns the CUDA error
// code of the launches (0 on success).
#define L1_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(int op, int wall, int self, const T* src,              \
                      const T* tgt, const T* nrm, const T* c, const T* w,    \
                      const T* k, const T* q, double dc, int ns, int nt,     \
                      int slices, int tiles_per_slice, double* ws, T* out,   \
                      void* stream) {                                        \
    return dispatch_directed<T>(op, wall, self, src, tgt, nrm, c, w, k, q,   \
                                dc, ns, nt, slices, tiles_per_slice, ws,     \
                                out, stream);                                \
  }

L1_ENTRY(laplace_layers_f32, float)
L1_ENTRY(laplace_layers_f64, double)

// The symmetric sweep over the blobs r (n, 3) as targets and sources (the
// self mask is implied: i == j is a zero distance). n_groups x
// tiles_per_group 128-blob tiles covering n (ops/pair_kernels.py
// plan_groups); ws (n_groups, n, C) float64; the other arguments as above.
#define L1_SYM_ENTRY(NAME, T)                                                \
  extern "C" int NAME(int op, int wall, const T* r, const T* nrm,            \
                      const T* c, const T* w, const T* k, const T* q,        \
                      double dc, int n, int n_groups, int tiles_per_group,   \
                      double* ws, T* out, void* stream) {                    \
    return dispatch_sym<T>(op, wall, r, nrm, c, w, k, q, dc, n, n_groups,    \
                           tiles_per_group, ws, out, stream);                \
  }

L1_SYM_ENTRY(laplace_layers_sym_f32, float)
L1_SYM_ENTRY(laplace_layers_sym_f64, double)
