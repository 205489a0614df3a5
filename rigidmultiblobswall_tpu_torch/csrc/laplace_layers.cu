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
// What bounds it on the H100: the special-function unit. A pair needs one
// rsqrt for the real source and one for its image (MUFU.RSQ, 16 a clock an
// SM against 128 float32 operations), beside 10-40 float32 operations;
// bytes are 16-32 a source and 4-12 a target.
//
// Design (simple first): one target a thread, 128 targets a block; the
// sources split into S slices of whole 128-source tiles (ops/laplace.py
// plan_slices) so that the grid fills the 132 SMs; a block stages each
// tile's positions, normals and the two source coefficients of its
// operator in shared memory (every thread reads the same source: a
// broadcast) and sums the tile in registers, float32 in the float32
// instances, then adds the tile's sum into a float64 running sum. Each
// block writes its slice's sums (float64) into the workspace (S, Nt, C),
// and reduce_kernel adds the slices in order and scales: no atomics, so a
// launch is bit-identical on repeat. Masked pairs take 1/r = 0, which
// zeroes every term of the real source without a branch.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // targets a block, sources a staged tile

enum Op { kS = 0, kD = 1, kDD = 2, kT = 3, kBvp = 4, kGrad = 5 };

template <int OP>
struct Traits {
  static constexpr int kOut = (OP == kDD || OP == kT || OP == kGrad) ? 3 : 1;
  static constexpr bool kNormals =
      OP == kD || OP == kDD || OP == kBvp || OP == kGrad;
  static constexpr bool kTwo = OP == kBvp || OP == kGrad;
};

__device__ __forceinline__ float inv_sqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double inv_sqrt(double x) { return rsqrt(x); }

// one source's terms at displacement (dx, dy, dz) with inv = 1/r (0 for a
// masked pair) and the normal (nx, ny, nz); a and b its coefficients
template <int OP, typename T>
__device__ __forceinline__ void add_terms(T dx, T dy, T dz, T inv, T inv_s,
                                          T nx, T ny, T nz, T a, T b,
                                          T* acc) {
  if constexpr (OP == kS) {
    acc[0] += a * inv_s;
  } else if constexpr (OP == kD || OP == kBvp) {
    const T inv3 = inv * inv * inv;
    const T rn = dx * nx + dy * ny + dz * nz;
    if constexpr (OP == kD) {
      acc[0] += a * rn * inv3;
    } else {
      acc[0] += b * inv_s - a * rn * inv3;
    }
  } else if constexpr (OP == kT) {
    const T s = a * (inv * inv * inv);
    acc[0] += s * dx;
    acc[1] += s * dy;
    acc[2] += s * dz;
  } else {  // kDD, kGrad
    const T inv2 = inv * inv;
    const T inv3 = inv2 * inv;
    const T fo = T(-3) * inv2;
    const T lxx = (T(1) + fo * dx * dx) * inv3;
    const T lxy = (fo * dx * dy) * inv3;
    const T lxz = (fo * dx * dz) * inv3;
    const T lyy = (T(1) + fo * dy * dy) * inv3;
    const T lyz = (fo * dy * dz) * inv3;
    const T lzz = -lxx - lyy;
    T gx = lxx * nx + lxy * ny + lxz * nz;
    T gy = lxy * nx + lyy * ny + lyz * nz;
    T gz = lxz * nx + lyz * ny + lzz * nz;
    if constexpr (OP == kGrad) {
      const T t = b * inv3;
      gx = a * gx - t * dx;
      gy = a * gy - t * dy;
      gz = a * gz - t * dz;
      acc[0] += gx;
      acc[1] += gy;
      acc[2] += gz;
    } else {
      acc[0] += a * gx;
      acc[1] += a * gy;
      acc[2] += a * gz;
    }
  }
}

// Each block: 128 targets x one source slice. src, nrm (Ns, 3); tgt
// (Nt, 3); c, w, k, q (Ns,) (k, q: bvp and grad only); ws (S, Nt, C).
template <typename T, int OP, bool WALL, bool SELF>
__global__ void __launch_bounds__(kTile)
    layer_kernel(const T* __restrict__ src, const T* __restrict__ tgt,
                 const T* __restrict__ nrm, const T* __restrict__ c,
                 const T* __restrict__ w, const T* __restrict__ k,
                 const T* __restrict__ q, T dc, int ns, int nt,
                 int tiles_per_slice, double* __restrict__ ws) {
  constexpr int C = Traits<OP>::kOut;
  constexpr bool N = Traits<OP>::kNormals;
  __shared__ T s_x[kTile], s_y[kTile], s_z[kTile];
  __shared__ T s_nx[N ? kTile : 1], s_ny[N ? kTile : 1], s_nz[N ? kTile : 1];
  __shared__ T s_a[kTile], s_b[Traits<OP>::kTwo ? kTile : 1];

  const int i = blockIdx.x * kTile + threadIdx.x;
  const int slice = blockIdx.y;
  const int n_tiles = (ns + kTile - 1) / kTile;
  const int t_begin = slice * tiles_per_slice;
  const int t_end = min(n_tiles, t_begin + tiles_per_slice);
  T xi = T(0), yi = T(0), zi = T(0);
  if (i < nt) {
    xi = tgt[3 * i + 0];
    yi = tgt[3 * i + 1];
    zi = tgt[3 * i + 2];
  }
  double run[C];
#pragma unroll
  for (int a = 0; a < C; ++a) run[a] = 0.0;

#pragma unroll 1
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int j0 = tile * kTile;
    const int m = min(kTile, ns - j0);
    __syncthreads();  // the previous tile may still be read
    if (threadIdx.x < m) {
      const int j = j0 + threadIdx.x;
      s_x[threadIdx.x] = src[3 * j + 0];
      s_y[threadIdx.x] = src[3 * j + 1];
      s_z[threadIdx.x] = src[3 * j + 2];
      if constexpr (N) {
        s_nx[threadIdx.x] = nrm[3 * j + 0];
        s_ny[threadIdx.x] = nrm[3 * j + 1];
        s_nz[threadIdx.x] = nrm[3 * j + 2];
      }
      const T cj = c[j], wj = w[j];
      s_a[threadIdx.x] = cj * wj;
      if constexpr (OP == kBvp) s_b[threadIdx.x] = (k[j] * cj / dc) * wj;
      if constexpr (OP == kGrad) {
        s_b[threadIdx.x] = ((q[j] - k[j] * cj) / dc) * wj;
      }
    }
    __syncthreads();
    T acc[C];
#pragma unroll
    for (int a = 0; a < C; ++a) acc[a] = T(0);
#pragma unroll 4
    for (int jj = 0; jj < m; ++jj) {
      const T dx = xi - s_x[jj];
      const T dy = yi - s_y[jj];
      const T dz = zi - s_z[jj];
      const T d2 = dx * dx + dy * dy + dz * dz;
      const bool skip = d2 == T(0) || (SELF && i == j0 + jj);
      const T inv = skip ? T(0) : inv_sqrt(d2);
      T nx = T(0), ny = T(0), nz = T(0), b = T(0);
      if constexpr (N) {
        nx = s_nx[jj];
        ny = s_ny[jj];
        nz = s_nz[jj];
      }
      if constexpr (Traits<OP>::kTwo) b = s_b[jj];
      const T a = s_a[jj];
      add_terms<OP, T>(dx, dy, dz, inv, inv, nx, ny, nz, a, b, acc);
      if constexpr (WALL) {
        const T rz = zi + s_z[jj];
        const T d2w = dx * dx + dy * dy + rz * rz;
        const bool zero = d2w == T(0);
        const T inv_w = zero ? T(0) : inv_sqrt(d2w);
        // the single layer's image keeps 1/R = 1 at zero image distance
        const T inv_ws = zero ? T(1) : inv_w;
        add_terms<OP, T>(dx, dy, rz, inv_w, inv_ws, nx, ny, -nz, a, b, acc);
      }
    }
#pragma unroll
    for (int a = 0; a < C; ++a) run[a] += static_cast<double>(acc[a]);
  }
  if (i < nt) {
    double* out = ws + ((size_t)slice * nt + i) * C;
#pragma unroll
    for (int a = 0; a < C; ++a) out[a] = run[a];
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

template <typename T, int OP, bool WALL, bool SELF>
int launch(const T* src, const T* tgt, const T* nrm, const T* c, const T* w,
           const T* k, const T* q, double dc, int ns, int nt, int slices,
           int tiles_per_slice, double* ws, T* out, cudaStream_t st) {
  constexpr int C = Traits<OP>::kOut;
  dim3 grid((nt + kTile - 1) / kTile, slices);
  layer_kernel<T, OP, WALL, SELF><<<grid, kTile, 0, st>>>(
      src, tgt, nrm, c, w, k, q, static_cast<T>(dc), ns, nt,
      tiles_per_slice, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = nt * C;
  // 1/(4 pi); the surface gradient's two layers enter twice
  const double scale = (OP == kGrad ? 0.5 : 0.25) / 3.14159265358979323846;
  reduce_kernel<T><<<(n + 255) / 256, 256, 0, st>>>(
      ws, slices, n, scale, OP == kBvp ? c : nullptr, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int op, int wall, int self, const T* src, const T* tgt,
             const T* nrm, const T* c, const T* w, const T* k, const T* q,
             double dc, int ns, int nt, int slices, int tiles_per_slice,
             double* ws, T* out, void* stream) {
  if (nt <= 0 || ns <= 0 || slices <= 0 || tiles_per_slice <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define L1_CASE(OP, W, S)                                                   \
  if (op == OP && (wall != 0) == W && (self != 0) == S)                     \
    return launch<T, OP, W, S>(src, tgt, nrm, c, w, k, q, dc, ns, nt,   \
                               slices, tiles_per_slice, ws, out, st);
#define L1_OP(OP)              \
  L1_CASE(OP, false, false)    \
  L1_CASE(OP, false, true)     \
  L1_CASE(OP, true, false)     \
  L1_CASE(OP, true, true)
  L1_OP(kS)
  L1_OP(kD)
  L1_OP(kDD)
  L1_OP(kT)
  L1_OP(kBvp)
  L1_OP(kGrad)
#undef L1_OP
#undef L1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// op: 0 S, 1 D, 2 dD, 3 T, 4 bvp, 5 grad (ops/laplace.py OPS); wall, self:
// the images and the self mask, 0 or 1. src, nrm (ns, 3), tgt (nt, 3);
// c, w (ns,) the field and the weights; k, q (ns,) the reaction and
// emission rates (bvp and grad; bvp's targets are its sources, c_i / 2
// read from c); dc the diffusion coefficient Dc; slices x tiles_per_slice
// 128-source tiles covering ns (ops/laplace.py plan_slices); ws (slices,
// nt, C) float64; out (nt, C), C = 3 for dD, T and grad, else 1; all
// contiguous on the device. Returns the CUDA error code of the launches
// (0 on success).
#define L1_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(int op, int wall, int self, const T* src,              \
                      const T* tgt, const T* nrm, const T* c, const T* w,    \
                      const T* k, const T* q, double dc, int ns, int nt,     \
                      int slices, int tiles_per_slice, double* ws, T* out,   \
                      void* stream) {                                        \
    return dispatch<T>(op, wall, self, src, tgt, nrm, c, w, k, q, dc,        \
                       ns, nt, slices, tiles_per_slice, ws, out, stream);    \
  }

L1_ENTRY(laplace_layers_f32, float)
L1_ENTRY(laplace_layers_f64, double)
