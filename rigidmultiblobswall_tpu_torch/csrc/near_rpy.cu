// Kernel K6: the near-field RPY remainder of the periodic spectral Ewald
// engine (ops/ewald.py) for B = 1 or 2 stacked right-hand sides,
//   u_i = sum_j alpha(r) f_j + (beta(r) / r^2) (d . f_j) d
// over the 27-cell stencil, for the pairs with 0 < r^2 < r_cut^2
// (d = r_i - r_j^image). alpha and beta come from a two-piece Chebyshev
// series: piece 0 on r < 2a, piece 1 on 2a <= r < r_cut, t = (r - mid) /
// half in [-1, 1], one Clenshaw recurrence per function with the pair's
// piece coefficients, shared across the B right-hand sides. The self term
// is the caller's (ops/ewald.real_matvec).
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/ewald.py
// (_near_kernel; wrapper _near_rows_pallas).
//
// What bounds it on the H100: FP32 instruction throughput. A candidate
// pair costs ~10 flops for the distance test; the ~15 % of pairs inside
// r_cut cost one rsqrt and ~6 K + 20 B flops (K <= 32 Chebyshev terms,
// 24 at bench.py's tolerance 1e-4); the bytes are a few MB. The
// coefficients (2 x 2 x K) sit in shared memory, loaded once per block.
// The 27-cell walk, staging and reduction are in cell_sweep.cuh.

#include "cell_sweep.cuh"

namespace {

using cellk::Grid;

constexpr int kMaxCheb = 32;

template <typename T, int B>
struct NearRpy {
  const T* cheb;   // shared: [piece][function][k], K terms
  int K;
  T rc2, two_a, mid0, inv_h0, mid1, inv_h1;

  template <typename V>
  __device__ __forceinline__ void operator()(T dx, T dy, T dz, V sv, int j,
                                             T* acc) const {
    const T r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 > T(0) && r2 < rc2)) return;
    const T invr = cellk::rsqrt_t(r2);
    const T r = r2 * invr;
    const bool near = r < two_a;
    const T* ca = cheb + (near ? 0 : 2 * K);
    const T* cb = ca + K;
    const T ts = near ? (r - mid0) * inv_h0 : (r - mid1) * inv_h1;
    const T t2 = ts + ts;
    T a1 = T(0), a2 = T(0), b1 = T(0), b2 = T(0);
    for (int k = K - 1; k > 0; --k) {
      const T an = t2 * a1 - a2 + ca[k];
      const T bn = t2 * b1 - b2 + cb[k];
      a2 = a1;
      a1 = an;
      b2 = b1;
      b1 = bn;
    }
    const T al = ts * a1 - a2 + ca[0];
    const T be = ts * b1 - b2 + cb[0];
    const T bfac = be * invr * invr;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const T fx = sv[3 * b + 0][j];
      const T fy = sv[3 * b + 1][j];
      const T fz = sv[3 * b + 2][j];
      const T g = bfac * (dx * fx + dy * fy + dz * fz);
      acc[3 * b + 0] += al * fx + g * dx;
      acc[3 * b + 1] += al * fy + g * dy;
      acc[3 * b + 2] += al * fz + g * dz;
    }
  }
};

template <typename T, int B>
__global__ void __launch_bounds__(cellk::kThreads)
near_rpy_kernel(const T* __restrict__ pos, const T* __restrict__ f,
                const int* __restrict__ table, const T* __restrict__ cheb,
                T* __restrict__ out, Grid g, double Lx, double Ly,
                double Lz, NearRpy<T, B> params) {
  __shared__ cellk::Stencil st;
  __shared__ T s_cheb[4 * kMaxCheb];
  for (int i = threadIdx.x; i < 4 * params.K; i += blockDim.x)
    s_cheb[i] = cheb[i];
  cellk::load_stencil(st, table, blockIdx.x, g, Lx, Ly, Lz);  // has barriers
  NearRpy<T, B> op = params;
  op.cheb = s_cheb;
  cellk::cell_sweep<T, 3 * B, 3 * B>(st, table, pos, f, out, g, op);
}

template <typename T, int B>
int launch(const T* pos, const T* f, const int* table, const T* cheb,
           T* out, int n, int nx, int ny, int nz, int cap, int K, double Lx,
           double Ly, double Lz, double two_a, double r_cut, void* stream) {
  if (K < 1 || K > kMaxCheb) return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{n, nx, ny, nz, cap};
  // piece 0: mid = half = a; piece 1: mid = (2a + r_cut) / 2,
  // half = (r_cut - 2a) / 2
  const double mid0 = 0.5 * two_a, mid1 = 0.5 * (two_a + r_cut);
  const double half0 = 0.5 * two_a, half1 = 0.5 * (r_cut - two_a);
  const NearRpy<T, B> op{nullptr, K, T(r_cut * r_cut), T(two_a), T(mid0),
                         T(1.0 / half0), T(mid1), T(1.0 / half1)};
  near_rpy_kernel<T, B><<<nx * ny * nz, cellk::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      pos, f, table, cheb, out, g, Lx, Ly, Lz, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos (n,3) plan positions, f (n,3B) b-major columns, table (nx ny nz cap,)
// int32 from ops/cells.cell_bin, cheb (2,2,K) the piecewise coefficients,
// out (n,3B) zeroed by the caller (dropped particles keep their zero row);
// all contiguous on the device. Returns the CUDA error code of the launch.
#define NEAR_ENTRY(NAME, T, B)                                               \
  extern "C" int NAME(const T* pos, const T* f, const int* table,           \
                      const T* cheb, T* out, int n, int nx, int ny, int nz, \
                      int cap, int K, double Lx, double Ly, double Lz,      \
                      double two_a, double r_cut, void* stream) {           \
    return launch<T, B>(pos, f, table, cheb, out, n, nx, ny, nz, cap, K, Lx, \
                        Ly, Lz, two_a, r_cut, stream);                      \
  }

NEAR_ENTRY(near_rpy_f32_b1, float, 1)
NEAR_ENTRY(near_rpy_f32_b2, float, 2)
NEAR_ENTRY(near_rpy_f64_b1, double, 1)
NEAR_ENTRY(near_rpy_f64_b2, double, 2)
