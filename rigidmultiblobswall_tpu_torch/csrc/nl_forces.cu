// Kernel K5: linked-cell soft blob-blob repulsion in a periodic box,
//   F_i = sum_j mag(r_ij) (r_i - r_j^image)  over the 27-cell stencil,
//   mag = eps/b exp((2a - r)/b) / r  for r > 2a,   eps/(b r) otherwise,
// skipping r^2 == 0 (the particle itself and coincident blobs). There is
// no cutoff test: the sum runs over the whole stencil, as both JAX paths
// do (a test at the cutoff would drop exp(-12)-sized tails).
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/forces.py
// (_nl_force_kernel; wrapper _neighbor_forces_pallas), periodic box only
// (its wall-slab z_clip branch waits for the wall spectral engine).
//
// What bounds it on the H100: the special functions and FP32 instruction
// throughput. Every candidate pair costs ~10 flops, one rsqrt and, beyond
// 2a, one exp; the bytes (positions once, the table, the output) are a
// few MB. The 27-cell walk, staging and reduction are in cell_sweep.cuh.

#include "cell_sweep.cuh"

namespace {

using cellk::Grid;

template <typename T>
struct Repulsion {
  T eps_over_b, inv_b, two_a;

  template <typename V>
  __device__ __forceinline__ void operator()(T dx, T dy, T dz, V, int,
                                             T* acc) const {
    const T r2 = dx * dx + dy * dy + dz * dz;
    if (r2 == T(0)) return;
    const T invr = cellk::rsqrt_t(r2);
    const T r = r2 * invr;
    T mag = eps_over_b * invr;
    if (r > two_a) mag *= cellk::exp_t((two_a - r) * inv_b);
    acc[0] += mag * dx;
    acc[1] += mag * dy;
    acc[2] += mag * dz;
  }
};

template <typename T>
__global__ void __launch_bounds__(cellk::kThreads)
nl_forces_kernel(const T* __restrict__ pos, const int* __restrict__ table,
                 T* __restrict__ out, Grid g, double Lx, double Ly,
                 double Lz, Repulsion<T> op) {
  __shared__ cellk::Stencil st;
  cellk::load_stencil(st, table, blockIdx.x, g, Lx, Ly, Lz);
  cellk::cell_sweep<T, 0, 3>(st, table, pos, static_cast<const T*>(nullptr),
                             out, g, op);
}

template <typename T>
int launch(const T* pos, const int* table, T* out, int n, int nx, int ny,
           int nz, int cap, double Lx, double Ly, double Lz,
           double eps_over_b, double inv_b, double two_a, void* stream) {
  const Grid g{n, nx, ny, nz, cap};
  const Repulsion<T> op{T(eps_over_b), T(inv_b), T(two_a)};
  nl_forces_kernel<T><<<nx * ny * nz, cellk::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pos, table, out, g, Lx, Ly, Lz, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos (n,3) wrapped into the box, table (nx ny nz cap,) int32 from
// ops/cells.cell_bin, out (n,3) zeroed by the caller (dropped particles
// keep their zero row); all contiguous on the device. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int nl_forces_f32(const float* pos, const int* table, float* out,
                             int n, int nx, int ny, int nz, int cap,
                             double Lx, double Ly, double Lz,
                             double eps_over_b, double inv_b, double two_a,
                             void* stream) {
  return launch<float>(pos, table, out, n, nx, ny, nz, cap, Lx, Ly, Lz,
                       eps_over_b, inv_b, two_a, stream);
}

extern "C" int nl_forces_f64(const double* pos, const int* table,
                             double* out, int n, int nx, int ny, int nz,
                             int cap, double Lx, double Ly, double Lz,
                             double eps_over_b, double inv_b, double two_a,
                             void* stream) {
  return launch<double>(pos, table, out, n, nx, ny, nz, cap, Lx, Ly, Lz,
                        eps_over_b, inv_b, two_a, stream);
}
