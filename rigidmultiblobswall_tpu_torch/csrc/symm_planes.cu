// Kernel K4: u = M v for the materialized tt mobility M (3N, 3N) of
// kernel K3, reading only its upper-triangle tiles: by reciprocity
// M[3i+a, 3j+b] = M[3j+b, 3i+a], so a tile (I, J) with J > I serves both
// its own rows (u_I += M_IJ v_J) and, transposed, the rows of tile J
// (u_J += M_IJ^T v_I). Diagonal tiles are read whole and serve their rows.
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/
// mobility_pallas.py (_symm_kernel; wrapper symm_planes_matvec). That
// kernel adds every tile's two contributions into one VMEM-resident output,
// which is race-free only because the TPU grid runs in order. A GPU grid
// does not, and float atomics would make the sums depend on the schedule.
// So the first pass writes each contribution into its own slot of a
// partials buffer, partials[K][S][r] for output tile K and contributing
// tile S (the row part of tile (K, S) for S >= K, the transposed part of
// tile (S, K) for S < K: every slot written exactly once), and the second
// pass sums each output row's nT slots in a fixed order. The result is
// deterministic, and an f32 row sum is a sum of nT partial sums of 192
// terms each. B = 2 right-hand sides (the lockstep solves' stacked
// products) share one read of the matrix.
//
// What bounds it on the H100: the bytes read, about half the matrix (2.7 GB
// in float32 at 12,288 blobs, ~0.8 ms at 3.35 TB/s); two FMAs per element.
// Design: tiles of 64 blobs (192 x 192 values), one block of 8 warps per
// upper tile on a (J, I) grid whose lower blocks exit at once. A warp takes
// every 8th row of the tile; each lane holds 6 columns (lane + 32 k), so a
// row is read as 6 coalesced 32-value loads. Row sums are reduced across
// the warp by a fixed xor-shuffle tree; column sums stay in registers and
// are combined across warps through shared memory in warp order.

#include <cuda_runtime.h>

namespace {

constexpr int kBlobs = 64;               // tile edge in blobs (SYMM_TILE)
constexpr int kRows = 3 * kBlobs;        // 192 values
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = kRows / 32;     // 6 columns per lane

// part[((K n_tiles + S) B + b) kRows + r]: slot S of output tile K, rhs b
template <typename T, int B>
__device__ __forceinline__ T* slot(T* part, int K, int S, int b,
                                   int n_tiles) {
  return part + ((static_cast<size_t>(K) * n_tiles + S) * B + b) * kRows;
}

// v (B, n3) and the partials as above
template <typename T, int B>
__global__ void __launch_bounds__(kThreads)
symm_tiles(const T* __restrict__ m, const T* __restrict__ v,
           T* __restrict__ part, int n3, int n_tiles) {
  const int I = blockIdx.y;
  const int J = blockIdx.x;
  if (J < I) return;                     // strictly-lower tiles: never read
  __shared__ T s_vi[B][kRows];
  __shared__ T s_col[kWarps][kRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = I * kRows;
  const int c0 = J * kRows;
  for (int k = threadIdx.x; k < B * kRows; k += kThreads) {
    const int b = k / kRows, rr = k % kRows;
    s_vi[b][rr] = (r0 + rr < n3) ? v[static_cast<size_t>(b) * n3 + r0 + rr]
                                 : T(0);
  }
  T vj[B][kPerLane], col[B][kPerLane];
  bool live[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int c = c0 + lane + 32 * q;
    live[q] = c < n3;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      vj[b][q] = live[q] ? v[static_cast<size_t>(b) * n3 + c] : T(0);
      col[b][q] = T(0);
    }
  }
  __syncthreads();

  const int rows = min(kRows, n3 - r0);
#pragma unroll 4
  for (int rr = warp; rr < rows; rr += kWarps) {
    const T* mrow = m + static_cast<size_t>(r0 + rr) * n3 + c0;
    T s[B];
#pragma unroll
    for (int b = 0; b < B; ++b) s[b] = T(0);
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const T x = live[q] ? mrow[lane + 32 * q] : T(0);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        s[b] += x * vj[b][q];
        col[b][q] += x * s_vi[b][rr];
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[b] += __shfl_xor_sync(0xffffffffu, s[b], off);
      if (lane == 0) slot<T, B>(part, I, J, b, n_tiles)[rr] = s[b];
    }
  }

  if (I != J) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      __syncthreads();                   // s_col free again
#pragma unroll
      for (int q = 0; q < kPerLane; ++q)
        s_col[warp][lane + 32 * q] = col[b][q];
      __syncthreads();
      T* col_part = slot<T, B>(part, J, I, b, n_tiles);
      for (int c = threadIdx.x; c < kRows; c += kThreads) {
        T t = T(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) t += s_col[w][c];
        col_part[c] = t;
      }
    }
  }
}

// out[b][K kRows + r] = sum over S of the slots, S in order
template <typename T, int B>
__global__ void __launch_bounds__(kRows)
symm_reduce(const T* __restrict__ part, T* __restrict__ out, int n3,
            int n_tiles) {
  const int K = blockIdx.x;
  const int b = blockIdx.y;
  const int r = threadIdx.x;
  const int idx = K * kRows + r;
  if (idx >= n3) return;
  T acc = T(0);
  for (int s = 0; s < n_tiles; ++s)
    acc += slot<const T, B>(part, K, s, b, n_tiles)[r];
  out[static_cast<size_t>(b) * n3 + idx] = acc;
}

template <typename T, int B>
int launch_b(const T* m, const T* v, T* part, T* out, int n3,
             cudaStream_t s) {
  const int n_tiles = (n3 + kRows - 1) / kRows;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  symm_tiles<T, B><<<dim3(n_tiles, n_tiles), kThreads, 0, s>>>(m, v, part,
                                                               n3, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  symm_reduce<T, B><<<dim3(n_tiles, B), kRows, 0, s>>>(part, out, n3,
                                                       n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* m, const T* v, T* part, T* out, int n3, int n_rhs,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rhs == 1) return launch_b<T, 1>(m, v, part, out, n3, s);
  if (n_rhs == 2) return launch_b<T, 2>(m, v, part, out, n3, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// m (n3,n3) row-major, v (n_rhs, n3), part (nT, nT, n_rhs, 192) scratch
// with nT = ceil(n3 / 192), out (n_rhs, n3); all contiguous on the device,
// n3 > 0 and a multiple of 3, n_rhs 1 or 2. Returns the CUDA error code of
// the launches.
extern "C" int symm_matvec_f32(const float* m, const float* v, float* part,
                               float* out, int n3, int n_rhs, void* stream) {
  return launch<float>(m, v, part, out, n3, n_rhs, stream);
}

extern "C" int symm_matvec_f64(const double* m, const double* v,
                               double* part, double* out, int n3, int n_rhs,
                               void* stream) {
  return launch<double>(m, v, part, out, n3, n_rhs, stream);
}
