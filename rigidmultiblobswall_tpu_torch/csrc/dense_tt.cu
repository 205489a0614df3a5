// Kernel K3: materialize the tt mobility of one configuration (RPY core
// plus the Swan-Brady wall terms) as the interleaved (3N, 3N) matrix
// M[3i+a, 3j+b], with the overlap regularization folded in: heights
// shifted to max(z, a), the factor 1/(8 pi eta a) and the damping
// min(z_i/a, 1) min(z_j/a, 1), so the matrix is written once.
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/
// mobility_pallas.py (_dense_kernel; wrapper dense_tt_pallas) together with
// the scaling pass its caller applies (models/saddle.py:130-139). The TPU
// writes (3,3,N,N) component planes to avoid padding a minor length-3 axis;
// the interleaved layout here lets the stacked products run as one matmul.
//
// What bounds it on the H100: the bytes written, 9 N^2 values (5.4 GB in
// float32 at 12,288 blobs, ~1.6 ms at 3.35 TB/s), against ~100 operations
// per pair (~0.2 ms of float32 issue). Design: a block owns a 16-target by
// 32-source tile; it stages the 48 blob coordinates (normalized and shifted
// here) in shared memory, condenses every pair with pair_blocks.cuh's
// make_pair and tt_condense (the arithmetic of kernel K1 tt, without a
// division), expands the 3x3 blocks into
// a 48 x 96 shared tile, and writes that tile row by row: each warp stores
// 32 consecutive values of one matrix row. Ragged edges are masked by
// index; blobs past the end are staged as (0, 0, 1), the padding of
// dense_tt_pallas. The self pair (i == j) and coincident distinct blobs
// take the rules of _core_fields (core 4/3 and 0), the wall terms at the
// self geometry being the wall self-mobility.
//
// The image-box instance (dense_tt_img_*) sums every box of the
// pseudo-periodic list into each 3x3 block (the JAX package's
// ops/mobility.py dense_mobility_tiled with a periodic_length, XLA there):
// the pair geometry of pair_blocks.cuh ImageBoxes (minimum image in the
// home box, then d + b L for each box, the self block in the home box
// only; a blob's own images in the other boxes are ordinary pairs and
// count), each box condensed by tt_condense and its block expanded into
// nine sums. It stages the blobs in float64 (ImageBoxes::Stage), as the
// plain version forms them, so its image choice is the plain version's in
// both precisions. With 9 boxes its operations (9 condensed pairs a block)
// rise above the bytes written.

#include <cuda_runtime.h>

#include "pair_blocks.cuh"

namespace {

constexpr int kTI = 16;              // target blobs of a block
constexpr int kTJ = 32;              // source blobs of a block
constexpr int kThreads = 256;
constexpr int kRows = 3 * kTI;       // 48 matrix rows
constexpr int kCols = 3 * kTJ;       // 96 matrix columns
constexpr int kPitch = kCols + 1;

// stage blob g in the type S (T, or float64 for the image boxes): q = (x,
// y, max(z, a)) / a and its damping min(z/a, 1) (1 without the wall)
template <typename S, typename T, bool WALL>
__device__ __forceinline__ void stage(const T* __restrict__ r, int g, int n,
                                      S a, S* q4) {
  if (g >= n) {
    q4[0] = S(0);
    q4[1] = S(0);
    q4[2] = S(1);
    q4[3] = S(1);
    return;
  }
  const S inv_a = S(1) / a;
  const S z = r[3 * g + 2];
  q4[0] = S(r[3 * g + 0]) * inv_a;
  q4[1] = S(r[3 * g + 1]) * inv_a;
  q4[2] = (WALL ? max(z, a) : z) * inv_a;
  q4[3] = WALL ? min(z / a, S(1)) : S(1);
}

// a: the blob radius, rounded to T for the open instance's staging (as
// the host did before) and kept in float64 for the image boxes'
template <typename T, bool WALL, typename G>
__global__ void __launch_bounds__(kThreads)
dense_tt_kernel(const T* __restrict__ r, T* __restrict__ out, int n, double a,
                T pref, G geom) {
  using S = typename G::Stage;
  // a pitch of 5 keeps the per-lane source reads free of bank conflicts
  __shared__ S s_tgt[kTI][5];
  __shared__ S s_src[kTJ][5];
  __shared__ T s_m[kRows][kPitch];

  const int i0 = blockIdx.y * kTI;
  const int j0 = blockIdx.x * kTJ;
  const int tid = threadIdx.x;
  const S a_s = static_cast<S>(a);
  if (tid < kTI) stage<S, T, WALL>(r, i0 + tid, n, a_s, s_tgt[tid]);
  else if (tid < kTI + kTJ)
    stage<S, T, WALL>(r, j0 + tid - kTI, n, a_s, s_src[tid - kTI]);
  __syncthreads();

  for (int p = tid; p < kTI * kTJ; p += kThreads) {
    const int li = p / kTJ;
    const int lj = p % kTJ;
    const S* t = s_tgt[li];
    const S* s = s_src[lj];
    // the 3x3 block of diag_apply, summed over the boxes: (m v)_x = dx (S
    // (dx vx + dy vy) + P vz) + A vx, ..., (m v)_z = Q (dx vx + dy vy) +
    // mzz vz
    T e[9] = {};
    geom.template visit<WALL>(
        t[0], t[1], t[2], s[0], s[1], s[2], i0 + li == j0 + lj,
        [&](const pairk::Pair<T>& pp) {
          const pairk::Diag<T> m = pairk::tt_condense<T, WALL>(pp);
          const T sdx = m.S * pp.dx, sdy = m.S * pp.dy;
          e[0] += pp.dx * sdx + m.A;
          e[1] += pp.dx * sdy;
          e[2] += pp.dx * m.P;
          e[3] += pp.dy * sdx;
          e[4] += pp.dy * sdy + m.A;
          e[5] += pp.dy * m.P;
          e[6] += m.Q * pp.dx;
          e[7] += m.Q * pp.dy;
          e[8] += m.mzz;
        });
    const T scale = pref * T(t[3]) * T(s[3]);
    T* row = &s_m[3 * li][3 * lj];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      row[0] = e[3 * c] * scale;
      row[1] = e[3 * c + 1] * scale;
      row[2] = e[3 * c + 2] * scale;
      row += kPitch;
    }
  }
  __syncthreads();

  const size_t ld = 3 * static_cast<size_t>(n);
  for (int e = tid; e < kRows * kCols; e += kThreads) {
    const int rr = e / kCols;
    const int cc = e % kCols;
    if (i0 + rr / 3 < n && j0 + cc / 3 < n)
      out[(3 * static_cast<size_t>(i0) + rr) * ld + 3 * static_cast<size_t>(j0)
          + cc] = s_m[rr][cc];
  }
}

template <typename T, typename G>
int launch(const T* r, T* out, int n, double a, double pref, int wall,
           const G& geom, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kTJ - 1) / kTJ, (n + kTI - 1) / kTI);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (wall)
    dense_tt_kernel<T, true, G><<<grid, kThreads, 0, s>>>(r, out, n, a,
                                                          T(pref), geom);
  else
    dense_tt_kernel<T, false, G><<<grid, kThreads, 0, s>>>(r, out, n, a,
                                                           T(pref), geom);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_img(const T* r, T* out, int n, double a, double pref, int wall,
               const double* L, int n_boxes, const double* off,
               void* stream) {
  pairk::ImageBoxes<T> g{};
  if (!pairk::image_boxes(L, n_boxes, off, g))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<T>(r, out, n, a, pref, wall, g, stream);
}

}  // namespace

// r (n,3) raw blob positions, out (3n,3n) row-major; both contiguous on
// the device, n > 0. The image-box instances also take L (3,), the box in
// blob radii (0 on an open axis), and off (n_boxes, 3), the boxes' offsets
// b L in blob radii, the home box first (host arrays). Returns the CUDA
// error code of the launch.
extern "C" int dense_tt_f32(const float* r, float* out, int n, double a,
                            double pref, int wall, void* stream) {
  return launch<float>(r, out, n, a, pref, wall, pairk::OpenBox<float>(),
                       stream);
}

extern "C" int dense_tt_f64(const double* r, double* out, int n, double a,
                            double pref, int wall, void* stream) {
  return launch<double>(r, out, n, a, pref, wall, pairk::OpenBox<double>(),
                        stream);
}

extern "C" int dense_tt_img_f32(const float* r, float* out, int n, double a,
                                double pref, int wall, const double* L,
                                int n_boxes, const double* off,
                                void* stream) {
  return launch_img<float>(r, out, n, a, pref, wall, L, n_boxes, off, stream);
}

extern "C" int dense_tt_img_f64(const double* r, double* out, int n, double a,
                                double pref, int wall, const double* L,
                                int n_boxes, const double* off,
                                void* stream) {
  return launch_img<double>(r, out, n, a, pref, wall, L, n_boxes, off,
                            stream);
}
