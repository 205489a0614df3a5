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
// per unordered pair (~0.2 ms of float32 issue; with 9 image boxes ~600,
// ~1 ms). The matrix is symmetric, M[3j+b, 3i+a] = M[3i+a, 3j+b], so each
// unordered pair is condensed once. Design: the grid covers the upper
// triangle of square tiles of kBlobs blobs (I <= J; pairk::group_pair
// numbers them), a block of 256 threads each. A block stages its 2 kBlobs
// blob coordinates (normalized and shifted here) in shared memory,
// condenses each pair of the tile once with pair_blocks.cuh's geometry and
// tt_condense (the arithmetic of kernel K1 tt, without a division), sums
// its boxes into a pairk::BlockSum and expands it into a (3 kBlobs)^2
// shared tile, then writes tile (I, J) row by row and tile (J, I) as its
// exact transpose, read down the shared tile's columns: each warp stores
// 32 consecutive values of one matrix row either way, and the odd pitch
// keeps the column reads free of bank conflicts. A diagonal tile condenses
// its pairs i <= j and mirrors each into both places (a blob's own block by
// its upper entries), so the whole matrix is its exact transpose. A
// float32 block takes 32 blobs a side and ~40 KB of shared memory, so
// several blocks share an SM and one block's stores overlap another's
// condensing (a float64 block 16 a side, within the 48 KB of static
// shared memory).
// Ragged edges are masked by index; blobs past the end are staged as (0,
// 0, 1), the padding of dense_tt_pallas. The self pair (i == j) and
// coincident distinct blobs take the rules of _core_fields (core 4/3 and
// 0), the wall terms at the self geometry being the wall self-mobility.
//
// The image-box instance (dense_tt_img_*) sums every box of the
// pseudo-periodic list into each 3x3 block (the JAX package's
// ops/mobility.py dense_mobility_tiled with a periodic_length, XLA there):
// the pair geometry of pair_blocks.cuh ImageBoxes, or PlaneBoxes where
// with_boxes takes it (the in-plane box: heights and offsets formed once a pair,
// the boxes off the home box in the far form alone): the minimum image in
// the home box, then d + b L for each box, the self block in the home box
// only; a blob's own images in the other boxes are ordinary pairs and
// count. It stages the blobs in float64 (the policies' Stage), as the
// plain version forms them, so its image choice is the plain version's in
// both precisions. The box sum is symmetric like the open matrix (the
// minimum image is odd in d, ties included, and the list is symmetric
// under b -> -b), so the triangle grid carries over.
//
// The free-surface instances (domain code 2 of dense_tt_* and
// dense_tt_img_*; the JAX package's dense_mobility_tiled with domain
// free_surface, XLA there) condense pairk::FreeSurface's block, the RPY
// block plus its image reflected in the slip plane z = 0, on the same
// grid, open and in the image boxes: it is symmetric as tt's
// (pair_blocks.cuh fs_condense), and the blobs are staged without the
// wall's shift and damping.

#include <cuda_runtime.h>

#include <type_traits>

#include "pair_blocks.cuh"

namespace {

constexpr int kThreads = 256;

// blobs a side of a square tile: the float32 tile of 96 x 97 values
// (37,248 bytes) and the float64 one of 48 x 49 (18,816) stay within the
// 48 KB of static shared memory
template <typename T>
struct Tile {
  static constexpr int kBlobs = sizeof(T) == 4 ? 32 : 16;
  static constexpr int kRows = 3 * kBlobs;
  static constexpr int kPitch = kRows + 1;
};

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
// the host did before) and kept in float64 for the image boxes'. FS: the
// free surface's block (pairk::FreeSurface on the wall's pair geometry),
// staged without the wall's shift and damping (WALL false)
template <typename T, bool WALL, typename G, bool FS = false>
__global__ void __launch_bounds__(kThreads)
dense_tt_kernel(const T* __restrict__ r, T* __restrict__ out, int n,
                int n_tiles, double a, T pref, G geom) {
  using C = std::conditional_t<FS, pairk::FreeSurface, pairk::TT>;
  using S = typename G::Stage;
  constexpr int kB = Tile<T>::kBlobs;
  constexpr int kR = Tile<T>::kRows;
  // a pitch of 5 keeps the per-lane source reads free of bank conflicts
  __shared__ S s_i[kB][5];
  __shared__ S s_j[kB][5];
  __shared__ T s_m[kR][Tile<T>::kPitch];

  int ti, tj;
  pairk::group_pair(blockIdx.x, n_tiles, ti, tj);
  const int i0 = ti * kB;
  const int j0 = tj * kB;
  const bool diag = ti == tj;
  const int tid = threadIdx.x;
  const S a_s = static_cast<S>(a);
  if (tid < kB) stage<S, T, WALL>(r, i0 + tid, n, a_s, s_i[tid]);
  else if (tid < 2 * kB)
    stage<S, T, WALL>(r, j0 + tid - kB, n, a_s, s_j[tid - kB]);
  __syncthreads();

  for (int p = tid; p < kB * kB; p += kThreads) {
    const int li = p / kB;
    const int lj = p % kB;
    if (diag && li > lj) continue;  // mirrored from (lj, li)
    const S* t = s_i[li];
    const S* s = s_j[lj];
    const pairk::BlockSum<T> m = pairk::sum_blocks<T, C, WALL || FS>(
        geom, t[0], t[1], t[2], s[0], s[1], s[2], i0 + li == j0 + lj);
    const T scale = pref * T(t[3]) * T(s[3]);
    const T e[9] = {m.xx, m.xy, m.xz, m.xy, m.yy, m.yz, m.zx, m.zy, m.zz};
    // on a diagonal tile each block goes to (li, lj) and mirrored to (lj,
    // li); a blob's own block (li = lj; its images' box sum is symmetric
    // only up to rounding) keeps its upper entries, mirrored
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (diag && li == lj && c > d) continue;
        const T val = e[3 * c + d] * scale;
        s_m[3 * li + c][3 * lj + d] = val;
        if (diag) s_m[3 * lj + d][3 * li + c] = val;
      }
  }
  __syncthreads();

  // each warp stores whole rows of a tile, 32 consecutive values a store
  const size_t ld = 3 * static_cast<size_t>(n);
  const int lane = tid % 32;
  const int warp = tid / 32;
  constexpr int kWarpsT = kThreads / 32;
  const int rows_i = 3 * min(kB, n - i0);  // matrix rows of tile row I
  const int rows_j = 3 * min(kB, n - j0);
  // tile (I, J)
  for (int rr = warp; rr < rows_i; rr += kWarpsT) {
    T* o = out + (3 * static_cast<size_t>(i0) + rr) * ld +
           3 * static_cast<size_t>(j0);
#pragma unroll
    for (int c0 = 0; c0 < kR; c0 += 32)
      if (c0 + lane < rows_j) o[c0 + lane] = s_m[rr][c0 + lane];
  }
  if (diag) return;
  // tile (J, I), the transpose: its row rr is column rr of s_m
  for (int rr = warp; rr < rows_j; rr += kWarpsT) {
    T* o = out + (3 * static_cast<size_t>(j0) + rr) * ld +
           3 * static_cast<size_t>(i0);
#pragma unroll
    for (int c0 = 0; c0 < kR; c0 += 32)
      if (c0 + lane < rows_i) o[c0 + lane] = s_m[c0 + lane][rr];
  }
}

// the domain code `mode` selects the instance: 0 open, 1 the wall, 2 the
// free surface; any other code is refused
template <typename T, typename G>
int launch(const T* r, T* out, int n, double a, double pref, int mode,
           const G& geom, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (n + Tile<T>::kBlobs - 1) / Tile<T>::kBlobs;
  const long long blocks = n_tiles * (n_tiles + 1) / 2;
  if (n < 1 || blocks > 0x7fffffffLL || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (mode == 2)
    dense_tt_kernel<T, false, G, true><<<grid, kThreads, 0, s>>>(
        r, out, n, static_cast<int>(n_tiles), a, T(pref), geom);
  else if (mode == 1)
    dense_tt_kernel<T, true, G><<<grid, kThreads, 0, s>>>(
        r, out, n, static_cast<int>(n_tiles), a, T(pref), geom);
  else
    dense_tt_kernel<T, false, G><<<grid, kThreads, 0, s>>>(
        r, out, n, static_cast<int>(n_tiles), a, T(pref), geom);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_img(const T* r, T* out, int n, double a, double pref, int mode,
               const double* L, int n_boxes, const double* off,
               void* stream) {
  return pairk::with_boxes<T>(L, n_boxes, off, [&](const auto& g) {
    return launch<T>(r, out, n, a, pref, mode, g, stream);
  });
}

template <typename T, typename G>
int resident(int mode, int* blocks_per_sm) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm,
      mode == 2   ? dense_tt_kernel<T, false, G, true>
      : mode == 1 ? dense_tt_kernel<T, true, G>
                  : dense_tt_kernel<T, false, G>,
      kThreads, 0));
}

template <typename T>
int shape(int images, int mode, int* blocks_per_sm) {
  if (images == 2)
    return resident<T, pairk::PlaneBoxes<T>>(mode, blocks_per_sm);
  return images ? resident<T, pairk::ImageBoxes<T>>(mode, blocks_per_sm)
                : resident<T, pairk::OpenBox<T>>(mode, blocks_per_sm);
}

}  // namespace

// resident blocks an SM holds of an instance: images 0 (open), 1
// (ImageBoxes) or 2 (PlaneBoxes), mode as dense_tt_f32's; for the
// profiling tool
extern "C" int dense_tt_shape(int f64, int images, int mode,
                              int* blocks_per_sm) {
  return f64 ? shape<double>(images, mode, blocks_per_sm)
             : shape<float>(images, mode, blocks_per_sm);
}

// r (n,3) raw blob positions, out (3n,3n) row-major; both contiguous on
// the device, n > 0; mode the domain code (0 open, 1 wall, 2 free
// surface). The image-box instances also take L (3,), the box in blob
// radii (0 on an open axis), off (n_boxes, 3), the boxes' offsets b L in
// blob radii, the home box first (host arrays; pairk::with_boxes picks
// the policy). Returns the CUDA error code of the launch.
extern "C" int dense_tt_f32(const float* r, float* out, int n, double a,
                            double pref, int mode, void* stream) {
  return launch<float>(r, out, n, a, pref, mode, pairk::OpenBox<float>(),
                       stream);
}

extern "C" int dense_tt_f64(const double* r, double* out, int n, double a,
                            double pref, int mode, void* stream) {
  return launch<double>(r, out, n, a, pref, mode, pairk::OpenBox<double>(),
                        stream);
}

extern "C" int dense_tt_img_f32(const float* r, float* out, int n, double a,
                                double pref, int mode, const double* L,
                                int n_boxes, const double* off,
                                void* stream) {
  return launch_img<float>(r, out, n, a, pref, mode, L, n_boxes, off, stream);
}

extern "C" int dense_tt_img_f64(const double* r, double* out, int n, double a,
                                double pref, int mode, const double* L,
                                int n_boxes, const double* off,
                                void* stream) {
  return launch_img<double>(r, out, n, a, pref, mode, L, n_boxes, off,
                            stream);
}
