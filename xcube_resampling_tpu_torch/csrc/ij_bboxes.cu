// K10: the tile plan's bbox scan, the pixel bboxes of a swath's coordinate
// images that fall inside the tiles of a regular target.
//
// Replaces the XLA kernel of xcube_resampling_tpu/ops/bbox_ops.py:
// compute_ij_bboxes_jax (:16-58), and computes what the JAX package's host
// scan computes (gridmapping/bboxes.py:compute_ij_bboxes, called by
// GridMapping.ij_bboxes_from_xy_bboxes): for every tile k, the least and
// the greatest column i and row j of the swath pixels with
//   x_lo[k] <= x <= x_hi[k]  and  y_lo[k] <= y <= y_hi[k]
// in float64, the bounds grown by the border on the host exactly as the
// host scan grows them; the stops exclusive, grown by ij_border and clipped
// to the image; a row of -1 where no pixel counts.  NaN coordinates never
// count (every comparison with NaN is false).
//
// The tiles are those of a regular grid: each tile's x bounds are its
// column's and its y bounds its row's.  The wrapper hands the kernel the
// columns' and the rows' bounds, each sorted so that both the low and the
// high bounds ascend (it refuses tiles that are no such lattice).  A pixel
// then finds its candidate columns by two binary searches: the columns
// whose low bound is at most x end at upper_bound(x_lo, x), those whose
// high bound is at least x start at lower_bound(x_hi, x); every column in
// between passes both float64 comparisons, and no other does.  The same
// for rows.  So the pixel visits only the tiles that take it, however wide
// the border (rectify's search border can span several tiles), and never
// loops over every tile.
//
// Bound on the H100: device memory, the two float64 coordinate images read
// once (16 bytes a pixel); the per-tile table is small.  Design: one block
// over whole swath rows, threads across each row (coalesced loads); each
// thread keeps a running min/max for the last tile it hit in registers
// (neighbouring pixels of a row mostly land in the same tile), and flushes
// it with int32 atomicMin/atomicMax into the block's table in shared
// memory; each block then merges the tiles it touched into the global
// table with atomics.  Min and max do not depend on order: the result is
// deterministic.  A lattice whose table outgrows 48 KB of shared memory
// (3072 tiles) is cut into sub-lattices of at most that many tiles, one
// launch each over the whole swath.  A last launch turns the table into
// the exclusive, border-grown int64 boxes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1056;  // 8 blocks on each of the H100's 132 SMs
constexpr int kNone = 0x7FFFFFFF;
constexpr int kMaxTiles = 3072;   // 16 bytes a tile: 48 KB of shared memory

struct Args {
  const double* x;       // (h, w) swath x
  const double* y;       // (h, w) swath y
  int64_t h, w;
  const double* lat;     // col_lo[nc], col_hi[nc], row_lo[nr], row_hi[nr] (sorted)
  const int* perm;       // col_of[nc], row_of[nr]: sorted position -> lattice index
  int nc, nr;
  int c_begin, c_count;  // this launch's sub-lattice, in sorted positions
  int r_begin, r_count;
  int* gmin;             // (nc * nr, 2) i, j; initialised to 0x7F7F7F7F
  int* gmax;             // (nc * nr, 2) i, j; initialised to -1
};

// the first position in a[0, n) with a[p] >= v (lo = true) or a[p] > v
__device__ __forceinline__ int bound_search(const double* a, int n, double v, bool lo) {
  int first = 0;
  while (n > 0) {
    const int half = n >> 1;
    const double m = __ldg(a + first + half);
    if (lo ? (m < v) : (m <= v)) {
      first += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return first;
}

__device__ __forceinline__ void merge(int* s, int t, int i0, int j0, int i1, int j1) {
  atomicMin(s + 4 * t, i0);
  atomicMin(s + 4 * t + 1, j0);
  atomicMax(s + 4 * t + 2, i1);
  atomicMax(s + 4 * t + 3, j1);
}

__global__ void __launch_bounds__(kThreads) scan_kernel(const Args a) {
  // (c_count * r_count, 4): min i, min j, max i, max j of the sub-lattice's
  // tiles, tile t at sorted row r_begin + t / c_count, column c_begin +
  // t % c_count (dynamic shared memory, at most 48 KB)
  extern __shared__ int table[];
  const int n = a.c_count * a.r_count;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    table[4 * t] = kNone;
    table[4 * t + 1] = kNone;
    table[4 * t + 2] = -1;
    table[4 * t + 3] = -1;
  }
  __syncthreads();
  const double* col_lo = a.lat + a.c_begin;
  const double* col_hi = a.lat + a.nc + a.c_begin;
  const double* row_lo = a.lat + 2 * a.nc + a.r_begin;
  const double* row_hi = a.lat + 2 * a.nc + a.nr + a.r_begin;

  // the running box of the last tile this thread hit alone
  int cur = -1, ci0 = 0, cj0 = 0, ci1 = 0, cj1 = 0;
  for (int64_t j = blockIdx.x; j < a.h; j += gridDim.x) {
    const double* xr = a.x + j * a.w;
    const double* yr = a.y + j * a.w;
    const int jj = static_cast<int>(j);
    for (int64_t i = threadIdx.x; i < a.w; i += kThreads) {
      const double x = xr[i];
      const double y = yr[i];
      if (isnan(x) || isnan(y)) continue;
      const int r0 = bound_search(row_hi, a.r_count, y, true);
      const int r1 = bound_search(row_lo, a.r_count, y, false);
      if (r0 >= r1) continue;
      const int c0 = bound_search(col_hi, a.c_count, x, true);
      const int c1 = bound_search(col_lo, a.c_count, x, false);
      if (c0 >= c1) continue;
      const int ii = static_cast<int>(i);
      if (c1 - c0 == 1 && r1 - r0 == 1) {
        const int t = r0 * a.c_count + c0;
        if (t == cur) {
          ci0 = min(ci0, ii);
          cj0 = min(cj0, jj);
          ci1 = max(ci1, ii);
          cj1 = max(cj1, jj);
          continue;
        }
        if (cur >= 0) merge(table, cur, ci0, cj0, ci1, cj1);
        cur = t;
        ci0 = ci1 = ii;
        cj0 = cj1 = jj;
        continue;
      }
      for (int r = r0; r < r1; ++r) {
        for (int c = c0; c < c1; ++c) merge(table, r * a.c_count + c, ii, jj, ii, jj);
      }
    }
  }
  if (cur >= 0) merge(table, cur, ci0, cj0, ci1, cj1);
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += kThreads) {
    if (table[4 * t + 2] < 0) continue;
    const int row = a.perm[a.nc + a.r_begin + t / a.c_count];
    const int k = row * a.nc + a.perm[a.c_begin + t % a.c_count];
    atomicMin(a.gmin + 2 * k, table[4 * t]);
    atomicMin(a.gmin + 2 * k + 1, table[4 * t + 1]);
    atomicMax(a.gmax + 2 * k, table[4 * t + 2]);
    atomicMax(a.gmax + 2 * k + 1, table[4 * t + 3]);
  }
}

__global__ void __launch_bounds__(kThreads) finish_kernel(const int* gmin, const int* gmax,
                                                          int n, int64_t h, int64_t w,
                                                          int64_t border, int64_t* out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  int64_t* o = out + 4 * static_cast<int64_t>(k);
  if (gmax[2 * k] < 0) {
    o[0] = o[1] = o[2] = o[3] = -1;
    return;
  }
  const int64_t i0 = gmin[2 * k] - border, j0 = gmin[2 * k + 1] - border;
  const int64_t i1 = gmax[2 * k] + 1 + border, j1 = gmax[2 * k + 1] + 1 + border;
  o[0] = i0 < 0 ? 0 : i0;
  o[1] = j0 < 0 ? 0 : j0;
  o[2] = i1 > w ? w : i1;
  o[3] = j1 > h ? h : j1;
}

}  // namespace

// x, y (h, w) float64; lat (2 nc + 2 nr) float64 and perm (nc + nr) int32
// as in Args; gmin, gmax (nc * nr, 2) int32 scratch; out (nc * nr, 4) int64,
// row-major over the lattice's tiles (row, then column).
extern "C" int xrt_ij_bboxes(const double* x, const double* y, int64_t h, int64_t w,
                             const double* lat, const int* perm, int64_t nc, int64_t nr,
                             int64_t border, int* gmin, int* gmax, int64_t* out,
                             void* stream) {
  if (h < 1 || w < 1 || h >= kNone || w >= kNone || nc < 1 || nr < 1 ||
      nc * nr >= (1LL << 30)) {
    return 1;  // cudaErrorInvalidValue
  }
  const int n = static_cast<int>(nc * nr);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(gmin, 0x7F, sizeof(int) * 2 * n, s);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(gmax, 0xFF, sizeof(int) * 2 * n, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int c_step = static_cast<int>(nc < kMaxTiles ? nc : kMaxTiles);
  const int r_step = static_cast<int>(nr < kMaxTiles / c_step ? nr : kMaxTiles / c_step);
  const int blocks = static_cast<int>(h < kMaxBlocks ? h : kMaxBlocks);
  for (int r = 0; r < nr; r += r_step) {
    for (int c = 0; c < nc; c += c_step) {
      const Args a{x, y, h, w, lat, perm, static_cast<int>(nc), static_cast<int>(nr),
                   c, static_cast<int>(nc - c < c_step ? nc - c : c_step),
                   r, static_cast<int>(nr - r < r_step ? nr - r : r_step), gmin, gmax};
      const size_t smem = sizeof(int) * 4 * a.c_count * a.r_count;
      scan_kernel<<<blocks, kThreads, smem, s>>>(a);
      rc = cudaGetLastError();
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
  }
  finish_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(gmin, gmax, n, h, w,
                                                                  border, out);
  return static_cast<int>(cudaGetLastError());
}
