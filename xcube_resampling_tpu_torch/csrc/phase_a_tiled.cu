// K20 `phase_a_tiled`: the tiled-stencil Phase A of rectify, in float64.
//
// Replaces the XLA kernels of xcube_resampling_tpu/ops/rectify_ops.py
// _phase_a_tiled (:621-767) and _build_phase_a_apply (:783-838): on the
// swath's coordinates normalised to the target's pixel units, each listed
// destination tile (tile x tile pixels, row-major over n_ti tiles across)
// tests every quad of a (win x win)-node source window at its planned
// origin (bj, bi) (plan_phase_a_device, whose window may reach past the
// swath: nodes outside it are NaN, as the JAX package's NaN padding makes
// them) against its pixel centres; each pixel takes the accepting quad of
// lowest global row-major rank (triangle A's solve where A accepts, else
// B's; true divisions), NaN where none accepts.  The winner's (i, j) is
// written straight into the (2, dst_h, dst_w) map, the pixels past the
// target's edge left out, so JAX's (T, t, t) -> (2, Hp, Wp) reshape,
// transpose and crop go away; the wrapper launches the interior class over
// every tile, then the band class over its tiles (overwriting them), and
// copies the host blocks in.  Built with -fmad=false: fma() stands where
// XLA contracts the JAX kernel's float64 formulas (phase_a_common.h), so
// the map equals JAX's float64 tiled Phase A bit for bit.
//
// Bound on the H100: the map's write and the windows' reads are a few MB;
// what holds the kernel is float64 arithmetic, some 30 operations and two
// divisions a (pixel, triangle) pair solved.  The first design (a
// thread a pixel scanning its window's quads in rank order to the first
// that accepts, 361 quads at R1's interior window of 20, 1521 at the band
// class's 40) solved almost every pair of a pixel with a quad nowhere near
// it: 5.01 device ms at R1's interior class, 204x the bound (H100 80GB
// HBM3, 700 W).  Design, K12's (csrc/hybrid_phase_a.cu): solve only the
// pairs that can accept.
//   1. A block a tile stages its window's nodes in shared memory (16 B a
//      node; NaN past the swath).  A block takes one tile: each tile has a
//      window of its own, and a quad outside a tile's window must not win
//      there, so tiles sharing a block would each need their own staging
//      and cull; a block of one warp (the interior class) is the finest
//      such grain.  Its threads are not tied to pixels: kSmallThreads a
//      block for windows up to kSmallWin nodes, else kLargeThreads (the
//      band class's windows hold four times the quads).
//   2. Pass 1, a thread a quad (strided over the window): a quad whose
//      nodes' box, grown by the most its triangles' boxes can grow, misses
//      the tile's pixel centres (or has no finite node), and whose
//      triangles are dropped or well conditioned, has no pair; the others
//      are listed in shared memory, in no order.
//   3. Pass 2, a thread a listed quad: each triangle's determinant
//      (tri_det), its box (tri_box, phase_a_common.h: empty where the
//      determinant is 0 or NaN, the whole tile for a sliver or an infinite
//      node) clipped to the tile's pixels inside the target, and each pair
//      in the clip tested as tri_accepts tests it, with the first design's
//      operations (v left unsolved where u already refuses: the same
//      verdicts, and no spill); where it accepts, the pixel's key (2 * rank + side: A 0, B 1, rank
//      the quad's row-major index in the window, which in a rectangular
//      window orders the quads as JAX's global rank does) is lowered with a
//      shared atomicMin.  The least key is the scan's winner whatever the
//      order of the list and of the atomics.
//   4. A thread a pixel solves its winner once more (the same operations on
//      the same operands: the same bits) and writes (i, j) into the map;
//      NaN where no pair accepted.
// The box's constants are K12's: K20 divides once where K12 multiplies by a
// reciprocal, which the bound already allows for (phase_a_common.h); the
// plain mirror is rectify_ops.hybrid_tri_boxes, and the CPU tests hold
// every pair that accepts under K20's divisions inside its box
// (tests/test_torch_tiled_cull.py, phase_a.phase_a_tiled_pairs).
#include "phase_a_common.h"

namespace {

// threads a block: kSmallThreads for windows of up to kSmallWin nodes,
// else kLargeThreads; registers capped for kSmThreads threads an SM (102 a
// thread: 95 taken, none spilled; 768 threads an SM spill 36 bytes a
// thread).  Measured by tools/tune_phase_a_tiled.py (H100 80GB HBM3, 700
// W): at R1's interior class 32 threads 0.4435 device ms, 64 0.4648, 128
// 0.5916; a cap of 512 threads an SM (64 a block) 0.5185; the band
// class's 64, 128 and 256 threads 0.0649, 0.0593, 0.0758.
constexpr int kSmallThreads = 32;
constexpr int kLargeThreads = 128;
constexpr int kSmallWin = 24;
constexpr int kSmThreads = 640;

struct TiledArgs {
  const double* gx;
  const double* gy;
  int64_t src_h, src_w;
  const int* tiles;  // the listed tiles, or nullptr: tile blockIdx.x
  const int* bjs;    // each listed tile's window origin
  const int* bis;
  int win, tile;
  int64_t n_ti, dst_h, dst_w;
  double u_min, uv_max;
  Cull cull;
  double* out;  // (2, dst_h, dst_w)
};

// triangle `side` (0: A, 1: B) of the window quad whose first node is n0,
// solved at (px, py) as pass 2 and the first design solve it: whether it
// accepts, (u, v)
__device__ __forceinline__ bool solve(const double* wx, const double* wy, int w, int n0,
                                      int side, double px, double py, double u_min,
                                      double uv_max, double& u, double& v) {
  if (side == 0) {
    const double p0x = wx[n0], p0y = wy[n0], p1x = wx[n0 + 1], p1y = wy[n0 + 1];
    const double p2x = wx[n0 + w], p2y = wy[n0 + w];
    return tri_accepts(tri_det(p0x, p0y, p1x, p1y, p2x, p2y), px, py, p0x, p0y, p1x, p1y,
                       p2x, p2y, u_min, uv_max, u, v);
  }
  const double p3x = wx[n0 + w + 1], p3y = wy[n0 + w + 1];
  const double p2x = wx[n0 + w], p2y = wy[n0 + w], p1x = wx[n0 + 1], p1y = wy[n0 + 1];
  return tri_accepts(tri_det(p3x, p3y, p2x, p2y, p1x, p1y), px, py, p3x, p3y, p2x, p2y, p1x,
                     p1y, u_min, uv_max, u, v);
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS, kSmThreads / THREADS)
    tiled_kernel(const TiledArgs a) {
  extern __shared__ __align__(16) double smem[];
  __shared__ int n_near;
  const int w = a.win, nw = w * w, wq = w - 1, nq = wq * wq;
  const int n_p = a.tile * a.tile;
  double* wx = smem;
  double* wy = smem + nw;
  int* key = reinterpret_cast<int*>(wy + nw);
  int* near = key + n_p;
  const int tid = threadIdx.x;
  const int64_t t = a.tiles != nullptr ? a.tiles[blockIdx.x] : blockIdx.x;
  const int64_t bj = a.bjs[blockIdx.x], bi = a.bis[blockIdx.x];
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (int k = tid; k < nw; k += THREADS) {
    const int64_t r = bj + k / w, c = bi + k % w;
    const bool in = r < a.src_h && c < a.src_w;
    wx[k] = in ? __ldg(a.gx + r * a.src_w + c) : nan;
    wy[k] = in ? __ldg(a.gy + r * a.src_w + c) : nan;
  }
  for (int p = tid; p < n_p; p += THREADS) key[p] = INT_MAX;
  if (tid == 0) n_near = 0;
  __syncthreads();
  // the tile's pixels inside the target: columns col0 .. col0 + n_cols - 1,
  // rows row0 .. row0 + n_rows - 1, centres at + 0.5
  const int64_t row0 = (t / a.n_ti) * a.tile, col0 = (t % a.n_ti) * a.tile;
  const int n_cols = static_cast<int>(a.dst_w - col0 < a.tile ? a.dst_w - col0 : a.tile);
  const int n_rows = static_cast<int>(a.dst_h - row0 < a.tile ? a.dst_h - row0 : a.tile);
  const double x0 = static_cast<double>(col0), y0 = static_cast<double>(row0);
  // pass 1, a thread a quad: the quads that can hold a pair, listed
  {
    const double t_x0 = x0 + 0.5, t_x1 = x0 + (n_cols - 0.5);
    const double t_y0 = y0 + 0.5, t_y1 = y0 + (n_rows - 0.5);
    const double grow = 2 * a.cull.pad_max;
    for (int q = tid; q < nq; q += THREADS) {
      const int n0 = (q / wq) * w + q % wq;
      const int n1 = n0 + 1, n2 = n0 + w, n3 = n0 + w + 1;
      // (fmin and fmax skip a NaN node, whose triangles are dropped; all
      // four NaN: NaN bounds, no pixel)
      const double xl = fmin(fmin(wx[n0], wx[n1]), fmin(wx[n2], wx[n3]));
      const double xh = fmax(fmax(wx[n0], wx[n1]), fmax(wx[n2], wx[n3]));
      const double yl = fmin(fmin(wy[n0], wy[n1]), fmin(wy[n2], wy[n3]));
      const double yh = fmax(fmax(wy[n0], wy[n1]), fmax(wy[n2], wy[n3]));
      const double rx = grow * (xh - xl) + kCullReach * ((1 + fabs(xl)) + fabs(xh));
      const double ry = grow * (yh - yl) + kCullReach * ((1 + fabs(yl)) + fabs(yh));
      const bool meets = xl - rx <= t_x1 && xh + rx >= t_x0 && yl - ry <= t_y1 && yh + ry >= t_y0;
      if (!meets && sure(wx[n0], wy[n0], wx[n1], wy[n1], wx[n2], wy[n2]) &&
          sure(wx[n3], wy[n3], wx[n2], wy[n2], wx[n1], wy[n1])) {
        continue;
      }
      near[atomicAdd(&n_near, 1)] = q;
    }
  }
  __syncthreads();
  // pass 2, a thread a listed quad: each triangle's box clipped to the
  // tile's pixels, its pairs solved, an accepting pair lowering its key
  const double u_min = a.u_min, uv_max = a.uv_max;
  for (int i = tid; i < n_near; i += THREADS) {
    const int q = near[i];
    const int n0 = (q / wq) * w + q % wq;
    const int n1 = n0 + 1, n2 = n0 + w, n3 = n0 + w + 1;
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
      // triangle A (p0, p1, p2) or B (p3, p2, p1)
      const int m0 = side == 0 ? n0 : n3, m1 = side == 0 ? n1 : n2, m2 = side == 0 ? n2 : n1;
      const double q0x = wx[m0], q0y = wy[m0], q1x = wx[m1], q1y = wy[m1];
      const double q2x = wx[m2], q2y = wy[m2];
      const double det = tri_det(q0x, q0y, q1x, q1y, q2x, q2y);
      int rect = 0;
      if (clip_box(tri_box(q0x, q0y, q1x, q1y, q2x, q2y, det != 0 ? 1.0 / det : nan, a.cull),
                   x0, y0, n_cols, n_rows, &rect) == 0) {
        continue;
      }
      const int c_lo = rect & 0xff, c_hi = (rect >> 8) & 0xff;
      const int r_lo = (rect >> 16) & 0xff, r_hi = (rect >> 24) & 0xff;
      // (det is not 0 here: its box would be empty.)  tri_accepts' test, v
      // left unsolved where u already refuses (the same verdicts)
      for (int r = r_lo; r <= r_hi; ++r) {
        const double py = (y0 + r) + 0.5;
        for (int c = c_lo; c <= c_hi; ++c) {
          // (x0 + c is exact: the pixel's column, as in the write below)
          const double px = (x0 + c) + 0.5;
          const double u = fu(px, py, q0x, q0y, q2x, q2y) / det;
          if (!(u >= u_min)) continue;
          const double v = fv(px, py, q0x, q0y, q1x, q1y) / det;
          if (v >= u_min && u + v <= uv_max) atomicMin(&key[r * a.tile + c], 2 * q + side);
        }
      }
    }
  }
  __syncthreads();
  for (int p = tid; p < n_p; p += THREADS) {
    const int lr = p / a.tile, lc = p % a.tile;
    if (lr >= n_rows || lc >= n_cols) continue;
    const int64_t row = row0 + lr, col = col0 + lc;
    const int k = key[p];
    double oi = nan, oj = nan;
    if (k != INT_MAX) {
      const int q = k >> 1, side = k & 1;
      const int qj = q / wq, qi = q - qj * wq;
      const double gi = static_cast<double>(bi + qi), gj = static_cast<double>(bj + qj);
      double u, v;
      solve(wx, wy, w, qj * w + qi, side, static_cast<double>(col) + 0.5,
            static_cast<double>(row) + 0.5, u_min, uv_max, u, v);
      if (side == 0) {
        oi = gi + clip01(u);
        oj = gj + clip01(v);
      } else {
        oi = (gi + 1.0) - clip01(u);
        oj = (gj + 1.0) - clip01(v);
      }
    }
    const int64_t o = row * a.dst_w + col;
    a.out[o] = oi;
    a.out[a.dst_h * a.dst_w + o] = oj;
  }
}

template <int THREADS>
cudaError_t launch(const TiledArgs& a, int64_t n, size_t smem, cudaStream_t st) {
  auto kernel = tiled_kernel<THREADS>;
  // (n_near, 4 bytes, counts against the default 48 KB)
  if (smem > 48 * 1024 - 16) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<static_cast<unsigned>(n), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// K20 on float64 (src_h, src_w) gx, gy (normalised): the n listed tiles
// (tiles, int32, or nullptr for tiles 0 .. n - 1) of tile x tile pixels,
// n_ti across, each at its window origin (bjs, bis, int32, n each) with a
// window of win x win nodes, written into out (2, dst_h, dst_w) float64.
// Shared memory a block: the nodes (16 win^2 bytes), the pixels' keys
// (4 tile^2) and the list (4 (win - 1)^2), at most 227 KB (win <= 107).
extern "C" int xrt_phase_a_tiled(const double* gx, const double* gy, int64_t src_h,
                                 int64_t src_w, const int* tiles, const int* bjs,
                                 const int* bis, int64_t n, int64_t win, int64_t tile,
                                 int64_t n_ti, int64_t dst_h, int64_t dst_w, double uv_delta,
                                 double* out, void* stream) {
  if (src_h < 1 || src_w < 1 || n < 0 || n > INT_MAX || win < 2 || win > 120 || tile < 1 ||
      tile > 32 || n_ti < 1 || dst_h < 1 || dst_w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 16 * static_cast<size_t>(win * win) + 4 * static_cast<size_t>(tile * tile) +
                      4 * static_cast<size_t>((win - 1) * (win - 1));
  if (smem > 232448 - 16) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const double u_min = -uv_delta, uv_max = 1.0 + 2 * uv_delta;
  const TiledArgs a{gx, gy, src_h, src_w, tiles, bjs, bis, static_cast<int>(win),
                    static_cast<int>(tile), n_ti, dst_h, dst_w, u_min, uv_max,
                    cull_of(u_min, uv_max), out};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = win <= kSmallWin ? launch<kSmallThreads>(a, n, smem, st)
                                          : launch<kLargeThreads>(a, n, smem, st);
  return static_cast<int>(rc);
}
