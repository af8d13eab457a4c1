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
// Design: a block a tile, a thread a pixel (tile^2 threads).  The window's
// nodes are staged in shared memory once a block (16 B a node: 147 KB at
// the band class's largest window of 96 nodes, past the default 48 KB, so
// the launch opts in to the large carve-out).  Inside a rectangular window
// the quads' row-major order is their global rank order, so JAX's two
// passes (the least accepting rank, then the winner solved again) are one
// scan a pixel in that order, stopping at the first quad that accepts: the
// winner's solve is the same operations on the same operands, so the same
// bits.  Bound on the H100: the map's write and the windows' reads are a
// few MB; the solves are float64 arithmetic, up to (win - 1)^2 quads a
// pixel (about 30 operations and two divisions a triangle), fewer where a
// pixel's winner comes early in its window's order.
#include "phase_a_common.h"

namespace {

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
  double* out;  // (2, dst_h, dst_w)
};

__global__ void tiled_kernel(const TiledArgs a) {
  extern __shared__ __align__(16) double smem[];
  const int w = a.win, nw = w * w;
  double* wx = smem;
  double* wy = smem + nw;
  const int64_t t = a.tiles != nullptr ? a.tiles[blockIdx.x] : blockIdx.x;
  const int64_t bj = a.bjs[blockIdx.x], bi = a.bis[blockIdx.x];
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (int k = threadIdx.x; k < nw; k += blockDim.x) {
    const int64_t r = bj + k / w, c = bi + k % w;
    const bool in = r < a.src_h && c < a.src_w;
    wx[k] = in ? a.gx[r * a.src_w + c] : nan;
    wy[k] = in ? a.gy[r * a.src_w + c] : nan;
  }
  __syncthreads();
  const int64_t row = (t / a.n_ti) * a.tile + threadIdx.x / a.tile;
  const int64_t col = (t % a.n_ti) * a.tile + threadIdx.x % a.tile;
  if (row >= a.dst_h || col >= a.dst_w) return;
  const double px = static_cast<double>(col) + 0.5, py = static_cast<double>(row) + 0.5;
  double oi = nan, oj = nan;
  for (int q = 0; q < (w - 1) * (w - 1); ++q) {
    const int qj = q / (w - 1), qi = q - qj * (w - 1);
    const int n0 = qj * w + qi;
    const double p0x = wx[n0], p1x = wx[n0 + 1], p2x = wx[n0 + w], p3x = wx[n0 + w + 1];
    const double p0y = wy[n0], p1y = wy[n0 + 1], p2y = wy[n0 + w], p3y = wy[n0 + w + 1];
    const double gi = static_cast<double>(bi + qi), gj = static_cast<double>(bj + qj);
    double u, v;
    if (tri_accepts(tri_det(p0x, p0y, p1x, p1y, p2x, p2y), px, py, p0x, p0y, p1x, p1y, p2x,
                    p2y, a.u_min, a.uv_max, u, v)) {
      oi = gi + clip01(u);
      oj = gj + clip01(v);
      break;
    }
    if (tri_accepts(tri_det(p3x, p3y, p2x, p2y, p1x, p1y), px, py, p3x, p3y, p2x, p2y, p1x,
                    p1y, a.u_min, a.uv_max, u, v)) {
      oi = (gi + 1.0) - clip01(u);
      oj = (gj + 1.0) - clip01(v);
      break;
    }
  }
  const int64_t o = row * a.dst_w + col;
  a.out[o] = oi;
  a.out[a.dst_h * a.dst_w + o] = oj;
}

}  // namespace

// K20 on float64 (src_h, src_w) gx, gy (normalised): the n listed tiles
// (tiles, int32, or nullptr for tiles 0 .. n - 1) of tile x tile pixels,
// n_ti across, each at its window origin (bjs, bis, int32, n each) with a
// window of win x win nodes, written into out (2, dst_h, dst_w) float64.
extern "C" int xrt_phase_a_tiled(const double* gx, const double* gy, int64_t src_h,
                                 int64_t src_w, const int* tiles, const int* bjs,
                                 const int* bis, int64_t n, int64_t win, int64_t tile,
                                 int64_t n_ti, int64_t dst_h, int64_t dst_w, double uv_delta,
                                 double* out, void* stream) {
  const size_t smem = 16 * static_cast<size_t>(win) * static_cast<size_t>(win);
  if (src_h < 1 || src_w < 1 || n < 0 || n > INT_MAX || win < 2 || tile < 1 || tile > 32 ||
      n_ti < 1 || dst_h < 1 || dst_w < 1 || smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const TiledArgs a{gx, gy, src_h, src_w, tiles, bjs, bis, static_cast<int>(win),
                    static_cast<int>(tile), n_ti, dst_h, dst_w, -uv_delta, 1.0 + 2 * uv_delta,
                    out};
  tiled_kernel<<<static_cast<unsigned>(n), static_cast<unsigned>(tile * tile), smem,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
