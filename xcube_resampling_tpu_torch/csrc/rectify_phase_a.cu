// K8: rectify Phase A, the per-pixel fractional source (i, j) map, in
// float64.
//
// Computes what the JAX package's host tier computes: per destination tile
// (xcube_resampling_tpu/rectify.py:_inverse_ij_map_tile, :452-491), its
// source window from the bbox scan and its own origin, through
// ops/rectify_ops.py:inverse_ij_map (:44-300, native/phase_a.cpp): each
// source quad's destination pixel rectangle from its floored corners, the
// two barycentric triangle solves of _accept_quad with uv_delta, and the
// first writer in row-major quad order of the window winning each pixel.
// Its device counterpart in the JAX package is _phase_a_scan (:303, through
// _inverse_ij_map_device_scatter, :502), which works on the whole image in
// float32-normalised units and agrees with the host only to rtol 1e-12;
// this kernel keeps each tile's window, origin and window-local quad
// indices, so it equals the host tier bit for bit (built with -fmad=false:
// every product and sum rounded as the host's C++ and numpy round them).
//
// Two passes:
//   1. one grid over (destination tile, quad of that tile's window): a
//      thread takes its quad's pixel rectangle and, for each pixel whose
//      triangle solve accepts, an atomicMin of the quad's window-local
//      row-major rank into the pixel's claim (the first writer of the
//      sequential loop is the least rank);
//   2. one thread a pixel: the winner's solve again (the same operations on
//      the same operands, so the same result) and its source indices,
//      offset by the window's origin after the solve, as the host adds them.
// Tiles whose window is empty keep no claim: their pixels stay NaN.
//
// Bound on the H100: float64 operations where quads cover many pixels
// (about 30 a candidate pixel, two divisions among them), else bytes (the
// swath's coordinates, read once per window that holds them; the map
// written once).  Design: the solves are the work, and a pass-1 thread only
// touches its own quad's four corners; pass 2 repeats one solve a pixel
// instead of storing every candidate's result.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the claim buffer's initial value (cudaMemsetAsync with 0x7F bytes): more
// than any window-local rank the wrapper lets through
constexpr int kFree = 0x7F7F7F7F;

struct Args {
  const double* sx;     // (src_h, src_w) swath x in the target CRS
  const double* sy;
  int64_t src_w;
  const int64_t* itab;  // per tile: row0, col0, th, tw, i_lo, j_lo, win_w, win_h
  const double* dtab;   // per tile: x origin, y origin
  int64_t tile_h, tile_w, n_tiles_x, out_h, out_w;
  double x_scale, y_scale, u_min, uv_max;
  int* claim;           // (out_h * out_w)
  double* out;          // (2, out_h, out_w)
};

__device__ __forceinline__ double fdet(double px0, double py0, double px1, double py1,
                                       double px2, double py2) {
  return (px0 - px1) * (py0 - py2) - (px0 - px2) * (py0 - py1);
}

__device__ __forceinline__ double fu(double px, double py, double px0, double py0,
                                     double px2, double py2) {
  return (px0 - px) * (py0 - py2) - (py0 - py) * (px0 - px2);
}

__device__ __forceinline__ double fv(double px, double py, double px0, double py0,
                                     double px1, double py1) {
  return (py0 - py) * (px0 - px1) - (px0 - px) * (py0 - py1);
}

__device__ __forceinline__ double fclamp(double x) {
  return x < 0.0 ? 0.0 : (x > 1.0 ? 1.0 : x);
}

// A quad's corners: p0 (j, i), p1 (j, i + 1), p2 (j + 1, i), p3 (j + 1, i + 1)
struct Quad {
  double p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y, det_a, det_b;
};

__device__ __forceinline__ Quad load_quad(const Args& a, int64_t j, int64_t i) {
  Quad q;
  const int64_t o = j * a.src_w + i;
  q.p0x = a.sx[o];
  q.p1x = a.sx[o + 1];
  q.p2x = a.sx[o + a.src_w];
  q.p3x = a.sx[o + a.src_w + 1];
  q.p0y = a.sy[o];
  q.p1y = a.sy[o + 1];
  q.p2y = a.sy[o + a.src_w];
  q.p3y = a.sy[o + a.src_w + 1];
  q.det_a = fdet(q.p0x, q.p0y, q.p1x, q.p1y, q.p2x, q.p2y);
  q.det_b = fdet(q.p3x, q.p3y, q.p2x, q.p2y, q.p1x, q.p1y);
  if (isnan(q.det_a)) q.det_a = 0.0;
  if (isnan(q.det_b)) q.det_b = 0.0;
  return q;
}

// The two triangle solves of _accept_quad for destination point (dx, dy);
// on acceptance the window-local fractional source indices.
__device__ __forceinline__ bool accept(const Quad& q, double dx, double dy, int64_t qi,
                                       int64_t qj, const Args& a, double& si, double& sj) {
  if (q.det_a != 0.0) {
    const double u = fu(dx, dy, q.p0x, q.p0y, q.p2x, q.p2y) / q.det_a;
    const double v = fv(dx, dy, q.p0x, q.p0y, q.p1x, q.p1y) / q.det_a;
    if (u >= a.u_min && v >= a.u_min && u + v <= a.uv_max) {
      si = static_cast<double>(qi) + fclamp(u);
      sj = static_cast<double>(qj) + fclamp(v);
      return true;
    }
  }
  if (q.det_b != 0.0) {
    const double u = fu(dx, dy, q.p3x, q.p3y, q.p1x, q.p1y) / q.det_b;
    const double v = fv(dx, dy, q.p3x, q.p3y, q.p2x, q.p2y) / q.det_b;
    if (u >= a.u_min && v >= a.u_min && u + v <= a.uv_max) {
      si = static_cast<double>(qi + 1) - fclamp(u);
      sj = static_cast<double>(qj + 1) - fclamp(v);
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(kThreads) claim_kernel(const Args a) {
  const int64_t* t = a.itab + 8 * static_cast<int64_t>(blockIdx.y);
  const int64_t row0 = t[0], col0 = t[1], th = t[2], tw = t[3];
  const int64_t i_lo = t[4], j_lo = t[5], win_w = t[6], win_h = t[7];
  if (win_w < 2 || win_h < 2) return;
  const double x_off = a.dtab[2 * blockIdx.y];
  const double y_off = a.dtab[2 * blockIdx.y + 1];
  const int64_t qw = win_w - 1;
  const int64_t nq = qw * (win_h - 1);
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; q < nq;
       q += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t qj = q / qw;
    const int64_t qi = q - qj * qw;
    const int64_t o = (j_lo + qj) * a.src_w + i_lo + qi;
    const double cx[4] = {a.sx[o], a.sx[o + 1], a.sx[o + a.src_w], a.sx[o + a.src_w + 1]};
    const double cy[4] = {a.sy[o], a.sy[o + 1], a.sy[o + a.src_w], a.sy[o + a.src_w + 1]};
    bool finite = true;
    double fimin = 0.0, fimax = 0.0, fjmin = 0.0, fjmax = 0.0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      finite = finite && !isnan(cx[c]) && !isnan(cy[c]);
      const double fi = floor((cx[c] - x_off) / a.x_scale);
      const double fj = floor((cy[c] - y_off) / a.y_scale);
      fimin = c == 0 ? fi : fmin(fimin, fi);
      fimax = c == 0 ? fi : fmax(fimax, fi);
      fjmin = c == 0 ? fj : fmin(fjmin, fj);
      fjmax = c == 0 ? fj : fmax(fjmax, fj);
    }
    if (!finite || isnan(fimin) || isnan(fjmin)) continue;
    if (fimax < 0 || fjmax < 0 || fimin >= static_cast<double>(tw) ||
        fjmin >= static_cast<double>(th)) {
      continue;
    }
    const Quad qd = load_quad(a, j_lo + qj, i_lo + qi);
    if (qd.det_a == 0.0 && qd.det_b == 0.0) continue;
    const int64_t di_lo = static_cast<int64_t>(fmax(fimin, 0.0));
    const int64_t di_hi = static_cast<int64_t>(fmin(fimax, static_cast<double>(tw - 1)));
    const int64_t dj_lo = static_cast<int64_t>(fmax(fjmin, 0.0));
    const int64_t dj_hi = static_cast<int64_t>(fmin(fjmax, static_cast<double>(th - 1)));
    const int rank = static_cast<int>(q);
    for (int64_t dj = dj_lo; dj <= dj_hi; ++dj) {
      const double dy = y_off + (static_cast<double>(dj) + 0.5) * a.y_scale;
      int* claim_row = a.claim + (row0 + dj) * a.out_w + col0;
      for (int64_t di = di_lo; di <= di_hi; ++di) {
        const double dx = x_off + (static_cast<double>(di) + 0.5) * a.x_scale;
        double si, sj;
        if (rank < claim_row[di] && accept(qd, dx, dy, qi, qj, a, si, sj)) {
          atomicMin(claim_row + di, rank);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) write_kernel(const Args a) {
  const int64_t n = a.out_h * a.out_w;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  const int rank = a.claim[p];
  double oi = __longlong_as_double(0x7ff8000000000000LL);  // NaN
  double oj = oi;
  if (rank != kFree) {
    const int64_t row = p / a.out_w;
    const int64_t col = p - row * a.out_w;
    const int64_t tile = (row / a.tile_h) * a.n_tiles_x + col / a.tile_w;
    const int64_t* t = a.itab + 8 * tile;
    const int64_t qw = t[6] - 1;
    const int64_t qj = rank / qw;
    const int64_t qi = rank - qj * qw;
    const Quad qd = load_quad(a, t[5] + qj, t[4] + qi);
    const double dy = a.dtab[2 * tile + 1] + (static_cast<double>(row - t[0]) + 0.5) * a.y_scale;
    const double dx = a.dtab[2 * tile] + (static_cast<double>(col - t[1]) + 0.5) * a.x_scale;
    double si, sj;
    if (accept(qd, dx, dy, qi, qj, a, si, sj)) {
      oi = static_cast<double>(t[4]) + si;
      oj = static_cast<double>(t[5]) + sj;
    }
  }
  a.out[p] = oi;
  a.out[n + p] = oj;
}

}  // namespace

// sx, sy (src_h, src_w) float64; itab (n_tiles, 8) int64 and dtab
// (n_tiles, 2) float64, row-major over the target's tiles of tile_h x
// tile_w (n_tiles_x across); claim (out_h * out_w) int32 scratch; out
// (2, out_h, out_w) float64.  max_quads: the largest window's quad count.
extern "C" int xrt_rectify_phase_a(
    const double* sx, const double* sy, int64_t src_h, int64_t src_w,
    const int64_t* itab, const double* dtab, int64_t n_tiles, int64_t max_quads,
    int64_t tile_h, int64_t tile_w, int64_t n_tiles_x, int64_t out_h, int64_t out_w,
    double x_scale, double y_scale, double uv_delta, int* claim, double* out,
    void* stream) {
  if (src_h < 1 || src_w < 1 || n_tiles < 1 || n_tiles > 65535 || max_quads < 0 ||
      max_quads >= kFree || tile_h < 1 || tile_w < 1 || out_h < 1 || out_w < 1) {
    return 1;  // cudaErrorInvalidValue
  }
  const Args a{sx, sy, src_w, itab, dtab, tile_h, tile_w, n_tiles_x, out_h, out_w,
               x_scale, y_scale, -uv_delta, 1.0 + 2.0 * uv_delta, claim, out};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(claim, 0x7F, sizeof(int) * out_h * out_w, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (max_quads > 0) {
    int64_t blocks = (max_quads + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    claim_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(n_tiles)),
                   kThreads, 0, s>>>(a);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  write_kernel<<<static_cast<unsigned>((out_h * out_w + kThreads - 1) / kThreads),
                 kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
