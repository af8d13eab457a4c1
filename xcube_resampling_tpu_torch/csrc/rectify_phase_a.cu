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
//   1. one block a work item, a patch of kPatchW x kPatchH quads of one
//      tile's window (the wrapper's table gives each tile's first item
//      and patches across; a block finds its tile by a binary search over
//      the first items, so no block idles): the patch's corners are staged
//      in shared memory with their floored destination coordinates, each
//      computed once
//      (the same operation on the same operands as the host's, so the
//      same result, though four quads share a corner); a thread takes one
//      quad, its pixel rectangle and determinants; then each warp deals its
//      32 quads' candidate pixels out evenly over its lanes (an exclusive
//      prefix sum by __shfl_up_sync, each lane finding its candidate's
//      quad by a binary search over the sums), and for each candidate
//      whose triangle solve accepts, an atomicMin of the quad's
//      window-local row-major rank into the pixel's claim (the first
//      writer of the sequential loop is the least rank, and the least does
//      not depend on the order of the atomics);
//   2. one thread a pixel: the winner's solve again (the same operations on
//      the same operands, so the same result) and its source indices,
//      offset by the window's origin after the solve, as the host adds them.
// Tiles whose window is empty have no work items: their pixels stay NaN.
// Indices are 32-bit (the wrapper refuses swaths and maps of 2^31 pixels or
// more) and the inner loops divide no integers; the triangle solves and
// the rectangle's floors keep their true float64 divisions.
//
// Bound on the H100: float64 operations where quads cover many pixels
// (about 30 a candidate pixel, two divisions among them), else bytes (the
// swath's coordinates, read once per window that holds them; the map
// written once).  What held the first design at 23.5x its bound (R1):
// blocks sized for the largest window idled on every smaller one, 64-bit
// integer divisions a quad and a pixel, every corner read and floored by
// four quads, lanes of a warp looping over rectangles of unequal size, and
// a candidate's solve waiting on a scattered read of its pixel's claim.
// Design: the work items and the warp's even deal of candidates above;
// a candidate solves without reading the claim first (the solve is
// cheaper than the wait) and claims where it accepts, a v solved only
// where its u passes; both passes capped at 64 registers so that an SM
// holds four blocks (kMinBlocks; tools/tune_phase_a.py times the cap).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPatchW = 32;  // quads a patch across: a lane each
constexpr int kPatchH = 8;   // quad rows a patch: a warp each
constexpr int kThreads = kPatchW * kPatchH;
// blocks an SM must hold in either pass: 64 registers a thread
constexpr int kMinBlocks = 4;
constexpr int kCornerW = kPatchW + 1;
constexpr int kCornerH = kPatchH + 1;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the claim buffer's initial value (cudaMemsetAsync with 0x7F bytes): more
// than any window-local rank the wrapper lets through
constexpr int kFree = 0x7F7F7F7F;

struct Args {
  const double* sx;     // (src_h, src_w) swath x in the target CRS
  const double* sy;
  int src_w;
  const int64_t* itab;  // per tile: row0, col0, th, tw, i_lo, j_lo, win_w, win_h
  const double* dtab;   // per tile: x origin, y origin
  const int* ptab;      // per tile: its first work item, its patches across
  int n_tiles, tile_h, tile_w, n_tiles_x, out_h, out_w;
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

// The quad's triangle determinants, NaN taken as 0
__device__ __forceinline__ void set_dets(Quad& q) {
  q.det_a = fdet(q.p0x, q.p0y, q.p1x, q.p1y, q.p2x, q.p2y);
  q.det_b = fdet(q.p3x, q.p3y, q.p2x, q.p2y, q.p1x, q.p1y);
  if (isnan(q.det_a)) q.det_a = 0.0;
  if (isnan(q.det_b)) q.det_b = 0.0;
}

__device__ __forceinline__ Quad load_quad(const Args& a, int j, int i) {
  Quad q;
  const int o = j * a.src_w + i;
  q.p0x = a.sx[o];
  q.p1x = a.sx[o + 1];
  q.p2x = a.sx[o + a.src_w];
  q.p3x = a.sx[o + a.src_w + 1];
  q.p0y = a.sy[o];
  q.p1y = a.sy[o + 1];
  q.p2y = a.sy[o + a.src_w];
  q.p3y = a.sy[o + a.src_w + 1];
  set_dets(q);
  return q;
}

// The two triangle solves of _accept_quad for destination point (dx, dy);
// on acceptance the window-local fractional source indices.
// (v is solved only where u passes: the same values, fewer divisions.)
__device__ __forceinline__ bool accept(const Quad& q, double dx, double dy, int qi, int qj,
                                       const Args& a, double& si, double& sj) {
  if (q.det_a != 0.0) {
    const double u = fu(dx, dy, q.p0x, q.p0y, q.p2x, q.p2y) / q.det_a;
    const double v = u >= a.u_min ? fv(dx, dy, q.p0x, q.p0y, q.p1x, q.p1y) / q.det_a : 0.0;
    if (u >= a.u_min && v >= a.u_min && u + v <= a.uv_max) {
      si = static_cast<double>(qi) + fclamp(u);
      sj = static_cast<double>(qj) + fclamp(v);
      return true;
    }
  }
  if (q.det_b != 0.0) {
    const double u = fu(dx, dy, q.p3x, q.p3y, q.p1x, q.p1y) / q.det_b;
    const double v = u >= a.u_min ? fv(dx, dy, q.p3x, q.p3y, q.p2x, q.p2y) / q.det_b : 0.0;
    if (u >= a.u_min && v >= a.u_min && u + v <= a.uv_max) {
      si = static_cast<double>(qi + 1) - fclamp(u);
      sj = static_cast<double>(qj + 1) - fclamp(v);
      return true;
    }
  }
  return false;
}

// x / d for d >= 1 without an integer division below 2^22: the float
// quotient is within one of the true one there, and corrected
__device__ __forceinline__ unsigned quotient(unsigned x, unsigned d) {
  if (x >= (1u << 22)) return x / d;
  unsigned q = __float2uint_rz(__uint2float_rn(x) * __frcp_rn(__uint2float_rn(d)));
  if (q * d > x) --q;
  if ((q + 1) * d <= x) ++q;
  return q;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) claim_kernel(const Args a) {
  __shared__ double s_x[kCornerH][kCornerW], s_y[kCornerH][kCornerW];
  __shared__ double s_fi[kCornerH][kCornerW], s_fj[kCornerH][kCornerW];
  __shared__ double s_det_a[kPatchH][kPatchW], s_det_b[kPatchH][kPatchW];
  __shared__ unsigned long long s_first[kPatchH][kPatchW];  // a quad's first candidate
  __shared__ int s_di[kPatchH][kPatchW], s_dj[kPatchH][kPatchW], s_rw[kPatchH][kPatchW];

  // the block's tile: the last whose first work item is at most this one
  // (a tile without items shares its first with the next one)
  const int item = blockIdx.x;
  int tile = 0;
  for (int hi = a.n_tiles - 1; tile < hi;) {
    const int mid = (tile + hi + 1) >> 1;
    if (a.ptab[2 * mid] <= item) {
      tile = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int local = item - a.ptab[2 * tile];
  const int across = a.ptab[2 * tile + 1];
  const int qj0 = local / across * kPatchH;  // one division a block
  const int qi0 = (local - local / across * across) * kPatchW;
  const int64_t* t = a.itab + 8 * tile;
  const int row0 = static_cast<int>(t[0]), col0 = static_cast<int>(t[1]);
  const int th = static_cast<int>(t[2]), tw = static_cast<int>(t[3]);
  const int i_lo = static_cast<int>(t[4]), j_lo = static_cast<int>(t[5]);
  const int qw = static_cast<int>(t[6]) - 1, qh = static_cast<int>(t[7]) - 1;
  const double x_off = a.dtab[2 * tile];
  const double y_off = a.dtab[2 * tile + 1];
  const int pw = min(kPatchW, qw - qi0);  // the patch's quads across and down
  const int ph = min(kPatchH, qh - qj0);
  const int lane = threadIdx.x;
  const int w = threadIdx.y;

  for (int c = w * kPatchW + lane; c < kCornerH * kCornerW; c += kThreads) {
    const int r = c / kCornerW;  // a constant divisor: a multiply and a shift
    const int cc = c - r * kCornerW;
    if (r <= ph && cc <= pw) {
      const int o = (j_lo + qj0 + r) * a.src_w + i_lo + qi0 + cc;
      const double x = a.sx[o], y = a.sy[o];
      s_x[r][cc] = x;
      s_y[r][cc] = y;
      s_fi[r][cc] = floor((x - x_off) / a.x_scale);
      s_fj[r][cc] = floor((y - y_off) / a.y_scale);
    }
  }
  __syncthreads();

  // this thread's quad (w, lane) of the patch: its candidate pixels
  unsigned long long n = 0;
  if (lane < pw && w < ph) {
    const int rr[4] = {w, w, w + 1, w + 1};
    const int cc[4] = {lane, lane + 1, lane, lane + 1};
    bool finite = true;
    double fimin = 0.0, fimax = 0.0, fjmin = 0.0, fjmax = 0.0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      finite = finite && !isnan(s_x[rr[c]][cc[c]]) && !isnan(s_y[rr[c]][cc[c]]);
      const double fi = s_fi[rr[c]][cc[c]];
      const double fj = s_fj[rr[c]][cc[c]];
      fimin = c == 0 ? fi : fmin(fimin, fi);
      fimax = c == 0 ? fi : fmax(fimax, fi);
      fjmin = c == 0 ? fj : fmin(fjmin, fj);
      fjmax = c == 0 ? fj : fmax(fjmax, fj);
    }
    if (finite && !isnan(fimin) && !isnan(fjmin) && !(fimax < 0 || fjmax < 0) &&
        fimin < static_cast<double>(tw) && fjmin < static_cast<double>(th)) {
      Quad q;
      q.p0x = s_x[w][lane], q.p0y = s_y[w][lane];
      q.p1x = s_x[w][lane + 1], q.p1y = s_y[w][lane + 1];
      q.p2x = s_x[w + 1][lane], q.p2y = s_y[w + 1][lane];
      q.p3x = s_x[w + 1][lane + 1], q.p3y = s_y[w + 1][lane + 1];
      set_dets(q);
      if (q.det_a != 0.0 || q.det_b != 0.0) {
        const int di_lo = static_cast<int>(fmax(fimin, 0.0));
        const int di_hi = static_cast<int>(fmin(fimax, static_cast<double>(tw - 1)));
        const int dj_lo = static_cast<int>(fmax(fjmin, 0.0));
        const int dj_hi = static_cast<int>(fmin(fjmax, static_cast<double>(th - 1)));
        s_det_a[w][lane] = q.det_a;
        s_det_b[w][lane] = q.det_b;
        s_di[w][lane] = di_lo;
        s_dj[w][lane] = dj_lo;
        s_rw[w][lane] = di_hi - di_lo + 1;
        n = static_cast<unsigned long long>(di_hi - di_lo + 1) * (dj_hi - dj_lo + 1);
      }
    }
  }
  // the warp's candidates, numbered quad by quad
  unsigned long long incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  const unsigned long long total = __shfl_sync(kFull, incl, 31);
  s_first[w][lane] = incl - n;
  __syncwarp();

  const int qj = qj0 + w;
  const int rank0 = qj * qw + qi0;  // the row's first quad's rank
  for (unsigned long long base = 0; base < total; base += 32) {
    const unsigned long long c = base + lane;
    if (c >= total) break;
    // the candidate's quad: the last whose first candidate is at most c
    // (a quad without candidates shares its first with the next one)
    int q = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (s_first[w][q + step] <= c) q += step;
    }
    const unsigned local = static_cast<unsigned>(c - s_first[w][q]);
    const unsigned rw = static_cast<unsigned>(s_rw[w][q]);
    const unsigned dj = quotient(local, rw);
    const int px = s_di[w][q] + static_cast<int>(local - dj * rw);
    const int py = s_dj[w][q] + static_cast<int>(dj);
    const int rank = rank0 + q;
    Quad qd;
    qd.p0x = s_x[w][q], qd.p0y = s_y[w][q];
    qd.p1x = s_x[w][q + 1], qd.p1y = s_y[w][q + 1];
    qd.p2x = s_x[w + 1][q], qd.p2y = s_y[w + 1][q];
    qd.p3x = s_x[w + 1][q + 1], qd.p3y = s_y[w + 1][q + 1];
    qd.det_a = s_det_a[w][q];
    qd.det_b = s_det_b[w][q];
    const double dy = y_off + (static_cast<double>(py) + 0.5) * a.y_scale;
    const double dx = x_off + (static_cast<double>(px) + 0.5) * a.x_scale;
    double si, sj;
    if (accept(qd, dx, dy, qi0 + q, qj, a, si, sj)) {
      atomicMin(a.claim + (row0 + py) * a.out_w + col0 + px, rank);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) write_kernel(const Args a) {
  const int n = a.out_h * a.out_w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int rank = a.claim[p];
  double oi = __longlong_as_double(0x7ff8000000000000LL);  // NaN
  double oj = oi;
  if (rank != kFree) {
    const int row = p / a.out_w;
    const int col = p - row * a.out_w;
    const int tile = (row / a.tile_h) * a.n_tiles_x + col / a.tile_w;
    const int64_t* t = a.itab + 8 * tile;
    const int qw = static_cast<int>(t[6]) - 1;
    const int qj = rank / qw;
    const int qi = rank - qj * qw;
    const int i_lo = static_cast<int>(t[4]), j_lo = static_cast<int>(t[5]);
    const Quad qd = load_quad(a, j_lo + qj, i_lo + qi);
    const double dy =
        a.dtab[2 * tile + 1] + (static_cast<double>(row - static_cast<int>(t[0])) + 0.5) * a.y_scale;
    const double dx =
        a.dtab[2 * tile] + (static_cast<double>(col - static_cast<int>(t[1])) + 0.5) * a.x_scale;
    double si, sj;
    if (accept(qd, dx, dy, qi, qj, a, si, sj)) {
      oi = static_cast<double>(i_lo) + si;
      oj = static_cast<double>(j_lo) + sj;
    }
  }
  a.out[p] = oi;
  a.out[static_cast<int64_t>(n) + p] = oj;
}

}  // namespace

// sx, sy (src_h, src_w) float64; itab (n_tiles, 8) int64 and dtab
// (n_tiles, 2) float64, row-major over the target's tiles of tile_h x
// tile_w (n_tiles_x across); ptab (n_tiles, 2) int32, each tile's first
// work item and its patches of patch_w x patch_h quads across (which must
// be the kernel's), n_items work items in all; claim (out_h * out_w) int32
// scratch; out (2, out_h, out_w) float64.
extern "C" int xrt_rectify_phase_a(
    const double* sx, const double* sy, int64_t src_h, int64_t src_w,
    const int64_t* itab, const double* dtab, int64_t n_tiles, const int* ptab,
    int64_t n_items, int64_t patch_w, int64_t patch_h, int64_t tile_h, int64_t tile_w,
    int64_t n_tiles_x, int64_t out_h, int64_t out_w, double x_scale, double y_scale,
    double uv_delta, int* claim, double* out, void* stream) {
  constexpr int64_t kMax = (int64_t{1} << 31) - 1;
  if (src_h < 1 || src_w < 1 || src_h * src_w > kMax || n_tiles < 1 || n_tiles > kMax ||
      n_items < 0 || n_items > kMax || patch_w != kPatchW || patch_h != kPatchH ||
      tile_h < 1 || tile_w < 1 || n_tiles_x < 1 || out_h < 1 || out_w < 1 ||
      out_h * out_w > kMax - kThreads) {
    return 1;  // cudaErrorInvalidValue
  }
  const Args a{sx, sy, static_cast<int>(src_w), itab, dtab, ptab, static_cast<int>(n_tiles),
               static_cast<int>(tile_h), static_cast<int>(tile_w), static_cast<int>(n_tiles_x),
               static_cast<int>(out_h), static_cast<int>(out_w),
               x_scale, y_scale, -uv_delta, 1.0 + 2.0 * uv_delta, claim, out};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(claim, 0x7F, sizeof(int) * out_h * out_w, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n_items > 0) {
    claim_kernel<<<static_cast<unsigned>(n_items), dim3(kPatchW, kPatchH), 0, s>>>(a);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  write_kernel<<<static_cast<unsigned>((out_h * out_w + kThreads - 1) / kThreads), kThreads,
                 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
