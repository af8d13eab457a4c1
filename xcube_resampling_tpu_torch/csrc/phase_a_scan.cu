// K21 `phase_a_scan`: the scatter-min Phase A of rectify over the whole
// image, in float64.
//
// Replaces the XLA kernel of xcube_resampling_tpu/ops/rectify_ops.py
// _phase_a_scan (:303-456, reached through inverse_ij_map_jax :459 and
// _inverse_ij_map_device_scatter :502): on the swath's coordinates
// normalised to the target's pixel units, each quad's destination pixel
// rectangle from its floored corners (NaN corners: a dead quad; infinities
// to the type's extremes, as jnp.nan_to_num takes them), clipped to the
// target; a quad is alive where its rectangle meets the target and a
// triangle's determinant is not 0.  Of its rectangle the r_j x r_i
// candidates from its clipped low corner are tested (the candidate k is
// row k / r_i, column k % r_i; inside the clipped [lo, hi] bounds), both
// triangles solved by true division; each pixel takes the accepting quad
// of lowest row-major rank (the reference's first writer), A's solve where
// A accepts, else B's; NaN where none accepts.  Built with -fmad=false:
// fma() stands where XLA contracts the JAX kernel's float64 formulas
// (phase_a_common.h), so the map equals JAX's float64 scan bit for bit.
//
// Design, the quad-parallel rasterise (ROADMAP's design stance on Hopper),
// two launches of a thread a quad over the same candidates: pass 1 lowers
// each accepting candidate's pixel claim (int32, the quad's rank) by
// atomicMin; pass 2 writes the winners' (i, j) where a candidate accepts
// and its pixel's claim is its own rank (one writer a pixel: ranks are
// unique).  The claims start at 0x7F7F7F7F (a byte fill, the wrapper keeps
// ranks below it) and the map at NaN (0xFF bytes).  Bound on the H100: the
// swath's read, the claims' and map's writes; the solves, about 30 float64
// operations and up to 4 divisions a candidate pixel, set the work.
#include "phase_a_common.h"

namespace {

constexpr int kScanThreads = 256;
constexpr int kFree = 0x7F7F7F7F;

struct ScanArgs {
  const double* gx;
  const double* gy;
  int64_t src_h, src_w, dst_h, dst_w;
  int r_i, r_j;
  double u_min, uv_max;
  int* claim;   // (dst_h, dst_w)
  double* out;  // (2, dst_h, dst_w)
};

// the least and the greatest of a quad's four floored corners
__device__ __forceinline__ double min4(double a, double b, double c, double d) {
  return fmin(fmin(a, b), fmin(c, d));
}

__device__ __forceinline__ double max4(double a, double b, double c, double d) {
  return fmax(fmax(a, b), fmax(c, d));
}

template <bool kWrite>
__global__ void __launch_bounds__(kScanThreads) scan_kernel(const ScanArgs a) {
  const int64_t nqi = a.src_w - 1;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (q >= nqi * (a.src_h - 1)) return;
  const int64_t qj = q / nqi, qi = q - qj * nqi;
  const int64_t k0 = qj * a.src_w + qi;
  const double p0x = a.gx[k0], p1x = a.gx[k0 + 1];
  const double p2x = a.gx[k0 + a.src_w], p3x = a.gx[k0 + a.src_w + 1];
  const double p0y = a.gy[k0], p1y = a.gy[k0 + 1];
  const double p2y = a.gy[k0 + a.src_w], p3y = a.gy[k0 + a.src_w + 1];
  double fi[4] = {floor(p0x), floor(p1x), floor(p2x), floor(p3x)};
  double fj[4] = {floor(p0y), floor(p1y), floor(p2y), floor(p3y)};
  for (int c = 0; c < 4; ++c) {
    if (isnan(fi[c]) || isnan(fj[c])) return;
    fi[c] = nan_to_num(fi[c], 0.0);  // (no NaN is left: infinities to the extremes)
    fj[c] = nan_to_num(fj[c], 0.0);
  }
  const double i_lo = min4(fi[0], fi[1], fi[2], fi[3]), i_hi = max4(fi[0], fi[1], fi[2], fi[3]);
  const double j_lo = min4(fj[0], fj[1], fj[2], fj[3]), j_hi = max4(fj[0], fj[1], fj[2], fj[3]);
  const double det_a = tri_det(p0x, p0y, p1x, p1y, p2x, p2y);
  const double det_b = tri_det(p3x, p3y, p2x, p2y, p1x, p1y);
  const double w = static_cast<double>(a.dst_w), h = static_cast<double>(a.dst_h);
  if (!(i_hi >= 0 && j_hi >= 0 && i_lo < w && j_lo < h && (det_a != 0 || det_b != 0))) return;
  const int64_t i0 = static_cast<int64_t>(fmin(fmax(i_lo, 0.0), w - 1));
  const int64_t i1 = static_cast<int64_t>(fmin(fmax(i_hi, 0.0), w - 1));
  const int64_t j0 = static_cast<int64_t>(fmin(fmax(j_lo, 0.0), h - 1));
  const int64_t j1 = static_cast<int64_t>(fmin(fmax(j_hi, 0.0), h - 1));
  const int rank = static_cast<int>(q);
  const double gi = static_cast<double>(qi), gj = static_cast<double>(qj);
  const int64_t n = a.dst_h * a.dst_w;
  for (int dj = 0; dj < a.r_j && j0 + dj <= j1; ++dj) {
    const int64_t row = j0 + dj;
    const double py = static_cast<double>(row) + 0.5;
    for (int di = 0; di < a.r_i && i0 + di <= i1; ++di) {
      const int64_t col = i0 + di;
      const double px = static_cast<double>(col) + 0.5;
      double u, v;
      bool use_b = false;
      if (!tri_accepts(det_a, px, py, p0x, p0y, p1x, p1y, p2x, p2y, a.u_min, a.uv_max, u, v)) {
        if (!tri_accepts(det_b, px, py, p3x, p3y, p2x, p2y, p1x, p1y, a.u_min, a.uv_max, u, v)) {
          continue;
        }
        use_b = true;
      }
      const int64_t o = row * a.dst_w + col;
      if (!kWrite) {
        atomicMin(a.claim + o, rank);
      } else if (a.claim[o] == rank) {
        a.out[o] = use_b ? (gi + 1.0) - clip01(u) : gi + clip01(u);
        a.out[n + o] = use_b ? (gj + 1.0) - clip01(v) : gj + clip01(v);
      }
    }
  }
}

}  // namespace

// K21 on float64 (src_h, src_w) gx, gy (normalised): out (2, dst_h, dst_w)
// float64, claim (dst_h * dst_w) int32 scratch; r_i x r_j candidates a quad.
// The wrapper keeps the quads' ranks below 0x7F7F7F7F.
extern "C" int xrt_phase_a_scan(const double* gx, const double* gy, int64_t src_h,
                                int64_t src_w, int64_t dst_h, int64_t dst_w, int64_t r_i,
                                int64_t r_j, double uv_delta, int* claim, double* out,
                                void* stream) {
  const int64_t nq = (src_h - 1) * (src_w - 1);
  if (src_h < 2 || src_w < 2 || nq >= kFree || dst_h < 1 || dst_w < 1 || r_i < 1 ||
      r_j < 1 || r_i > INT_MAX || r_j > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(dst_h) * static_cast<size_t>(dst_w);
  cudaError_t rc = cudaMemsetAsync(claim, 0x7F, sizeof(int) * n, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaMemsetAsync(out, 0xFF, 2 * sizeof(double) * n, st);  // NaN
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const ScanArgs a{gx, gy, src_h, src_w, dst_h, dst_w, static_cast<int>(r_i),
                   static_cast<int>(r_j), -uv_delta, 1.0 + 2 * uv_delta, claim, out};
  const auto blocks = static_cast<unsigned>((nq + kScanThreads - 1) / kScanThreads);
  scan_kernel<false><<<blocks, kScanThreads, 0, st>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  scan_kernel<true><<<blocks, kScanThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
