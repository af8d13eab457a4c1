// K19 `phase_a_walk`: the Newton-walk Phase A of rectify, a planner-free
// inverse map, in float64.
//
// Replaces the XLA kernel of xcube_resampling_tpu/ops/rectify_ops.py
// _build_walk_kernel (:1482-1621, reached through inverse_ij_map_walk
// :1622): on the swath's coordinates normalised to the target's pixel
// units, a global least-squares affine seed (_affine_seed :1449); a
// coarse_iters-step quad walk (_walk_steps_flat :1421) from it for one
// sample a coarse_stride x coarse_stride block of target pixels (at the
// block's first pixel centre); a nearest upsample of the coarse quads and
// a fine_iters-step walk for every pixel centre; then the exact acceptance:
// of the 3 x 3 quads around the walk's quad (clamped to the swath), the one
// of lowest row-major rank whose triangle A or B accepts the pixel
// (true divisions, _tri_solve_flat :1400), its (i, j) from that triangle,
// NaN where none accepts.  The host gates the swath first (the port's copy
// of _walk_gate): finite, fold-free, no quad edge past the target's extent.
// Built with -fmad=false: fma() stands where XLA's CPU backend contracts
// the JAX kernel's float64 formulas (phase_a_common.h), so the map equals
// JAX's float64 walk bit for bit.
//
// Three launches:
//   1. K11's seed_pass (phase_a_common.h): the affine seed's sums in one
//      read of the swath, a fixed grid of blocks writing partial sums (its
//      gate flags are not read: the host's gate decides);
//   2. walk_coarse, a thread a coarse sample: each block reduces the
//      partials in one fixed order to the seed (seed_of), the sample's
//      starting quad, and its walk;
//   3. walk_fine, a thread a target pixel: its block's coarse quad, the
//      fine walk, the 3 x 3 acceptance, the map written once.
// A walk ends early, exactly, at a fixed point or in a two-quad cycle (K11's
// walk).  The seed's sums regroup the plain version's (moments about the
// centre node, in blocks): the seed may differ in its last bits, which can
// move only a coarse sample's starting quad; the maps are held equal to the
// plain version's on the card (chip_smoke.py) and the plain version to JAX's
// on the CPU (tests/test_torch_phase_a_device.py).
//
// Bound on the H100: device memory for the swath's read and the map's
// write; the work is some 30 float64 operations a walk step and 9
// triangle pairs a pixel, two divisions each, a few hundred operations a
// pixel, which at 34 TFLOP/s of float64 is of the same order as the bytes.
// The design keeps every step's four corners in L1 (neighbouring pixels
// walk to neighbouring quads) and reads nothing else.
#include "phase_a_common.h"

namespace {

constexpr int kWalkThreads = 256;

struct WalkArgs {
  const double* gx;
  const double* gy;
  Swath s;
  int64_t dst_h, dst_w, ch, cw;
  int stride, coarse_iters, fine_iters;
  double u_min, uv_max;
  const double* partials;  // seed_pass's
  int* cq;                 // (2, ch, cw): the coarse samples' quads, j then i
  double* out;             // (2, dst_h, dst_w)
};

__global__ void __launch_bounds__(kWalkThreads) walk_coarse(const WalkArgs a) {
  __shared__ double sh[(kWalkThreads / 32) * kNStats];
  __shared__ double seed[6];  // xm, ym, ai, bi, aj, bj
  seed_of(a.gx, a.gy, 0.0, a.s, a.partials, kWalkThreads, sh, seed);
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kWalkThreads + threadIdx.x;
  if (k >= a.ch * a.cw) return;
  const int64_t cj = k / a.cw, ci = k - cj * a.cw;
  const double px = static_cast<double>(ci) * a.stride + 0.5;
  const double py = static_cast<double>(cj) * a.stride + 0.5;
  const double im = static_cast<double>(a.s.w - 1) / 2.0;
  const double jm = static_cast<double>(a.s.h - 1) / 2.0;
  const double dx = px - seed[0], dy = py - seed[1];
  int64_t qi = to_int32(nan_to_num(fma(seed[3], dy, fma(seed[2], dx, im)), im));
  int64_t qj = to_int32(nan_to_num(fma(seed[5], dy, fma(seed[4], dx, jm)), jm));
  qi = clamp64(qi, 0, a.s.w - 2);
  qj = clamp64(qj, 0, a.s.h - 2);
  walk(a.gx, a.gy, 0.0, a.s, qj, qi, px, py, a.coarse_iters);
  a.cq[k] = static_cast<int>(qj);
  a.cq[a.ch * a.cw + k] = static_cast<int>(qi);
}

__global__ void __launch_bounds__(kWalkThreads) walk_fine(const WalkArgs a) {
  const int64_t n = a.dst_h * a.dst_w;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWalkThreads + threadIdx.x;
  if (p >= n) return;
  const int64_t row = p / a.dst_w, col = p - row * a.dst_w;
  const int64_t k = (row / a.stride) * a.cw + col / a.stride;
  int64_t qj = a.cq[k], qi = a.cq[a.ch * a.cw + k];
  const double px = static_cast<double>(col) + 0.5, py = static_cast<double>(row) + 0.5;
  walk(a.gx, a.gy, 0.0, a.s, qj, qi, px, py, a.fine_iters);
  const int64_t w = a.s.w, nqj = a.s.h - 1, nqi = a.s.w - 1;
  int64_t best = INT_MAX;
  double oi = __longlong_as_double(0x7ff8000000000000LL), oj = oi;  // NaN
  for (int c = 0; c < 9; ++c) {
    const int64_t cj = clamp64(qj + c / 3 - 1, 0, nqj - 1);
    const int64_t ci = clamp64(qi + c % 3 - 1, 0, nqi - 1);
    const int64_t rank = cj * nqi + ci;
    if (rank >= best) continue;  // (its acceptance could not change the winner)
    const int64_t i0 = cj * w + ci;
    const double p0x = a.gx[i0], p1x = a.gx[i0 + 1], p2x = a.gx[i0 + w], p3x = a.gx[i0 + w + 1];
    const double p0y = a.gy[i0], p1y = a.gy[i0 + 1], p2y = a.gy[i0 + w], p3y = a.gy[i0 + w + 1];
    const double gi = static_cast<double>(ci), gj = static_cast<double>(cj);
    double u, v;
    if (tri_accepts(tri_det(p0x, p0y, p1x, p1y, p2x, p2y), px, py, p0x, p0y, p1x, p1y, p2x, p2y,
                    a.u_min, a.uv_max, u, v)) {
      best = rank;
      oi = gi + clip01(u);
      oj = gj + clip01(v);
    } else if (tri_accepts(tri_det(p3x, p3y, p2x, p2y, p1x, p1y), px, py, p3x, p3y, p2x, p2y,
                           p1x, p1y, a.u_min, a.uv_max, u, v)) {
      best = rank;
      oi = (gi + 1.0) - clip01(u);
      oj = (gj + 1.0) - clip01(v);
    }
  }
  a.out[p] = oi;
  a.out[n + p] = oj;
}

}  // namespace

// K19 on float64 (src_h, src_w) gx, gy (normalised): out (2, dst_h, dst_w)
// float64; scratch (kPassBlocks * kStats float64) and cq (2 * ch * cw int32,
// ch x cw the coarse samples) are the wrapper's.  Three launches.
extern "C" int xrt_phase_a_walk(const double* gx, const double* gy, int64_t src_h,
                                int64_t src_w, int64_t dst_h, int64_t dst_w, int64_t stride,
                                int64_t coarse_iters, int64_t fine_iters, double uv_delta,
                                double* scratch, int* cq, double* out, void* stream) {
  if (src_h < 2 || src_w < 2 || src_h * src_w > (int64_t{1} << 30) || dst_h < 1 ||
      dst_w < 1 || stride < 1 || stride > INT_MAX || coarse_iters < 0 ||
      coarse_iters > INT_MAX || fine_iters < 0 || fine_iters > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ch = (dst_h + stride - 1) / stride, cw = (dst_w + stride - 1) / stride;
  const int64_t n_coarse = (ch * cw + kWalkThreads - 1) / kWalkThreads;
  const int64_t n_fine = (dst_h * dst_w + kWalkThreads - 1) / kWalkThreads;
  if (n_fine > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Swath s{src_h, src_w};
  const WalkArgs a{gx, gy, s, dst_h, dst_w, ch, cw, static_cast<int>(stride),
                   static_cast<int>(coarse_iters), static_cast<int>(fine_iters), -uv_delta,
                   1.0 + 2 * uv_delta, scratch, cq, out};
  const auto st = static_cast<cudaStream_t>(stream);
  seed_pass<double><<<kPassBlocks, kPassThreads, 0, st>>>(gx, gy, 0.0, s, 0.0, scratch, nullptr);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  walk_coarse<<<static_cast<unsigned>(n_coarse), kWalkThreads, 0, st>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  walk_fine<<<static_cast<unsigned>(n_fine), kWalkThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
