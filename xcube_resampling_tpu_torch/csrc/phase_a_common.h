// The pieces of rectify's device Phase A that K11 (csrc/hybrid_phase_a.cu),
// K19 (phase_a_walk.cu), K20 (phase_a_tiled.cu) and K21 (phase_a_scan.cu)
// share: the triangle formulas as XLA's CPU backend contracts them in the
// JAX package's float64 kernels (a * b - c * d is fma(a, b, -(c * d));
// ops/rectify_ops.py's _fdet_x, _fu_x, _fv_x), XLA's conversions, K11's one
// pass over the swath for the gate's flags and the affine seed's sums
// (seed_pass), the seed from those sums (seed_of), the quad walk (walk), and
// the triangle test by true division of the walk, the tiled stencil and the
// scan (tri_det, tri_accepts).  Everything is in an unnamed namespace: each
// source that includes it has its own copy.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

// K11's pass: blocks of kPassThreads threads, three an SM of an H100 (a
// fixed count, so that its sums run in a fixed order); a tile is
// kPassThreads columns by kPassRows rows, read kPassAhead rows ahead;
// kStats sums a block (the wrapper's scratch holds kPassBlocks * kStats)
constexpr int kPassThreads = 256;
constexpr int kPassBlocks = 396;
constexpr int kPassRows = 32;
constexpr int kPassAhead = 2;
constexpr int kStats = 10;

template <typename F>
__device__ __forceinline__ F fdet(F px0, F py0, F px1, F py1, F px2, F py2) {
  return fma(px0 - px1, py0 - py2, -((px0 - px2) * (py0 - py1)));
}

template <typename F>
__device__ __forceinline__ F fu(F px, F py, F px0, F py0, F px2, F py2) {
  return fma(px0 - px, py0 - py2, -((py0 - py) * (px0 - px2)));
}

template <typename F>
__device__ __forceinline__ F fv(F px, F py, F px0, F py0, F px1, F py1) {
  return fma(py0 - py, px0 - px1, -((px0 - px) * (py0 - py1)));
}

// jnp.nan_to_num(x, nan=v): infinities to the type's extremes
template <typename F>
__device__ __forceinline__ F nan_to_num(F x, F v) {
  if (x != x) return v;
  if (isinf(x)) return x > 0 ? F(DBL_MAX) : F(-DBL_MAX);
  return x;
}

// the int32 value of a float as XLA converts it: truncated, saturating
template <typename F>
__device__ __forceinline__ int64_t to_int32(F x) {
  if (x >= F(2147483647.0)) return INT_MAX;
  if (x <= F(-2147483648.0)) return INT_MIN;
  return static_cast<int64_t>(static_cast<int>(x));
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Swath {
  int64_t h, w;
};

// The pass's sums a block, in partials[block * kStats + k]: kGate the
// gate's flags (bits kFinite ... kEdge of an integer-valued float: every
// node finite, every determinant of triangle A negative, every one
// positive, the same for B, every quad edge at most max_edge; a NaN fails
// each as it fails jnp's max and min); kSx, kSy the sums of xs = x - kx and
// ys = y - ky, shifted by the centre node (kx, ky); kXX, kXY, kYY the sums
// of xs xs, xs ys, ys ys; kXI ... kYJ of xs di, ys di, xs dj, ys dj with
// di = i - im, dj = j - jm.
enum Stat { kGate, kSx, kSy, kXX, kXY, kYY, kXI, kYI, kXJ, kYJ, kNStats };
static_assert(kNStats == kStats, "the partials' layout");
enum GateBit { kFinite = 1, kANeg = 2, kAPos = 4, kBNeg = 8, kBPos = 16, kEdge = 32 };
constexpr int kGateAll = 63;

template <typename F>
__device__ __forceinline__ F combine(int k, F a, F b) {
  if (k == kGate) return F(static_cast<int>(a) & static_cast<int>(b));
  return a + b;
}

// v[k] reduced over the block (of *threads*, a multiple of 32) in a fixed
// order; the result in sh[k] on return (sh holds (threads / 32) * kNStats)
template <typename F>
__device__ void block_stats(F (&v)[kNStats], F* sh, int threads) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kNStats; ++k) {
    F x = v[k];
    for (int d = 16; d > 0; d >>= 1) x = combine(k, x, __shfl_down_sync(0xffffffffu, x, d));
    if (lane == 0) sh[warp * kNStats + k] = x;
  }
  __syncthreads();
  if (threadIdx.x < kNStats) {
    const int k = threadIdx.x;
    F x = sh[k];
    for (int w = 1; w < threads / 32; ++w) x = combine(k, x, sh[w * kNStats + k]);
    sh[k] = x;
  }
  __syncthreads();
}

// K11's pass: one read of both coordinate images for every sum of the
// gate and of the affine seed.  A block walks its tiles (t = block, block
// + kPassBlocks, ...); a thread a column of the tile, down its rows, with
// the previous row in registers for the quads above (their right-hand
// nodes from the next lane, lane 31 reading its own) and kPassAhead rows
// loaded ahead; the tile's last quad row reads one row below it.  The sums
// are fused multiply-adds, and a column's xs di, ys di are taken once a
// tile (di times the tile's sums of xs, ys).  Block 0 also opens meta's
// two needs (INT_MIN: maxima to come) where meta is not null.
template <typename F>
__global__ void __launch_bounds__(kPassThreads, 3)
    seed_pass(const F* __restrict__ gx, const F* __restrict__ gy, F r0, Swath s, F max_edge,
              F* __restrict__ partials, int* __restrict__ meta) {
  __shared__ F sh[(kPassThreads / 32) * kNStats];
  const int lane = threadIdx.x & 31;
  const int64_t kc = (s.h / 2) * s.w + s.w / 2;
  const F kx = gx[kc], ky = gy[kc] - r0;
  const F im = F(s.w - 1) / F(2), jm = F(s.h - 1) / F(2);
  F v[kNStats];
#pragma unroll
  for (int k = 0; k < kNStats; ++k) v[k] = F(0);
  int gate = kGateAll;
  const int64_t n_strips = (s.w + kPassThreads - 1) / kPassThreads;
  const int64_t n_tiles = n_strips * ((s.h + kPassRows - 1) / kPassRows);
  for (int64_t t = blockIdx.x; t < n_tiles; t += kPassBlocks) {
    const int64_t col = (t % n_strips) * kPassThreads + threadIdx.x;
    const int64_t r_begin = (t / n_strips) * kPassRows;
    const int64_t r_end = r_begin + kPassRows < s.h ? r_begin + kPassRows : s.h;
    const int64_t r_last = r_end < s.h ? r_end : s.h - 1;  // the last row read
    const bool in = col < s.w;
    const bool quad_col = col + 1 < s.w;
    F px = 0, py = 0, px1 = 0, py1 = 0;  // the row above, at col and col + 1
    F tx = 0, ty = 0;                    // the tile's sums of xs, ys
    for (int64_t r = r_begin; r <= r_last; r += kPassAhead) {
      F x[kPassAhead], y[kPassAhead];
#pragma unroll
      for (int u = 0; u < kPassAhead; ++u) {
        const int64_t k = (r + u) * s.w + col;
        const bool ok = in && r + u <= r_last;
        x[u] = ok ? gx[k] : F(0);
        y[u] = ok ? gy[k] - r0 : F(0);
      }
#pragma unroll
      for (int u = 0; u < kPassAhead; ++u) {
        const int64_t row = r + u;
        if (row > r_last) break;  // (the whole warp)
        F x1 = __shfl_down_sync(0xffffffffu, x[u], 1);
        F y1 = __shfl_down_sync(0xffffffffu, y[u], 1);
        if (lane == 31 && quad_col) {
          x1 = gx[row * s.w + col + 1];
          y1 = gy[row * s.w + col + 1] - r0;
        }
        if (in && row < r_end) {
          if (!(isfinite(x[u]) && isfinite(y[u]))) gate &= ~kFinite;
          const F xs = x[u] - kx, ys = y[u] - ky;
          const F dj = F(row) - jm;
          tx += xs;
          ty += ys;
          v[kXX] = fma(xs, xs, v[kXX]);
          v[kXY] = fma(xs, ys, v[kXY]);
          v[kYY] = fma(ys, ys, v[kYY]);
          v[kXJ] = fma(xs, dj, v[kXJ]);
          v[kYJ] = fma(ys, dj, v[kYJ]);
        }
        if (row > r_begin && quad_col) {
          // the quad of (row - 1, col): p0 above, p1 above right, p2, p3;
          // fdet's differences, which are the edges' too
          const F e1x = px - px1, e2y = py - y[u], e2x = px - x[u], e1y = py - py1;
          const F da = fma(e1x, e2y, -(e2x * e1y));
          const F db = fma(x1 - x[u], y1 - py1, -((x1 - px1) * (y1 - y[u])));
          if (!(da < 0)) gate &= ~kANeg;
          if (!(da > 0)) gate &= ~kAPos;
          if (!(db < 0)) gate &= ~kBNeg;
          if (!(db > 0)) gate &= ~kBPos;
          if (!(fabs(e1x) <= max_edge && fabs(e2x) <= max_edge && fabs(e1y) <= max_edge &&
                fabs(e2y) <= max_edge)) {
            gate &= ~kEdge;
          }
        }
        px = x[u];
        py = y[u];
        px1 = x1;
        py1 = y1;
      }
    }
    if (in) {
      const F di = F(col) - im;
      v[kSx] += tx;
      v[kSy] += ty;
      v[kXI] = fma(tx, di, v[kXI]);
      v[kYI] = fma(ty, di, v[kYI]);
    }
  }
  v[kGate] = F(gate);
  block_stats(v, sh, kPassThreads);
  if (threadIdx.x < kStats) {
    partials[blockIdx.x * kStats + threadIdx.x] = sh[threadIdx.x];
  }
  if (meta != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    meta[1] = INT_MIN;
    meta[2] = INT_MIN;
  }
}

// n_iters steps of the quad walk from (qj, qi) towards the point (px, py).
// A step depends on (qj, qi) alone, so the walk ends early, exactly: at a
// fixed point, and in a cycle of two quads (the walk bouncing off the
// swath's edge towards a point beyond it), where the parity of the steps
// left picks the quad it would end on.
template <typename F>
__device__ void walk(const F* __restrict__ gx, const F* __restrict__ gy, F r0, Swath s,
                     int64_t& qj, int64_t& qi, F px, F py, int n_iters) {
  const int64_t nqj = s.h - 1, nqi = s.w - 1;
  int64_t pj = -1, pi = -1;  // the quad before (qj, qi)
  for (int it = 0; it < n_iters; ++it) {
    const int64_t k = qj * s.w + qi;
    const F p0x = gx[k], p1x = gx[k + 1], p2x = gx[k + s.w], p3x = gx[k + s.w + 1];
    const F p0y = gy[k] - r0, p1y = gy[k + 1] - r0;
    const F p2y = gy[k + s.w] - r0, p3y = gy[k + s.w + 1] - r0;
    const F det_a = nan_to_num(fdet(p0x, p0y, p1x, p1y, p2x, p2y), F(0));
    const F det_b = nan_to_num(fdet(p3x, p3y, p2x, p2y, p1x, p1y), F(0));
    const F safe_a = det_a == 0 ? F(1) : det_a;
    const F safe_b = det_b == 0 ? F(1) : det_b;
    F di, dj;
    if (det_a != 0) {
      di = floor(fu(px, py, p0x, p0y, p2x, p2y) / safe_a);
      dj = floor(fv(px, py, p0x, p0y, p1x, p1y) / safe_a);
    } else {
      di = floor(F(1) - fu(px, py, p3x, p3y, p1x, p1y) / safe_b);
      dj = floor(F(1) - fv(px, py, p3x, p3y, p2x, p2y) / safe_b);
    }
    if (!isfinite(di)) di = 0;
    if (!isfinite(dj)) dj = 0;
    const int64_t ni = clamp64(qi + to_int32(di), 0, nqi - 1);
    const int64_t nj = clamp64(qj + to_int32(dj), 0, nqj - 1);
    if (ni == qi && nj == qj) return;  // step it + 1 stays: so does every later one
    if (ni == pi && nj == pj) {
      // step it + 1 returns to the quad of step it - 1: the walk alternates
      // between it and (qj, qi) from there, and ends on the former when the
      // steps from it + 1 to n_iters are even in number
      if ((n_iters - it - 1) % 2 == 0) {
        qi = pi;
        qj = pj;
      }
      return;
    }
    pi = qi;
    pj = qj;
    qi = ni;
    qj = nj;
  }
}

// The affine seed (xm, ym, ai, bi, aj, bj) of the swath (s) from seed_pass's
// kPassBlocks partial sums, every block reducing all of them in the same
// fixed order (no float atomics: repeated runs give the same bits, and
// every block the same seed), its *threads* threads (a multiple of 32)
// together; seed[6] and sh ((threads / 32) * kNStats) in shared memory.
// Returns the gate's flags (kGateAll where every test passes).  Thread 0
// writes seed; the block has synchronised on return.
template <typename F>
__device__ int seed_of(const F* __restrict__ gx, const F* __restrict__ gy, F r0, Swath s,
                       const F* __restrict__ partials, int threads, F* sh, F* seed) {
  F v[kNStats];
#pragma unroll
  for (int k = 0; k < kNStats; ++k) v[k] = k == kGate ? F(kGateAll) : F(0);
  for (int b = threadIdx.x; b < kPassBlocks; b += threads) {
#pragma unroll
    for (int k = 0; k < kNStats; ++k) v[k] = combine(k, v[k], partials[b * kStats + k]);
  }
  block_stats(v, sh, threads);
  const int gate = static_cast<int>(sh[kGate]);
  if (threadIdx.x == 0) {
    const F n = F(s.h * s.w);
    const int64_t kc = (s.h / 2) * s.w + s.w / 2;
    const F dx = sh[kSx] / n, dy = sh[kSy] / n;  // the means less (kx, ky)
    const F sxx = sh[kXX] / n - dx * dx, sxy = sh[kXY] / n - dx * dy;
    const F syy = sh[kYY] / n - dy * dy;
    const F rix = sh[kXI] / n, riy = sh[kYI] / n, rjx = sh[kXJ] / n, rjy = sh[kYJ] / n;
    F det_m = fma(sxx, syy, -(sxy * sxy));
    if (fabs(det_m) < F(1e-30)) det_m = F(1e-30);
    seed[0] = gx[kc] + dx;
    seed[1] = (gy[kc] - r0) + dy;
    seed[2] = fma(rix, syy, -(riy * sxy)) / det_m;
    seed[3] = fma(riy, sxx, -(rix * sxy)) / det_m;
    seed[4] = fma(rjx, syy, -(rjy * sxy)) / det_m;
    seed[5] = fma(rjy, sxx, -(rjx * sxy)) / det_m;
  }
  __syncthreads();
  return gate;
}

// The triangle formulas' solve as the walk, the tiled stencil and the scan
// compute it (rectify_ops.py:_tri_solve_flat, _phase_a_tiled, _phase_a_scan;
// true divisions, where the hybrid's K12 multiplies by a reciprocal):
// triangle (q0, q1, q2) (A: p0, p1, p2; B: p3, p2, p1) has the determinant
// tri_det, and where it is not 0, u = fu(p, q0, q2) / det and v = fv(p, q0,
// q1) / det; it accepts p where u, v >= u_min and u + v <= uv_max.
template <typename F>
__device__ __forceinline__ F tri_det(F q0x, F q0y, F q1x, F q1y, F q2x, F q2y) {
  return nan_to_num(fdet(q0x, q0y, q1x, q1y, q2x, q2y), F(0));
}

template <typename F>
__device__ __forceinline__ bool tri_accepts(F det, F px, F py, F q0x, F q0y, F q1x, F q1y,
                                            F q2x, F q2y, F u_min, F uv_max, F& u, F& v) {
  if (det == F(0)) return false;
  u = fu(px, py, q0x, q0y, q2x, q2y) / det;
  v = fv(px, py, q0x, q0y, q1x, q1y) / det;
  return u >= u_min && v >= u_min && u + v <= uv_max;
}

// jnp.clip(x, 0, 1)
template <typename F>
__device__ __forceinline__ F clip01(F x) {
  return fmin(fmax(x, F(0)), F(1));
}

}  // namespace
