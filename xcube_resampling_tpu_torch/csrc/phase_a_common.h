// The pieces of rectify's device Phase A that K11 and K12 (hybrid_phase_a.cu),
// K19 (phase_a_walk.cu), K20 (phase_a_tiled.cu) and K21 (phase_a_scan.cu)
// share: the triangle formulas as XLA's CPU backend contracts them in the
// JAX package's float64 kernels (a * b - c * d is fma(a, b, -(c * d));
// ops/rectify_ops.py's _fdet_x, _fu_x, _fv_x), XLA's conversions, K11's one
// pass over the swath for the gate's flags and the affine seed's sums
// (seed_pass), the seed from those sums (seed_of), the quad walk (walk), and
// the triangle test by true division of the walk, the tiled stencil and the
// scan (tri_det, tri_accepts), and the triangle box of the kernels that
// solve only the (pixel, triangle) pairs that can accept, K12 and K20
// (tri_box, sure, clip_box).  Everything is in an unnamed namespace: each
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

// -- the culled kernels' triangle box (K12 hybrid_dense, K20 phase_a_tiled) --
//
// The box (tri_box): p = Q0 + u e1 + v e2 with e1 = Q1 - Q0, e2 = Q2 - Q0
// (triangle A: Q = p0, p1, p2; B: p3, p2, p1), u = fu / det.  The kernel
// accepts where its rounded u, v satisfy u, v >= -delta and u + v <= 1 +
// 2 delta (delta = uv_delta).  Let P = (|e1x| + |e2x|)(|e1y| + |e2y|),
// k = P / |det| and eps = 2^-53.  fu = fma(a, b, -(c d)), each factor one
// rounded difference, is within 4.02 eps (|dx e2y| + |dy e2x|) of the
// exact value, and |dx e2y| + |dy e2x| <= 2 (|u*| + |v*|) P for the exact
// u*, v*; the determinant likewise within 4.02 eps P; the reciprocal and
// the product round twice more.  So |u - u*| <= 24 eps k S + 3 eps |u|
// with S = |u*| + |v*|.  A pair that accepts has |u|, |v| <= 1 + 3 delta,
// hence, where eps k <= 1e-4, S <= 2.03 (1 + 3 delta) and |u - u*| <= E =
// eps (1 + 3 delta)(51 k + 8) (twice the bound's constants: the plain
// version's emulated fma rounds twice, and underflow adds at most
// 2^-1075 an operation, negligible where 2^-500 <= P <= 2^500).  The
// exact u*, v* then lie in u, v >= -(delta + E), u + v <= 1 + b with b =
// (uv_max - 1) + 2 E + 4 eps, a triangle whose corners lie within (delta
// + E + b)(|e1x| + |e2x|) of Q0, Q1, Q2 in x (y alike): the box is the
// nodes' box grown by that, plus 2^-40 (1 + |node| + pad) for its own
// roundings.  A triangle whose determinant is
// 0 or NaN gets an empty box; one outside eps k <= 1e-4 or that range of
// P (slivers, infinite nodes) gets a box covering every pixel: it is
// tested by every pixel, never dropped.  rectify_ops.hybrid_tri_boxes is
// the plain mirror of tri_box and of the clipping (the CPU tests hold
// every accepting pair inside its box).
// K12 multiplies by the reciprocal of the determinant; K20 divides once
// (tri_accepts), one rounding fewer than the reciprocal and the product
// that the bound above allows for, so K12's constants hold for K20 as
// they are (tests/test_torch_tiled_cull.py holds every pair that accepts
// under K20's true divisions inside its box).  K20 takes its box from
// the reciprocal too (tri_box's k = P |1 / det|), so that one mirror
// serves both kernels.
// The cull constants, from the accept test's u_min = -delta and uv_max:
// E = c1 k + c0, the pad's barycentric width m = base + 3 E (tri_box),
// pad_max the largest m where the box is derived (eps k <= 1e-4)
struct Cull {
  double c1, c0, base, pad_max;
};

constexpr double kEps = 0x1p-53;
constexpr double kCullKMax = 1e-4 / kEps;
constexpr double kCullPMin = 0x1p-500;
constexpr double kCullPMax = 0x1p500;
constexpr double kCullSlack = 0x1p-40;
// a quad's reach past its nodes' box, relative to their magnitude: more
// than tri_box's slack and roundings
constexpr double kCullReach = 0x1p-30;

__host__ __device__ inline Cull cull_of(double u_min, double uv_max) {
  const double d = -u_min;
  const double c = kEps * (1 + 3 * d);
  const double base = d + (uv_max - 1) + 4 * kEps;
  return Cull{c * 51, c * 8, base, base + 3.0 * (c * 51 * kCullKMax + c * 8)};
}

struct Box {
  double x_lo, x_hi, y_lo, y_hi;
};

// The box, in pixel-centre coordinates, outside which triangle (q0, q1,
// q2) with reciprocal determinant inv cannot accept (the derivation
// above); empty where inv is NaN, every pixel where the bound is not small.
__device__ __forceinline__ Box tri_box(double q0x, double q0y, double q1x, double q1y,
                                       double q2x, double q2y, double inv, const Cull& c) {
  if (inv != inv) return Box{INFINITY, -INFINITY, INFINITY, -INFINITY};
  const double e1x = q1x - q0x, e1y = q1y - q0y, e2x = q2x - q0x, e2y = q2y - q0y;
  const double sx = fabs(e1x) + fabs(e2x), sy = fabs(e1y) + fabs(e2y);
  const double p = sx * sy;
  const double k = p * fabs(inv);
  if (!(k <= kCullKMax && p >= kCullPMin && p <= kCullPMax)) {
    return Box{-INFINITY, INFINITY, -INFINITY, INFINITY};
  }
  const double e = c.c1 * k + c.c0;
  const double m = c.base + 3.0 * e;
  const double mx = m * sx, my = m * sy;
  const double xlo = fmin(q0x, fmin(q1x, q2x)), xhi = fmax(q0x, fmax(q1x, q2x));
  const double ylo = fmin(q0y, fmin(q1y, q2y)), yhi = fmax(q0y, fmax(q1y, q2y));
  return Box{(xlo - mx) - kCullSlack * ((1.0 + fabs(xlo)) + mx),
             (xhi + mx) + kCullSlack * ((1.0 + fabs(xhi)) + mx),
             (ylo - my) - kCullSlack * ((1.0 + fabs(ylo)) + my),
             (yhi + my) + kCullSlack * ((1.0 + fabs(yhi)) + my)};
}

// Whether triangle (q0, q1, q2) is dropped (its determinant, as K12 and
// K20 compute it, 0 or NaN) or surely inside tri_box's derived range (k at
// most half its limit, no division): its box then lies inside its nodes'
// box grown by pad_max
__device__ __forceinline__ bool sure(double q0x, double q0y, double q1x, double q1y,
                                     double q2x, double q2y) {
  const double det = nan_to_num(fdet(q0x, q0y, q1x, q1y, q2x, q2y), 0.0);
  const double p = (fabs(q1x - q0x) + fabs(q2x - q0x)) * (fabs(q1y - q0y) + fabs(q2y - q0y));
  return det == 0 || (p <= (kCullKMax / 2) * fabs(det) && p >= kCullPMin && p <= kCullPMax);
}

// The pixels of a tile inside box b: tile-local columns c0..c1 and rows
// r0..r1 (of n_cols x n_rows from (x0, y0)) packed a byte each into *rect;
// returns their count (0 where none).  Pixel (col, row) has its centre at
// (col + 0.5, row + 0.5).
__device__ __forceinline__ int clip_box(const Box& b, double x0, double y0, int n_cols,
                                        int n_rows, int* rect) {
  const double c_lo = fmax(ceil(b.x_lo - 0.5) - x0, 0.0);
  const double c_hi = fmin(floor(b.x_hi - 0.5) - x0, n_cols - 1.0);
  const double r_lo = fmax(ceil(b.y_lo - 0.5) - y0, 0.0);
  const double r_hi = fmin(floor(b.y_hi - 0.5) - y0, n_rows - 1.0);
  if (!(c_lo <= c_hi && r_lo <= r_hi)) return 0;
  const int c0 = static_cast<int>(c_lo), c1 = static_cast<int>(c_hi);
  const int r0 = static_cast<int>(r_lo), r1 = static_cast<int>(r_hi);
  *rect = c0 | c1 << 8 | r0 << 16 | r1 << 24;
  return (c1 - c0 + 1) * (r1 - r0 + 1);
}

}  // namespace
