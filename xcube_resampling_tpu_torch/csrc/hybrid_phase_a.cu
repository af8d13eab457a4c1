// K11 and K12: the hybrid Phase A of rectify, its seed and its dense
// acceptance, on normalised swath coordinates (the target's pixel units).
//
// Replaces the XLA kernels of xcube_resampling_tpu/ops/rectify_ops.py:
//   * K11 `hybrid_seed`, _build_hybrid_seed_kernel (:1812-1884): the gate
//     (every coordinate finite, one orientation for each triangle of every
//     quad, no quad edge above max_edge), the least-squares affine seed
//     (_affine_seed :1449-1479), a coarse_iters-step quad walk
//     (_walk_steps_flat :1421-1446) on every 8th tile corner, a
//     refine_iters-step walk on the (n_tj + 1, n_ti + 1) tile-corner
//     lattice, and per axis the window nodes every tile needs:
//     meta = [gate, need_j, need_i];
//   * K12 `hybrid_dense`, _build_hybrid_dense_kernel (:1887-2043): per tile
//     a (win_j x win_i) node window at the corner guesses' minimum less the
//     margin, clamped into the swath; every pixel centre takes the window
//     quad of lowest row-major rank whose triangle A or B accepts it, its
//     (i, j) from that triangle's solve (a product with the reciprocal of
//     the determinant), NaN where none accepts.
// Both shift gy by the band origin r0 as they load it (one subtraction, as
// the sharded Phase A's `gy - r0`, parallel/halo.py:1089-1090); r0 = 0 is
// the single-chip map.  The working type F is float64 on the H100 (its
// native float64 keeps the map within 1e-9 of the host tier's); the
// kernels are templates of it.  a * b - c * d is fma(a, b, -(c * d)) where
// XLA's CPU backend contracts the JAX kernels' float64 formulas so, and
// nowhere else (built with -fmad=false): the map equals JAX's bit for bit.
//
// K11's bound on the H100: device memory, one read of the two coordinate
// images.  The first design read them twice in seven launches (the means,
// their one-block finish, the centred moments, theirs, the coarse walk, the
// fine walk, the needs), each pass on 264 blocks of one 8-byte load a
// thread at a time, and walked every corner its full 24 and 6 steps.
// Design, two launches:
//   1. seed_pass reads both images once for every sum: the gate's and the
//      moments about the centre node (kx, ky) (sxx = sum (x - kx)^2 / n -
//      (xm - kx)^2, ...; sum (x - xm) di = sum (x - kx) di, as sum di = 0),
//      a fixed grid of kPassBlocks blocks (three an SM), each a column of a
//      kPassRows-row tile a thread with kPassAhead rows in flight, the
//      quads' right-hand nodes from the next lane.  Each block writes its
//      partial sums.
//   2. seed_walk, a block a patch of kPatch x kPatch tiles: each reduces
//      every partial in the same fixed order (no float atomics: repeated
//      runs give the same bits, and every block the same seed), walks the
//      coarse corners its patch starts from, then its corners, then takes
//      its tiles' needs (integer maxima, one atomicMax a block).  A walk
//      stops at its fixed point: a step depends on the quad alone, so the
//      steps it skips would leave it where it is.
// The regrouped sums round otherwise than the plain version's; the seed
// only starts the walks, and (cqj, cqi, meta) are held equal to the plain
// version's (chip_smoke.py) and to JAX's (tests/test_torch_sharded_rectify.py).
//
// K12's bound is K8's, which computes the same map from the same swath:
// its bytes.  What holds it is arithmetic.  The first design (one thread a
// pixel scanning the window's quads in rank order to the first that
// accepts) solved 357 quads a pixel at R3 (24 x 28 nodes, 621 quads), some
// 30 float64 operations each, 131x the bound: almost every test was of a
// quad nowhere near the pixel.  Design: solve only the (pixel, triangle)
// pairs that can accept.
//   1. One block a tile (a thread a pixel) stages its window's nodes in
//      shared memory, 16 B a node.
//   2. Pass 1, a thread a quad (strided over the window): a quad whose
//      nodes lie off the tile's pixels by more than its triangles' boxes
//      can grow (and whose triangles are dropped or well conditioned) has
//      no pair; the others, some 200 of R3's 621, are listed in shared
//      memory, in no order.
//   3. Pass 2, a thread a listed quad: its two reciprocal determinants
//      (NaN where a determinant is 0 or NaN: that triangle never accepts;
//      kept in shared memory, 16 B a quad) and each triangle's box
//      (below), clipped to the tile's pixels.  The thread solves each pair
//      (pixel, triangle) in the clip and, where it accepts, lowers the
//      pixel's key (2 * rank + 0 for triangle A, 1 for B) with a shared
//      atomicMin.  The least key is the scan's winner: the lowest-ranked
//      quad that accepts, through A where A accepts; the order of the
//      list and of the atomics does not matter.
//   4. Each thread solves its pixel's winner once more, as the first
//      design did (the same operations in the same order), for the map
//      and `tested` (the winner's position in the window's rank order,
//      plus one); `solved` (optional) takes the pairs solved a pixel.
// Measured on an H100 80GB HBM3 at 700 W at R3 (1.76 pairs solved a
// pixel): the first design 28.5 ms; a lane a pixel, each warp walking
// the window's quads 32 at a time (a ballot skipping chunks no box met, a
// warp scan spreading the pairs over the lanes) 3.34 ms, the walk costing
// more than the solves it saved; one pass, a thread a quad, 2.46 ms, its
// warps mixing culled quads with solved ones; the two passes 2.14 ms at
// 72 registers, 1.87 at the cap of 64 (kDenseMinBlocks = 4 blocks an SM,
// no spill).  The per-quad differences of fu and fv are not staged: each
// pair is solved once, where four subtractions cost what four shared
// loads would.
// The box (tri_box, phase_a_common.h, where its bound is derived; K20
// shares it): the nodes' box grown by what the rounded test can accept
// past the triangle.  A triangle whose determinant is 0 or NaN gets an
// empty box; a sliver or a triangle with an infinite node a box covering
// every pixel: it is tested by every pixel, never dropped.
// rectify_ops.hybrid_tri_boxes is the plain mirror of tri_box and of the
// clipping (the CPU tests hold every accepting pair inside its box).
#include "phase_a_common.h"

namespace {

// the coarse lattice: every kCs-th tile corner; a walk block a patch of
// kPatch x kPatch tiles, a thread each of its (kPatch + 1)^2 corners
constexpr int kCs = 8;
constexpr int kPatch = 15;
constexpr int kWalkThreads = (kPatch + 1) * (kPatch + 1);

struct Lattice {
  int64_t n_cj, n_ci, n_tj, n_ti, tile;
  int coarse_iters, refine_iters;
};

// K11's walks, a block a patch of kPatch x kPatch tiles: every block first
// finishes the pass's sums (all kPassBlocks partials, in the same fixed
// order: every block gets the same seed) into the affine seed's
// coefficients (block 0 writes the gate); then the coarse lattice's
// corners the patch's corners start from, coarse_iters walk steps each
// from the seed; then refine_iters steps for each of the patch's (kPatch
// + 1)^2 corners (the patch's own written to cqj, cqi); then each tile's
// window needs from its four corners, one atomicMax a block.
template <typename F>
__global__ void __launch_bounds__(kWalkThreads)
    seed_walk(const F* __restrict__ gx, const F* __restrict__ gy, F r0, Swath s, Lattice l,
              const F* __restrict__ partials, int margin, int64_t n_pi,
              int* __restrict__ cqj, int* __restrict__ cqi, int* __restrict__ meta) {
  __shared__ F sh[(kWalkThreads / 32) * kNStats];
  __shared__ F seed[6];  // xm, ym, ai, bi, aj, bj
  __shared__ int cq[2][3][3];  // the coarse corners' quads (j, i)
  __shared__ int fq[2][kPatch + 1][kPatch + 1];  // the patch's corners' quads
  __shared__ int nj_max[kWalkThreads / 32], ni_max[kWalkThreads / 32];
  // -- the sums and the seed
  const int gate = seed_of(gx, gy, r0, s, partials, kWalkThreads, sh, seed);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    meta[0] = (gate & kFinite) && (gate & (kANeg | kAPos)) && (gate & (kBNeg | kBPos)) &&
              (gate & kEdge);
  }
  // -- the coarse corners
  const int64_t pj = blockIdx.x / n_pi, pi = blockIdx.x % n_pi;
  const int64_t a0 = pj * kPatch, b0 = pi * kPatch;  // the patch's first corner
  const int64_t cj0 = a0 / kCs, ci0 = b0 / kCs;
  const int64_t nqj = s.h - 1, nqi = s.w - 1;
  if (threadIdx.x < 9) {
    const int64_t cj = cj0 + threadIdx.x / 3, ci = ci0 + threadIdx.x % 3;
    const int64_t a_hi = a0 + kPatch < l.n_tj ? a0 + kPatch : l.n_tj;
    const int64_t b_hi = b0 + kPatch < l.n_ti ? b0 + kPatch : l.n_ti;
    if (cj <= a_hi / kCs && ci <= b_hi / kCs) {
      const F px = F(ci) * F(kCs * l.tile);
      const F py = F(cj) * F(kCs * l.tile);
      const F im = F(s.w - 1) / F(2), jm = F(s.h - 1) / F(2);
      const F dx = px - seed[0], dy = py - seed[1];
      int64_t qi = to_int32(nan_to_num(fma(seed[3], dy, fma(seed[2], dx, im)), im));
      int64_t qj = to_int32(nan_to_num(fma(seed[5], dy, fma(seed[4], dx, jm)), jm));
      qi = clamp64(qi, 0, nqi - 1);
      qj = clamp64(qj, 0, nqj - 1);
      walk(gx, gy, r0, s, qj, qi, px, py, l.coarse_iters);
      cq[0][threadIdx.x / 3][threadIdx.x % 3] = static_cast<int>(qj);
      cq[1][threadIdx.x / 3][threadIdx.x % 3] = static_cast<int>(qi);
    }
  }
  __syncthreads();
  // -- the patch's corners
  const int ty = threadIdx.x / (kPatch + 1), tx = threadIdx.x % (kPatch + 1);
  const int64_t a = a0 + ty, b = b0 + tx;
  if (a <= l.n_tj && b <= l.n_ti) {
    int64_t qj = cq[0][a / kCs - cj0][b / kCs - ci0];
    int64_t qi = cq[1][a / kCs - cj0][b / kCs - ci0];
    walk(gx, gy, r0, s, qj, qi, F(b) * F(l.tile), F(a) * F(l.tile), l.refine_iters);
    fq[0][ty][tx] = static_cast<int>(qj);
    fq[1][ty][tx] = static_cast<int>(qi);
    if ((ty < kPatch || a == l.n_tj) && (tx < kPatch || b == l.n_ti)) {
      const int64_t p = a * (l.n_ti + 1) + b;
      cqj[p] = static_cast<int>(qj);
      cqi[p] = static_cast<int>(qi);
    }
  }
  __syncthreads();
  // -- the tiles' needs: the margin-padded quad range of their corners,
  // clamped at the swath's bounds, plus the closing node
  int need_j = INT_MIN, need_i = INT_MIN;
  if (ty < kPatch && tx < kPatch && a < l.n_tj && b < l.n_ti) {
    int j_lo = INT_MAX, j_hi = INT_MIN, i_lo = INT_MAX, i_hi = INT_MIN;
    for (int c = 0; c < 4; ++c) {
      const int qj = fq[0][ty + c / 2][tx + c % 2], qi = fq[1][ty + c / 2][tx + c % 2];
      j_lo = min(j_lo, qj);
      j_hi = max(j_hi, qj);
      i_lo = min(i_lo, qi);
      i_hi = max(i_hi, qi);
    }
    need_j = min(j_hi + margin, static_cast<int>(s.h) - 2) - max(j_lo - margin, 0) + 2;
    need_i = min(i_hi + margin, static_cast<int>(s.w) - 2) - max(i_lo - margin, 0) + 2;
  }
  for (int d = 16; d > 0; d >>= 1) {
    need_j = max(need_j, __shfl_down_sync(0xffffffffu, need_j, d));
    need_i = max(need_i, __shfl_down_sync(0xffffffffu, need_i, d));
  }
  if ((threadIdx.x & 31) == 0) {
    nj_max[threadIdx.x >> 5] = need_j;
    ni_max[threadIdx.x >> 5] = need_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWalkThreads / 32; ++w) {
      need_j = max(need_j, nj_max[w]);
      need_i = max(need_i, ni_max[w]);
    }
    if (need_j != INT_MIN) atomicMax(meta + 1, need_j);
    if (need_i != INT_MIN) atomicMax(meta + 2, need_i);
  }
}

struct DenseArgs {
  const double* gx;
  const double* gy;
  double r0;
  Swath s;
  const int* cqj;
  const int* cqi;
  int64_t dst_h, dst_w, n_ti;
  int win_j, win_i, margin;
  double u_min, uv_max;
  Cull cull;
  double* out;   // (2, dst_h, dst_w)
  int* tested;   // (dst_h, dst_w) the winner's window position + 1, or nullptr
  int* solved;   // (dst_h, dst_w) (pixel, triangle) pairs solved, or nullptr
};


// triangle `side` (0: A, 1: B) of window quad q solved at (px, py), as
// the first design solved it: (u, v) and whether it accepts
template <typename F>
__device__ __forceinline__ bool solve_tri(const F* wx, const F* wy, const F* inv_a,
                                          const F* inv_b, int wi, int wqi, int q, int side,
                                          F px, F py, F u_min, F uv_max, F& u, F& v) {
  const int n0 = (q / wqi) * wi + q % wqi;
  if (side == 0) {
    const F p0x = wx[n0], p0y = wy[n0];
    u = fu(px, py, p0x, p0y, wx[n0 + wi], wy[n0 + wi]) * inv_a[q];
    v = fv(px, py, p0x, p0y, wx[n0 + 1], wy[n0 + 1]) * inv_a[q];
  } else {
    const F p3x = wx[n0 + wi + 1], p3y = wy[n0 + wi + 1];
    u = fu(px, py, p3x, p3y, wx[n0 + 1], wy[n0 + 1]) * inv_b[q];
    v = fv(px, py, p3x, p3y, wx[n0 + wi], wy[n0 + wi]) * inv_b[q];
  }
  return u >= u_min && v >= u_min && u + v <= uv_max;
}

// blocks an SM must hold at tile 16 (the register cap: 65536 / (256 *
// kDenseMinBlocks))
constexpr int kDenseMinBlocks = 4;

template <typename F, int T>
__global__ void __launch_bounds__(T * T, T == 16 ? kDenseMinBlocks : 1)
    hybrid_dense_kernel(const DenseArgs a) {
  extern __shared__ __align__(16) double smem[];
  __shared__ int key[T * T];
  __shared__ int count[T * T];
  __shared__ int n_near;
  const int wj = a.win_j, wi = a.win_i;
  const int wqi = wi - 1, nq = (wj - 1) * wqi;
  F* wx = reinterpret_cast<F*>(smem);
  F* wy = wx + wj * wi;
  F* inv_a = wy + wj * wi;
  F* inv_b = inv_a + nq;
  int* near = reinterpret_cast<int*>(inv_b + nq);
  const F* gx = a.gx;
  const F* gy = a.gy;
  const F r0 = a.r0;
  const int tid = threadIdx.x;
  const int64_t tj = blockIdx.x / a.n_ti, ti = blockIdx.x % a.n_ti;
  const int64_t lw = a.n_ti + 1;
  const int64_t c = tj * lw + ti;
  const int j_lo = min(min(a.cqj[c], a.cqj[c + 1]), min(a.cqj[c + lw], a.cqj[c + lw + 1]));
  const int i_lo = min(min(a.cqi[c], a.cqi[c + 1]), min(a.cqi[c + lw], a.cqi[c + lw + 1]));
  const int64_t base_j = min(max(j_lo - a.margin, 0), static_cast<int>(a.s.h) - wj);
  const int64_t base_i = min(max(i_lo - a.margin, 0), static_cast<int>(a.s.w) - wi);
#pragma unroll 4
  for (int k = tid; k < wj * wi; k += T * T) {
    const int64_t g = (base_j + k / wi) * a.s.w + base_i + k % wi;
    wx[k] = __ldg(gx + g);
    wy[k] = __ldg(gy + g) - r0;
  }
  key[tid] = INT_MAX;
  count[tid] = 0;
  if (tid == 0) n_near = 0;
  __syncthreads();
  // the tile's pixels (clipped to the target): columns col0 .. col0 +
  // n_cols - 1, rows row0 .. row0 + n_rows - 1, centres at + 0.5
  const int64_t col0 = ti * T, row0 = tj * T;
  const int64_t cols_left = a.dst_w - col0, rows_left = a.dst_h - row0;
  const int n_cols = cols_left < T ? static_cast<int>(cols_left) : T;
  const int n_rows = rows_left < T ? static_cast<int>(rows_left) : T;
  const double x0 = static_cast<double>(col0), y0 = static_cast<double>(row0);
  // pass 1, a thread a quad: a quad whose nodes' box, grown by the most
  // its triangles' boxes grow where derived (pad_max), lies off the tile's
  // pixel centres, and whose triangles are dropped or surely inside the
  // derived range, has no pair (fmin and fmax skip a NaN node, whose
  // triangle is dropped); the others are listed, in no order
  {
    const double t_x0 = x0 + 0.5, t_x1 = x0 + (n_cols - 0.5);
    const double t_y0 = y0 + 0.5, t_y1 = y0 + (n_rows - 0.5);
    for (int q = tid; q < nq; q += T * T) {
      const int n0 = (q / wqi) * wi + q % wqi;
      const int n1 = n0 + 1, n2 = n0 + wi, n3 = n0 + wi + 1;
      const F xl = fmin(fmin(wx[n0], wx[n1]), fmin(wx[n2], wx[n3]));
      const F xh = fmax(fmax(wx[n0], wx[n1]), fmax(wx[n2], wx[n3]));
      const F yl = fmin(fmin(wy[n0], wy[n1]), fmin(wy[n2], wy[n3]));
      const F yh = fmax(fmax(wy[n0], wy[n1]), fmax(wy[n2], wy[n3]));
      const F rx = (2 * a.cull.pad_max) * (xh - xl) + kCullReach * ((1 + fabs(xl)) + fabs(xh));
      const F ry = (2 * a.cull.pad_max) * (yh - yl) + kCullReach * ((1 + fabs(yl)) + fabs(yh));
      if ((xl - rx > t_x1 || xh + rx < t_x0 || yl - ry > t_y1 || yh + ry < t_y0) &&
          sure(wx[n0], wy[n0], wx[n1], wy[n1], wx[n2], wy[n2]) &&
          sure(wx[n3], wy[n3], wx[n2], wy[n2], wx[n1], wy[n1])) {
        continue;
      }
      near[atomicAdd(&n_near, 1)] = q;
    }
  }
  __syncthreads();
  // pass 2, a thread a listed quad: its reciprocals (NaN where a
  // determinant is 0 or NaN), each triangle's box clipped to the tile's
  // pixels, and the pairs in the clip solved; an accepting pair lowers its
  // pixel's key.  (The reciprocals are read back from shared memory for
  // the boxes: kept in registers they spill at the cap of 64.)
  const F u_min = a.u_min, uv_max = a.uv_max;
  for (int i = tid; i < n_near; i += T * T) {
    const int q = near[i];
    const int n0 = (q / wqi) * wi + q % wqi;
    const int n1 = n0 + 1, n2 = n0 + wi, n3 = n0 + wi + 1;
    const F da = nan_to_num(fdet(wx[n0], wy[n0], wx[n1], wy[n1], wx[n2], wy[n2]), F(0));
    const F db = nan_to_num(fdet(wx[n3], wy[n3], wx[n2], wy[n2], wx[n1], wy[n1]), F(0));
    inv_a[q] = da != 0 ? F(1) / da : F(NAN);
    inv_b[q] = db != 0 ? F(1) / db : F(NAN);
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
      const Box b =
          side == 0 ? tri_box(wx[n0], wy[n0], wx[n1], wy[n1], wx[n2], wy[n2], inv_a[q], a.cull)
                    : tri_box(wx[n3], wy[n3], wx[n2], wy[n2], wx[n1], wy[n1], inv_b[q], a.cull);
      int rect = 0;
      if (clip_box(b, x0, y0, n_cols, n_rows, &rect) == 0) continue;
      const int c_lo = rect & 0xff, c_hi = (rect >> 8) & 0xff;
      const int r_lo = (rect >> 16) & 0xff, r_hi = (rect >> 24) & 0xff;
      for (int r = r_lo; r <= r_hi; ++r) {
        for (int cc = c_lo; cc <= c_hi; ++cc) {
          // (x0 + cc is exact: the pixel's column, as F(col) below)
          F u, v;
          if (solve_tri(wx, wy, inv_a, inv_b, wi, wqi, q, side, (x0 + cc) + F(0.5),
                        (y0 + r) + F(0.5), u_min, uv_max, u, v)) {
            atomicMin(&key[r * T + cc], 2 * q + side);
          }
          if (a.solved != nullptr) atomicAdd(&count[r * T + cc], 1);
        }
      }
    }
  }
  __syncthreads();
  const int lr = tid / T, lc = tid % T;
  if (lr >= n_rows || lc >= n_cols) return;
  const int64_t row = row0 + lr, col = col0 + lc;
  const int win = key[tid];
  F out_i = F(NAN), out_j = F(NAN);
  int pos = nq;
  if (win != INT_MAX) {
    const int q = win >> 1, side = win & 1;
    F u, v;
    solve_tri(wx, wy, inv_a, inv_b, wi, wqi, q, side, F(col) + F(0.5), F(row) + F(0.5), u_min,
              uv_max, u, v);
    const F gi = F(base_i + q % wqi), gj = F(base_j + q / wqi);
    if (side == 0) {
      out_i = gi + fmin(fmax(u, F(0)), F(1));
      out_j = gj + fmin(fmax(v, F(0)), F(1));
    } else {
      out_i = (gi + F(1)) - fmin(fmax(u, F(0)), F(1));
      out_j = (gj + F(1)) - fmin(fmax(v, F(0)), F(1));
    }
    pos = q + 1;
  }
  const int64_t o = row * a.dst_w + col;
  a.out[o] = out_i;
  a.out[a.dst_h * a.dst_w + o] = out_j;
  if (a.tested != nullptr) a.tested[o] = pos;
  if (a.solved != nullptr) a.solved[o] = count[tid];
}

template <int T>
cudaError_t launch_dense(const DenseArgs& a, int64_t n_tiles, size_t smem, cudaStream_t st) {
  auto kernel = hybrid_dense_kernel<double, T>;
  // (the static key and count tables, 2 KB, count against the default 48 KB)
  if (smem > 46 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<static_cast<unsigned>(n_tiles), T * T, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// K11 on float64 (h, w) gx, gy: cqj, cqi (n_tj + 1, n_ti + 1) int32 and
// meta[3] int32; scratch (kPassBlocks * kStats float64) is the wrapper's.
// Two launches: the pass, then the walks.
extern "C" int xrt_hybrid_seed(const double* gx, const double* gy, int64_t src_h, int64_t src_w,
                               double r0, int64_t dst_h, int64_t dst_w, int64_t tile,
                               int64_t coarse_iters, int64_t refine_iters, double max_edge,
                               int64_t margin, double* scratch, int* cqj, int* cqi, int* meta,
                               void* stream) {
  if (src_h < 2 || src_w < 2 || src_h * src_w > (int64_t{1} << 31) - 1 || dst_h < 1 ||
      dst_w < 1 || tile < 1 || coarse_iters < 0 || refine_iters < 0 || margin < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Swath s{src_h, src_w};
  const int64_t n_tj = (dst_h + tile - 1) / tile, n_ti = (dst_w + tile - 1) / tile;
  const Lattice l{n_tj / kCs + 2, n_ti / kCs + 2, n_tj, n_ti, tile,
                  static_cast<int>(coarse_iters), static_cast<int>(refine_iters)};
  const int64_t n_pj = (n_tj + kPatch - 1) / kPatch, n_pi = (n_ti + kPatch - 1) / kPatch;
  if (n_pj * n_pi > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  seed_pass<double><<<kPassBlocks, kPassThreads, 0, st>>>(gx, gy, r0, s, max_edge, scratch,
                                                          meta);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  seed_walk<double><<<static_cast<unsigned>(n_pj * n_pi), kWalkThreads, 0, st>>>(
      gx, gy, r0, s, l, scratch, static_cast<int>(margin), n_pi, cqj, cqi, meta);
  return static_cast<int>(cudaGetLastError());
}

// K12 on float64 (h, w) gx, gy and K11's cqj, cqi: out (2, dst_h, dst_w)
// float64; tested and solved (dst_h, dst_w) int32 or nullptr.  tile is 16,
// 12, 8 or 4.
extern "C" int xrt_hybrid_dense(const double* gx, const double* gy, int64_t src_h,
                                int64_t src_w, double r0, const int* cqj, const int* cqi,
                                int64_t dst_h, int64_t dst_w, int64_t tile, int64_t win_j,
                                int64_t win_i, int64_t margin, double uv_delta, double* out,
                                int* tested, int* solved, void* stream) {
  const int64_t n_tj = (dst_h + tile - 1) / tile, n_ti = (dst_w + tile - 1) / tile;
  // nodes (x, y), reciprocals (A, B) and the list of quads near the tile
  const size_t smem = 16 * win_j * win_i + 20 * (win_j - 1) * (win_i - 1);
  if (src_h < 2 || src_w < 2 || src_h * src_w > (int64_t{1} << 31) - 1 || dst_h < 1 ||
      dst_w < 1 || win_j < 2 || win_i < 2 || win_j > src_h || win_i > src_w || margin < 0 ||
      n_tj * n_ti > INT_MAX || smem > 232448 - 2048) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const double u_min = -uv_delta, uv_max = 1.0 + 2 * uv_delta;
  const DenseArgs a{gx, gy, r0, Swath{src_h, src_w}, cqj, cqi, dst_h, dst_w, n_ti,
                    static_cast<int>(win_j), static_cast<int>(win_i), static_cast<int>(margin),
                    u_min, uv_max, cull_of(u_min, uv_max), out, tested, solved};
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (tile) {
    case 16: rc = launch_dense<16>(a, n_tj * n_ti, smem, st); break;
    case 12: rc = launch_dense<12>(a, n_tj * n_ti, smem, st); break;
    case 8: rc = launch_dense<8>(a, n_tj * n_ti, smem, st); break;
    case 4: rc = launch_dense<4>(a, n_tj * n_ti, smem, st); break;
    default: rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}
