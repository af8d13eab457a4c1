// K14 and K15: the aligned SRW's tap passes; K17 and K18: the hybrid
// SRW's, the same two kernels with a base a tile.
//
// Replace the XLA kernels of xcube_resampling_tpu/ops/srw.py:
// make_srw_aligned_fn (:1084-1152) and make_srw_hybrid_fn (:1430-1478, the
// vertical pass, and :1480-1535, the horizontal pass and the fill select).
// Each pads the source by edge rows, shifts each source column up by
// s_v[c] rows with log2 roll and select passes that repeat the last row,
// sums d_v taps in that shifted space from one base per output row and
// column tile of col_tile source columns, and does the same along rows of
// the result (s_h, one base per row tile of row_tile output rows and
// output column, d_h taps) before the fill select.  The aligned SRW is the
// case of one tile (col_tile = src_w, row_tile = out_h).  Every hybrid
// base lies inside the padding, so the take's clip never bites, and the
// padding, the shift passes and the take compose to one clamped index, so
// each pass here reads its taps where they lie:
//
//   K14/K17  p = iystar(r, c) - s_v[c],  t = c / col_tile
//            v[b, r, c]   = sum_{d < d_v} w(p, base_v[r, t] + d)
//                           * src[b, clamp(base_v[r, t] + d + s_v[c]), c]
//   K15/K18  q = ix(r, c) - s_h[r],  u = r / row_tile
//            out[b, r, c] = valid(r, c) ? sum_{d < d_h} w(q, base_h[u, c] + d)
//                           * v[b, r, clamp(base_h[u, c] + d + s_h[r])] : fill
//
// with iystar, ix and iy the coarse fields interpolated as the JAX
// package's reproject_ops._interp_field (srw_common.h's FieldColumn and
// FieldCols), which rounds the positions that the hybrid materialises once
// per geometry (precompute, srw.py:1392-1424) to the same float32 values;
// w the hat max(0, 1 - |p - k|) (bilinear) or rint(p) == k (nearest), and
// valid the tiled SRW's test on the unshifted ix and iy (srw.py:931-945,
// :1408-1413).
//
// Rounding: XLA's CPU backend drops the sum's initial zero and contracts
// the first two products as fma(w0, t0, w1 * t1), the product w1 * t1
// rounded on its own; every later tap is fma(w_d, t_d, acc).  tap_sum
// keeps that order (not K1's fma(w1, t1, w0 * t0), which misses the JAX
// package on some hundreds of pixels a 512^2 flagship by one ulp), and the
// library is built with -fmad=false, so nothing else is contracted.
//
// The exact two-tap shortcut (pair_for, aligned_sum).  Only the taps at
// floor(p) and floor(p) + 1 (rint(p) for nearest) can weigh; every other
// weight is +0.  Where the d taps are finite, a zero-weight tap adds a
// signed zero, which leaves a nonzero sum as it is.  With a = floor(p) -
// k0 the sum is then fma(w0, t0, w1 * t1) for a = 0, fma(w_{a+1}, t_{a+1},
// w_a * t_a) for 1 <= a <= d - 2 (the zero taps before tap a sum to a
// signed zero, and fma(w_a, t_a, +-0) rounds the product alone), and the
// one product w * t where only one tap lies inside the d taps, taken as
// fma(0, t, w * t); nearest is fma(0, t_a, 1 * t_a).  Where that sum is
// +-0, the zero taps' signs decide the zero's sign (with no initial zero,
// -0 + +0 gives +0), and where no tap weighs or p is NaN, nothing is
// decided: those outputs, and every output of a window that is not all
// finite, sum every tap, so 0 * NaN and 0 * inf reach the outputs as in
// the XLA path.  tests/test_torch_srw_aligned_staged.py holds a plain
// emulation of this arithmetic to the plain versions bit for bit.
//
// Bound on the H100: device memory.  Each pass reads its source once and
// writes its output once; with the shortcut, two taps an output.  The
// direct design (a thread an output, every tap a global load and a full
// weight, zero-weight taps included) took 8-13x its bound at the ESW cell;
// summing only the taps that can weigh, K18 took a third of its time and
// K17 three fifths (a ceiling reading of that design, NVIDIA H100 80GB
// HBM3 at 700 W, PERF.md §6).  The kernels:
//
// K14/K17 (srw_aligned_vertical_kernel, staged), as K1: a block covers kVCols
// source columns inside one column tile (one base per output row) by
// `rows` output rows, and stages the rows its taps read in shifted row
// space: staged row i of column c holds src[b, clamp(lo + i + s_v[c]), c],
// [lo, lo + extent) the host-planned span of the block's bases (the
// least base of its rows to the greatest plus d_v; ops/srw_aligned.py
// plan_vertical).  So the shift and the edge clamp go into the copy
// (cp.async, a thread a column) and the tap loop reads staged[k0 - lo +
// d] alike for every column.  A block walks several row blocks and every
// band, the next window loading while the current one is summed (two
// buffers); positions and bases go to shared memory once a row block.
//
// K15/K18 (srw_aligned_horizontal_kernel): a thread an output column over
// row groups of up to kHRows rows (group_rows) and every band, two taps an
// output read
// through L1.  Exactness needs each output's d_h taps finite.  A warp's 32
// columns read, in row r, the contiguous span [lo, hi) + s_h[r] of v's row
// ([lo, hi) the least base of its columns in the row tile to the greatest
// plus d_h, a warp reduction once a row tile); for each run of a group's
// rows inside one row tile and each band, the warp decides with one vote
// whether those spans are all finite.  On the staged vertical kernel's own
// output it reads that kernel's flags (one a row and word of kVCols v
// columns, a warp's ballot as it stores them, laid out word-major) of the
// words the spans touch, a lane a (row, word); on any other v it reads the
// spans' values, every load issued before any is tested.  The caller
// passes the flags where it has them: the vertical wrapper returns them
// beside the v they describe (ops/srw.py's AlignedSRWFn).
// Staging the spans in shared memory (a warp a 128-column task of 16 rows,
// K2's design; 92-96 registers, 5 blocks an SM) won where d_h is wide and
// lost where it is narrow: at the ESW cell (d_h 27) K18 took 0.1260 ms
// (4 bands 0.2863, nearest 0.0984) against this kernel's 0.1440 (0.3475,
// 0.1260); at the flagship (d_h 6, the spans read about twice) K15 took
// 0.0438 ms against the parent's 0.0390 and this kernel's 0.0403
// (tools/tune_aligned.py, NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6).  By
// launches x gap the staged design would have saved more (506 K18
// launches x 0.018 ms against 25 K15 launches x 0.0035): this kernel was
// kept for K15's 5% limit at the flagship, and choosing the design by d_h
// is queued (ROADMAP.md).  A block a 128-column segment with items of 8
// rows (two barriers an item) took 0.0557 at the flagship, 0.1776 at the
// ESW cell.
//
// Where the vertical plan's spans would not fit (bases that climb more
// than some 1500 rows over 8 output rows), the wrapper launches the direct
// vertical kernel, a thread an output column, through the C entry
// xrt_srw_aligned_vertical_f32, and counts those launches apart; the
// horizontal kernel needs no plan and takes any.  Offsets inside a plane
// are 32-bit (the wrappers refuse planes of 2^31 elements or more), band
// offsets 64-bit.
#include <mutex>

#include "srw_common.h"

namespace {

constexpr int kThreads = 128;  // the direct vertical kernel
// blocks an SM that __launch_bounds__ asks of the direct kernel: with one
// tile 16 (32 registers), tiled 8 (up to 64)
constexpr int kOneTileMinBlocks = 16;
constexpr int kTiledMinBlocks = 8;
constexpr int kMaxGridY = 65535;
// the staged vertical kernel: threads a block, source columns a block
// (srw_aligned.py mirrors kVCols), blocks an SM asked of its registers
constexpr int kVThreads = 128;
constexpr int kVCols = 32;
constexpr int kVMinBlocks = 4;
// the horizontal kernel: threads a block (a thread an output column, a warp
// a span; srw_aligned.py mirrors the warp), rows a row group, blocks an SM
// asked of its registers
constexpr int kHThreads = 128;
constexpr int kHRows = 8;  // at most; fewer where the launch would be small (group_rows)
constexpr int kHMinBlocks = 10;
// the columns of a v flag word (the vertical kernel's block)
constexpr int kHWord = kVCols;
// the blocks a horizontal launch should have where fewer rows a group give
// them: two an SM of the H100's 132 (srw_aligned.py mirrors it; the vertical
// plan keeps as many where its spans allow)
constexpr int kSpreadBlocks = 264;

// The horizontal kernel's rows a row group: the most of kHRows, kHRows / 2,
// ..., 1 that leave the launch kSpreadBlocks blocks (a two-pass mosaic's
// small pieces), else 1 (srw_aligned.horizontal_rows mirrors it).
__host__ __device__ inline int group_rows(int64_t out_h, int64_t out_w) {
  const int64_t n_cb = (out_w + kHThreads - 1) / kHThreads;
  int rows = kHRows;
  while (rows > 1 && n_cb * ((out_h + rows - 1) / rows) < kSpreadBlocks) rows /= 2;
  return rows;
}

template <int M>
__device__ __forceinline__ float weight(float p, float k) {
  return M == xrt::kNearest ? (rintf(p) == k ? 1.0f : 0.0f) : fmaxf(0.0f, 1.0f - fabsf(p - k));
}

// sum_{d < n} w(p, k0 + d) * tap(d), in XLA's order: fma(w0, t0, w1 * t1),
// then fma(w_d, t_d, acc).
template <int M, typename Tap>
__device__ __forceinline__ float tap_sum(float p, int k0, int n, const Tap& tap) {
  const float w0 = weight<M>(p, static_cast<float>(k0));
  const float t0 = tap(0);
  if (n == 1) return w0 * t0;
  const float prod1 = weight<M>(p, static_cast<float>(k0 + 1)) * tap(1);
  float acc = fmaf(w0, t0, prod1);
  for (int d = 2; d < n; ++d) {
    acc = fmaf(weight<M>(p, static_cast<float>(k0 + d)), tap(d), acc);
  }
  return acc;
}

// The shortcut's taps x, y (relative to k0) and weights: the sum is
// fma(wx, t_x, wy * t_y) where the taps are finite and it is not +-0; ok
// false where no tap weighs or p is NaN (see the header note).
struct Pair {
  int x, y;
  float wx, wy;
  bool ok;
};

template <int M>
__device__ __forceinline__ Pair pair_for(float p, int k0, int n) {
  // exact: integers below 2^24
  const float fa = (M == xrt::kNearest ? rintf(p) : floorf(p)) - static_cast<float>(k0);
  if (!(fa >= (M == xrt::kNearest ? 0.0f : -1.0f) && fa < static_cast<float>(n))) {
    return Pair{0, 0, 0.0f, 0.0f, false};
  }
  const int a = static_cast<int>(fa);
  if (M == xrt::kNearest) return Pair{a, a, 0.0f, 1.0f, true};
  if (a < 0) return Pair{0, 0, 0.0f, weight<M>(p, static_cast<float>(k0)), true};
  const float wa = weight<M>(p, static_cast<float>(k0 + a));
  if (a == n - 1) return Pair{a, a, 0.0f, wa, true};
  const float wb = weight<M>(p, static_cast<float>(k0 + a + 1));
  if (a == 0) return Pair{0, 1, wa, wb, true};
  return Pair{a + 1, a, wb, wa, true};
}

// The output at position p from d_n taps of a staged window (tap d at
// sp[d * stride]); finite: every value of the window is finite.
template <int M>
__device__ __forceinline__ float aligned_sum(const float* sp, int stride, float p, int k0,
                                             int n, bool finite) {
  if (finite) {
    const Pair q = pair_for<M>(p, k0, n);
    if (q.ok) {
      const float r = fmaf(q.wx, sp[q.x * stride], q.wy * sp[q.y * stride]);
      if (r != 0.0f) return r;
    }
  }
  return tap_sum<M>(p, k0, n, [&](int d) { return sp[d * stride]; });
}

__device__ __forceinline__ int clamp_int(int i, int n) { return i < 0 ? 0 : (i > n - 1 ? n - 1 : i); }

// -- the staged kernels -----------------------------------------------------

// win: (n_row_blocks, n_col_tiles, 2) spans of bases in shifted row space
template <int M>
__global__ void __launch_bounds__(kVThreads, kVMinBlocks)
    srw_aligned_vertical_kernel(const float* __restrict__ src, const float* __restrict__ iystar_c,
                                const int32_t* __restrict__ s_v,
                                const int32_t* __restrict__ base_v,
                                const int32_t* __restrict__ win, float* __restrict__ v,
                                uint8_t* __restrict__ flags, int batch, int src_h, int src_w,
                                int out_h, int ncj, int ncc, float inv, int n_col_tiles,
                                int col_tile, int d_v, int rows, int extent) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage = extent * kVCols;               // floats a window buffer
  float* spos = smem + 2 * stage;                  // (rows, kVCols) positions
  int* sbase = reinterpret_cast<int*>(spos + rows * kVCols);  // (rows,) bases

  const int c0 = blockIdx.x * kVCols;
  const int width = min(kVCols, src_w - c0);
  const int tile = c0 / col_tile;
  const int cx = threadIdx.x % kVCols;
  const int ry = threadIdx.x / kVCols;
  constexpr int kRowGroups = kVThreads / kVCols;
  const int c = c0 + cx;
  const bool live = cx < width;
  // a thread stages, and sums, its own column: its shift once
  const int sv = live ? s_v[c] : 0;
  const float shift = static_cast<float>(sv);
  const int n_rb = (out_h + rows - 1) / rows;
  // this block's items: row blocks blockIdx.y, + gridDim.y, ..., each band
  const int n_mine = static_cast<int>(blockIdx.y) < n_rb
      ? (n_rb - static_cast<int>(blockIdx.y) + gridDim.y - 1) / gridDim.y : 0;
  const int n_items = n_mine * batch;
  const int64_t src_plane = static_cast<int64_t>(src_h) * src_w;
  const int64_t v_plane = static_cast<int64_t>(out_h) * src_w;
  const int n_words = (src_w + kVCols - 1) / kVCols;  // flags a row

  auto row_block = [&](int it) { return static_cast<int>(blockIdx.y) + (it / batch) * gridDim.y; };
  auto issue = [&](int it) {
    const int32_t* w = win + (row_block(it) * n_col_tiles + tile) * 2;
    // staged row i holds source row clamp(w[0] + i + s_v[c])
    const int lo = w[0] + sv;
    const int h = w[1] - w[0];
    float* s = smem + (it & 1) * stage + cx;
    if (live) {
      const float* col = src + (it % batch) * src_plane + c;
      for (int i = ry; i < h; i += kRowGroups) {
        xrt::cp_async4(s + i * kVCols, col + clamp_int(lo + i, src_h) * src_w);
      }
    }
    xrt::cp_async_commit();
  };

  xrt::FieldColumn field(iystar_c, ncj, ncc, static_cast<float>(c), inv);
  if (n_items > 0) issue(0);
  for (int it = 0; it < n_items; ++it) {
    const int rb = row_block(it);
    const int b = it % batch;
    const int j0 = rb * rows;
    const int nrows = min(rows, out_h - j0);
    const bool more = it + 1 < n_items;
    if (more) issue(it + 1);
    if (b == 0) {
      // positions and bases of this row block, once for every band; each
      // thread computes the positions it sums
      for (int r = ry; r < nrows; r += kRowGroups) {
        spos[r * kVCols + cx] = field.at(static_cast<float>(j0 + r)) - shift;
      }
      for (int r = threadIdx.x; r < nrows; r += kVThreads) {
        sbase[r] = base_v[(j0 + r) * n_col_tiles + tile];
      }
    }
    if (more) {
      xrt::cp_async_wait<1>();
    } else {
      xrt::cp_async_wait<0>();
    }
    const float* st = smem + (it & 1) * stage;
    const int32_t* w = win + (rb * n_col_tiles + tile) * 2;
    const int lo = w[0];
    // each thread tests the values it staged (its copies are complete for
    // it); the vote is the barrier after which every copy and position is
    // seen by all
    bool bad = false;
    if (live) {
      for (int i = ry; i < w[1] - lo; i += kRowGroups) bad |= !isfinite(st[i * kVCols + cx]);
    }
    const bool finite = !__syncthreads_or(bad);
    float* vb = v + b * v_plane + static_cast<int64_t>(j0) * src_w + c;
    // a warp is a row's kVCols columns: one flag a row, its word of v
    uint8_t* fb = flags == nullptr ? nullptr
        : flags + (static_cast<int64_t>(b) * n_words + blockIdx.x) * out_h + j0;
    for (int r = ry; r < nrows; r += kRowGroups) {
      float out = 0.0f;
      if (live) {
        const int k0 = sbase[r];
        out = aligned_sum<M>(st + (k0 - lo) * kVCols + cx, kVCols, spos[r * kVCols + cx], k0,
                             d_v, finite);
        vb[r * src_w] = out;
      }
      const unsigned bad = __ballot_sync(0xffffffffu, live && !isfinite(out));
      if (fb != nullptr && cx == 0) fb[r] = bad != 0;
    }
    __syncthreads();  // the buffer and the geometry are rewritten next
  }
}

// Every tap of an output whose taps were not all known finite.
template <int M>
__device__ __forceinline__ float every_tap(const float* row, float q, int k0, int first, int d_h,
                                        int src_w) {
  return tap_sum<M>(q, k0, d_h, [&](int d) { return row[clamp_int(first + d, src_w)]; });
}

// A block covers kHThreads output columns (a thread a column) and walks
// row groups of `rows` rows, each cut where a row tile ends into runs.  A
// warp's 32 columns read, in row r, v's columns [lo, hi) + s_h[r] ([lo,
// hi) the least base of its columns in the row tile to the greatest plus
// d_h, a warp reduction once a row tile).  For each run and band the lanes
// first decide whether those spans of all the run's rows are finite (one
// vote a band): with kFlags from the vertical pass's flags of the words of
// kHWord columns the spans touch, else from the spans' values, every load
// issued before any is tested.  Then each row takes its geometry once for
// every band, and each output its two taps, through L1.
template <int M, bool kFlags>
__global__ void __launch_bounds__(kHThreads, kHMinBlocks)
    srw_aligned_horizontal_kernel(const float* __restrict__ v,
                                  const uint8_t* __restrict__ flags,
                                  const float* __restrict__ ix_c,
                                  const float* __restrict__ iy_c,
                                  const int32_t* __restrict__ s_h,
                                  const int32_t* __restrict__ base_h, float* __restrict__ out,
                                  int batch, int out_h, int src_w, int out_w, int src_h, int ncj,
                                  int nci, float inv, int row_tile, int d_h, float fill,
                                  int rows) {
  const int c = blockIdx.x * kHThreads + threadIdx.x;
  const bool live = c < out_w;
  const int lane = threadIdx.x & 31;
  const xrt::CoarseFields<2> g{{ix_c, iy_c}, ncj, nci, inv};
  xrt::FieldCols<2, 1> fields(g, static_cast<float>(c));
  // the bounds in float32, as the JAX package compares them
  const float x_hi = static_cast<float>(static_cast<double>(src_w) - 0.5);
  const float y_hi = static_cast<float>(static_cast<double>(src_h) - 0.5);
  const int64_t v_plane = static_cast<int64_t>(out_h) * src_w;
  const int64_t out_plane = static_cast<int64_t>(out_h) * out_w;
  const int n_words = (src_w + kHWord - 1) / kHWord;
  const int n_rg = (out_h + rows - 1) / rows;
  // the row tile; the column's base; the warp's span: its first base and
  // width, and the flag words it touches a row at most
  int u = -1, k0 = 0, w_lo = 0, w_n = 0, w_words = 1;
  for (int rg = blockIdx.y; rg < n_rg; rg += gridDim.y) {
    const int g_end = min(out_h, (rg + 1) * rows);
    for (int j0 = rg * rows; j0 < g_end;) {
      if (j0 / row_tile != u) {
        u = j0 / row_tile;
        k0 = live ? base_h[u * out_w + c] : 0;
        w_lo = __reduce_min_sync(0xffffffffu, live ? k0 : INT32_MAX);
        const int w_hi = __reduce_max_sync(0xffffffffu, live ? k0 : INT32_MIN);
        w_n = w_lo > w_hi ? 0 : w_hi - w_lo + d_h;  // 0: no column of the warp is live
        w_words = (w_n + kHWord - 2) / kHWord + 1;
      }
      const int j1 = min(g_end, (u + 1) * row_tile);  // the run [j0, j1), one row tile
      for (int b0 = 0; b0 < batch; b0 += 32) {
        const int nb = min(32, batch - b0);
        // bit bb: band b0 + bb's spans in the run all finite
        unsigned fin = 0;
        for (int bb = 0; bb < nb; ++bb) {
          bool ok = true;
          if (w_n == 0) {
          } else if (kFlags) {
            // lane e: row j0 + e / w_words, its span's e % w_words-th word
            const uint8_t* fb = flags + static_cast<int64_t>(b0 + bb) * n_words * out_h;
            for (int e = lane; e < (j1 - j0) * w_words; e += 32) {
              const int j = j0 + e / w_words;
              const int lo = clamp_int(w_lo + s_h[j], src_w);
              const int hi = clamp_int(w_lo + s_h[j] + w_n - 1, src_w);
              const int word = lo / kHWord + e % w_words;
              if (word <= hi / kHWord) ok &= fb[static_cast<int64_t>(word) * out_h + j] == 0;
            }
          } else {
            const float* plane = v + (b0 + bb) * v_plane;
            for (int j = j0; j < j1; ++j) {
              const float* row = plane + static_cast<int64_t>(j) * src_w;
              const int lo = w_lo + s_h[j];
              for (int t = lane; t < w_n; t += 32) ok &= isfinite(row[clamp_int(lo + t, src_w)]);
            }
          }
          fin |= static_cast<unsigned>(__all_sync(0xffffffffu, ok)) << bb;
        }
        for (int j = j0; j < j1; ++j) {
          const int sh = s_h[j];
          float f[2][1];
          fields.at(g, static_cast<float>(j), f);
          const float ix = f[0][0];
          const float iy = f[1][0];
          const bool valid = ix > -0.5f && ix < x_hi && iy > -0.5f && iy < y_hi;
          const float q = ix - static_cast<float>(sh);
          const Pair pr = pair_for<M>(q, k0, d_h);
          const int first = k0 + sh;  // tap 0's v column
          for (int bb = 0; bb < nb; ++bb) {
            const int b = b0 + bb;
            const float* row = v + b * v_plane + static_cast<int64_t>(j) * src_w;
            float o = fill;
            if (valid) {
              o = fmaf(pr.wx, row[clamp_int(first + pr.x, src_w)],
                       pr.wy * row[clamp_int(first + pr.y, src_w)]);
              if (!(fin >> bb & 1u) || !pr.ok || o == 0.0f) {
                o = every_tap<M>(row, q, k0, first, d_h, src_w);
              }
            }
            if (live) out[b * out_plane + static_cast<int64_t>(j) * out_w + c] = o;
          }
        }
      }
      j0 = j1;
    }
  }
}

// -- the direct vertical kernel: a thread an output column ----------------

template <int M, bool kTiled>
__global__ void __launch_bounds__(kThreads, kTiled ? kTiledMinBlocks : kOneTileMinBlocks)
    srw_aligned_vertical_direct(const float* __restrict__ src, const float* __restrict__ iystar_c,
                                const int32_t* __restrict__ s_v,
                                const int32_t* __restrict__ base_v, float* __restrict__ v,
                                int batch, int src_h, int src_w, int out_h, int ncj, int ncc,
                                float inv, int n_col_tiles, int col_tile, int d_v) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= src_w) return;
  const int sv = s_v[c];
  const float shift = static_cast<float>(sv);
  // column t of (out_h, n_col_tiles)
  const int32_t* bases = kTiled ? base_v + c / col_tile : base_v;
  const int stride = kTiled ? n_col_tiles : 1;
  xrt::FieldColumn field(iystar_c, ncj, ncc, static_cast<float>(c), inv);
  const int64_t src_plane = static_cast<int64_t>(src_h) * src_w;
  const int64_t v_plane = static_cast<int64_t>(out_h) * src_w;
  for (int r = blockIdx.y; r < out_h; r += gridDim.y) {
    const float p = field.at(static_cast<float>(r)) - shift;
    const int k0 = bases[r * stride];
    const int lo = k0 + sv;  // tap d reads source row clamp(lo + d)
    for (int b = 0; b < batch; ++b) {
      const float* col = src + b * src_plane + c;
      v[b * v_plane + r * src_w + c] =
          tap_sum<M>(p, k0, d_v, [&](int d) { return col[clamp_int(lo + d, src_h) * src_w]; });
    }
  }
}

dim3 grid_for(int64_t cols, int64_t rows) {
  return dim3(static_cast<unsigned>((cols + kThreads - 1) / kThreads),
              static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
}

// Raise the staged vertical kernel's shared memory limit on the current
// device to `smem` where it is lower: once a device and size, not on every
// launch (the attribute only grows, under a lock).
template <int M>
cudaError_t allow_vertical_smem(size_t smem) {
  constexpr int kDevices = 64;
  static std::mutex lock;
  static size_t allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return xrt::allow_smem(srw_aligned_vertical_kernel<M>, smem);
  const std::lock_guard<std::mutex> guard(lock);
  if (smem <= allowed[dev]) return cudaSuccess;
  err = xrt::allow_smem(srw_aligned_vertical_kernel<M>, smem);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}

template <int M>
cudaError_t launch_vertical(const float* src, const float* iystar_c, const int32_t* s_v,
                            const int32_t* base_v, const int32_t* win, float* v,
                            uint8_t* flags, int batch,
                            int src_h, int src_w, int out_h, int ncj, int ncc, float inv,
                            int n_col_tiles, int col_tile, int d_v, int rows, int extent,
                            dim3 grid, size_t smem, cudaStream_t s) {
  const cudaError_t err = allow_vertical_smem<M>(smem);
  if (err != cudaSuccess) return err;
  srw_aligned_vertical_kernel<M><<<grid, kVThreads, smem, s>>>(
      src, iystar_c, s_v, base_v, win, v, flags, batch, src_h, src_w, out_h, ncj, ncc, inv,
      n_col_tiles, col_tile, d_v, rows, extent);
  return cudaGetLastError();
}

}  // namespace

// K14/K17, staged: win the (n_row_blocks, n_col_tiles, 2) spans of the
// host's plan (srw_aligned.plan_vertical) for blocks of `rows` output rows
// and kVCols source columns, each at most `extent` rows; walkers the
// blocks along the row blocks.  col_tile must be a multiple of kVCols
// where there is more than one column tile.  flags (B, ceil(src_w /
// kVCols), out_h) uint8, or null: 1 where that word of kVCols columns of a
// v row holds a value that is not finite.
extern "C" int xrt_srw_aligned_vertical_staged_f32(
    const float* src, const float* iystar_c, const int32_t* s_v, const int32_t* base_v,
    const int32_t* win, float* v, uint8_t* flags, int64_t batch, int64_t src_h, int64_t src_w,
    int64_t out_h,
    int64_t ncj, int64_t ncc, int step, int64_t n_col_tiles, int64_t col_tile, int d_v,
    int method, int rows, int extent, int64_t walkers, void* stream) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(extent) * kVCols +
                                       static_cast<size_t>(rows) * kVCols + rows);
  if (rows < 1 || extent < 1 || d_v < 1 || batch < 1 || walkers < 1 || walkers > 65535 ||
      smem > 232448 || (n_col_tiles > 1 && col_tile % kVCols != 0) ||
      batch * ((out_h + rows - 1) / rows) > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float inv = static_cast<float>(1.0 / step);
  const dim3 grid(static_cast<unsigned>((src_w + kVCols - 1) / kVCols),
                  static_cast<unsigned>(walkers));
  const auto s = static_cast<cudaStream_t>(stream);
#define XRT_ARGS                                                                           \
  src, iystar_c, s_v, base_v, win, v, flags, static_cast<int>(batch),                       \
      static_cast<int>(src_h),                                                              \
      static_cast<int>(src_w), static_cast<int>(out_h), static_cast<int>(ncj),              \
      static_cast<int>(ncc), inv, static_cast<int>(n_col_tiles), static_cast<int>(col_tile), \
      d_v, rows, extent, grid, smem, s
  cudaError_t err;
  switch (method) {
    case xrt::kBilinear: err = launch_vertical<xrt::kBilinear>(XRT_ARGS); break;
    case xrt::kNearest: err = launch_vertical<xrt::kNearest>(XRT_ARGS); break;
    default: err = cudaErrorInvalidValue;
  }
#undef XRT_ARGS
  return static_cast<int>(err);
}

// K14/K17, direct (the plan's alternative): a thread an output column
// walking rows, every tap read from global memory.
extern "C" int xrt_srw_aligned_vertical_f32(const float* src, const float* iystar_c,
                                            const int32_t* s_v, const int32_t* base_v, float* v,
                                            int64_t batch, int64_t src_h, int64_t src_w,
                                            int64_t out_h, int64_t ncj, int64_t ncc, int step,
                                            int64_t n_col_tiles, int64_t col_tile, int d_v,
                                            int method, void* stream) {
  const float inv = static_cast<float>(1.0 / step);
  const dim3 grid = grid_for(src_w, out_h);
  const auto s = static_cast<cudaStream_t>(stream);
#define XRT_ARGS                                                                            \
  src, iystar_c, s_v, base_v, v, static_cast<int>(batch), static_cast<int>(src_h),           \
      static_cast<int>(src_w), static_cast<int>(out_h), static_cast<int>(ncj),               \
      static_cast<int>(ncc), inv, static_cast<int>(n_col_tiles), static_cast<int>(col_tile), \
      d_v
  const bool tiled = n_col_tiles > 1;
  if (method == xrt::kBilinear && tiled) {
    srw_aligned_vertical_direct<xrt::kBilinear, true><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else if (method == xrt::kBilinear) {
    srw_aligned_vertical_direct<xrt::kBilinear, false><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else if (method == xrt::kNearest && tiled) {
    srw_aligned_vertical_direct<xrt::kNearest, true><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else if (method == xrt::kNearest) {
    srw_aligned_vertical_direct<xrt::kNearest, false><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XRT_ARGS
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <bool kFlags>
int launch_horizontal(const float* v, const uint8_t* flags, const float* ix_c,
                      const float* iy_c, const int32_t* s_h, const int32_t* base_h, float* out,
                      int64_t batch, int64_t out_h, int64_t src_w, int64_t out_w,
                      int64_t src_h, int64_t ncj, int64_t nci, int step, int64_t row_tile,
                      int d_h, int method, float fill, void* stream) {
  if (batch < 1 || out_h < 1 || row_tile < 1 || step < 1 || d_h < 1 ||
      out_w > INT32_MAX - kHThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = group_rows(out_h, out_w);
  const int64_t n_rg = (out_h + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>((out_w + kHThreads - 1) / kHThreads),
                  static_cast<unsigned>(n_rg < kMaxGridY ? n_rg : kMaxGridY));
  const auto s = static_cast<cudaStream_t>(stream);
#define XRT_ARGS                                                                           \
  v, flags, ix_c, iy_c, s_h, base_h, out, static_cast<int>(batch), static_cast<int>(out_h), \
      static_cast<int>(src_w), static_cast<int>(out_w), static_cast<int>(src_h),            \
      static_cast<int>(ncj), static_cast<int>(nci), static_cast<float>(1.0 / step),         \
      static_cast<int>(row_tile < out_h ? row_tile : out_h), d_h, fill, rows
  if (method == xrt::kBilinear) {
    srw_aligned_horizontal_kernel<xrt::kBilinear, kFlags><<<grid, kHThreads, 0, s>>>(XRT_ARGS);
  } else if (method == xrt::kNearest) {
    srw_aligned_horizontal_kernel<xrt::kNearest, kFlags><<<grid, kHThreads, 0, s>>>(XRT_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XRT_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K15/K18, on any v: each warp tests its spans' values.
extern "C" int xrt_srw_aligned_horizontal_f32(const float* v, const float* ix_c,
                                              const float* iy_c, const int32_t* s_h,
                                              const int32_t* base_h, float* out, int64_t batch,
                                              int64_t out_h, int64_t src_w, int64_t out_w,
                                              int64_t src_h, int64_t ncj, int64_t nci, int step,
                                              int64_t row_tile, int d_h, int method, float fill,
                                              void* stream) {
  return launch_horizontal<false>(v, nullptr, ix_c, iy_c, s_h, base_h, out, batch, out_h, src_w,
                                  out_w, src_h, ncj, nci, step, row_tile, d_h, method, fill,
                                  stream);
}

// K15/K18 on a v that the staged vertical kernel wrote with its flags
// (B, ceil(src_w / kVCols), out_h): each warp tests the flags.
extern "C" int xrt_srw_aligned_horizontal_flagged_f32(
    const float* v, const uint8_t* flags, const float* ix_c, const float* iy_c,
    const int32_t* s_h, const int32_t* base_h, float* out, int64_t batch, int64_t out_h,
    int64_t src_w, int64_t out_w, int64_t src_h, int64_t ncj, int64_t nci, int step,
    int64_t row_tile, int d_h, int method, float fill, void* stream) {
  return launch_horizontal<true>(v, flags, ix_c, iy_c, s_h, base_h, out, batch, out_h, src_w,
                                 out_w, src_h, ncj, nci, step, row_tile, d_h, method, fill,
                                 stream);
}
