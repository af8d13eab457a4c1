// K2: the SRW horizontal tap pass, its geometry, the triangular
// correction and the fill.
//
//   p     = interp_field(ix_c, j, i),  iy = interp_field(iy_c, j, i)
//   acc   = sum_{d < d_h} w(p, base + d)  * v[b, j, clamp(base + d)]
//   acc_d = sum_{d < d_h} dw(p, base + d) * vd[b, j, clamp(base + d)]
//   out[b, j, i] = valid ? (triangular ? acc - s * acc_d : acc) : fill
//   with base = base_h[j / row_tile, i], valid = p and iy inside
//   (-0.5, n - 0.5), s = min(u * vf, (1 - u) * (1 - vf)) for the
//   fractional parts u of p and vf of iy.
//
// Replaces the XLA horizontal pass of xcube_resampling_tpu/ops/srw.py:
// make_srw_fn (:670-695) and its geometry precompute (:615-632).
//
// Bound on the H100: device memory.  The work must read v once (vd too
// for triangular) and write the output once; the geometry comes from two
// coarse fields of a few MB that stay in L2, where the precompute it
// replaces read 2.1 GB of per-pixel positions, mask and weights at 20480^2.
//
// The band form (srw_horizontal_band) is the sharded SRW's horizontal
// pass, xcube_resampling_tpu/parallel/halo.py:450-481: v holds one mesh
// band's rows, output row j lies at global target row row0 + j, where its
// geometry (positions, mask, s) is interpolated, and the bases are the
// band's tiles of base_h.  The tile of row j is j / row_tile: on the
// band's last, overlapping tile that is min(j / row_tile, tiles - 1), as
// halo.py:472-474 takes it, since the band's tiles cover its rows.  K2 is
// the band form at row0 = 0 on the whole target: one kernel serves both.
//
// Measured on an H100 80GB HBM3 at 700 W at BASELINE #5's band (v (4, 5120,
// 20480), tools/tune_srw.py --band), the block design this kernel replaced
// (64 columns x 32 rows a block, three block barriers a (row block, band))
// took 2.24 ms against a bound of 1.01; skipping its finiteness scan (a
// second pass over every window) took 25% off, its staging loop's division
// nothing, computing the geometry once 9%.  A warp design with 2 columns a
// lane and the same tap code was no faster (2.29): the work an output, not
// the barriers, held it, and then latency at the occupancy its registers
// allowed.
// Design: a warp a task, no block barrier.  A task is one 32 * kBandPerLane
// column segment (one column block of the host's windows) over kBandRows
// output rows and every band; a block holds up to kBandWarps independent
// tasks, neighbouring segments of the same rows (their windows overlap in
// L2).  Each warp streams its items through a ring of S buffers of its own
// in shared memory with cp.async (16-byte copies where v's rows allow them;
// edge groups clamp), an item being one row's windows for up to G bands;
// __syncwarp orders the ring.  The host sizes the launch
// (srw_kernels.plan_band_launch): G the most bands (4, 2 or 1) up to the
// batch, S = 3 stages, 4 warps a block; then fewer bands an item until
// the block's shared memory leaves the SM room for the blocks its registers
// allow, and one stage and fewer warps a block until it fits at all (wide
// windows: a downscale).  G and S are template parameters: taken at run
// time they cost the registers that the cap below leaves no room for.
// A lane owns columns lane + 32 k of the segment (k < kBandPerLane): its
// shared-memory reads fall on consecutive words across the warp and its
// stores coalesce.  Once a row, for every band of it, a lane takes each
// column's mask, s and the place of the two taps that can weigh in the
// window with their weights, moved into a pair (off, off + 1) and weighted 0
// where a tap lies outside the column's d_h taps (exact where the row is
// finite: x + 0 * s == x, and +0 stays +0).  So an output is two shared
// loads and two fused multiply-adds, taken while the lanes test the band's
// window row (one __all_sync); where the row is not finite, every tap is
// summed as srw_common.h's tap_sums sums them.  Registers are capped for 5
// blocks of 4 warps an SM without a spill (2 for triangular): the cap took
// 1.90 to 1.56 ms, a row's windows for 4 bands an item (more bytes in
// flight a warp, the item's overhead shared) 1.63 to 1.49.  The method is
// a template parameter, the tap loop 32-bit; output offsets are 64-bit.
//
// Float64: the kernel is a template on the value type V of
// v, vd and the output, and its float64 instantiation is K2's float64
// form, the pass of a float64 source (the JAX package multiplies its
// float32 weights by the float64 vertical pass, so jnp promotes the
// products and sums to float64): each tap one float64 fused multiply-add of
// the widened float32 weight (srw_common.h's fused_v), the triangular
// correction acc - s * acc_d likewise, the fill where the position lies
// outside the source; the positions, mask and s K2's float32 geometry.
// The two-tap shortcut stays exact in float64 (x + 0 * s == x, +0 stays
// +0).  Its 16-byte copies carry two doubles; its ring is sized by the
// host for 8-byte words (srw_kernels.plan_band_launch), its registers
// capped for kBandMinBlocksF64 blocks.  The design it replaced
// (srw_horizontal_f64.cu: a thread an output pixel summing all d_h taps
// through L1, no staging, no shortcut) took 8.117 device ms at 20480^2
// bilinear against a bound of 2.008 (H100 80GB HBM3, 700 W).
#include "srw_common.h"

namespace {

// warps a block, at most (srw_kernels.py mirrors it); the bands of a row an
// item stages together, G, serve the row's geometry (a lane sums them one
// at a time: two or four at once spilled, slower)
constexpr int kBandWarps = 4;
constexpr int kBandRows = 16;
constexpr int kBandPerLane = 4;
constexpr int kBandCols = 32 * kBandPerLane;
// blocks an SM the registers are capped for (102 registers), but 2 for
// triangular (its second window and weights): the most that spill nothing;
// 2 also for one stage, whose windows leave room for no more than 2 blocks
constexpr int kBandMinBlocks = 5;
constexpr int kBandMinBlocksTri = 2;
// float64: 4 blocks (128 registers; the doubled sums), 2 for triangular
constexpr int kBandMinBlocksF64 = 4;

template <typename V>
struct BandArgs {
  const V* v;
  const V* vd;
  const float* ix_c;
  const float* iy_c;
  const int32_t* base;  // (tiles, out_w)
  const int32_t* win;   // (tiles, n_cb, 2)
  V* out;
  int64_t batch, out_h, out_w, src_h, src_w, ncj, nci, row_tile, n_cb, row0;
  float inv;
  V fill;
  int d_h, extent;
  bool vec4;
};

template <typename V, int M, int S>
constexpr int min_blocks() {
  return M == xrt::kTriangular || S == 1 ? kBandMinBlocksTri
                                         : (sizeof(V) == 8 ? kBandMinBlocksF64 : kBandMinBlocks);
}


// Stage window columns [lo, lo + width) of one v row into s (a warp):
// window column q holds v column clamp(lo + q); width and lo are multiples
// of 4, so with vec4 a 4-column group lies wholly inside v (16-byte
// copies: one of float32, two of float64) or wholly outside (four copies
// of the edge column).
template <typename V>
__device__ __forceinline__ void stage_row(V* s, const V* row, int lo, int width, int64_t src_w,
                                          bool vec4, int lane) {
  constexpr int E = 16 / sizeof(V);  // values a 16-byte copy
  if (vec4) {
    for (int q = 4 * lane; q < width; q += 128) {
      const int c = lo + q;
      if (c >= 0 && c + 4 <= src_w) {
#pragma unroll
        for (int e = 0; e < 4; e += E) xrt::cp_async16(s + q + e, row + c + e);
      } else {
        for (int t = 0; t < 4; ++t) {
          xrt::cp_async_word(s + q + t, row + xrt::clamp_index(c + t, src_w));
        }
      }
    }
  } else {
    for (int q = lane; q < width; q += 32) {
      xrt::cp_async_word(s + q, row + xrt::clamp_index(lo + q, src_w));
    }
  }
}

// True on every lane when the staged row s[0, width) is all finite.
__device__ __forceinline__ bool row_finite(const float* s, int width, int lane) {
  bool ok = true;
  for (int q = 4 * lane; q < width; q += 128) {
    const float4 x = *reinterpret_cast<const float4*>(s + q);
    ok = ok && isfinite(x.x) && isfinite(x.y) && isfinite(x.z) && isfinite(x.w);
  }
  return __all_sync(0xffffffffu, ok);
}

__device__ __forceinline__ bool row_finite(const double* s, int width, int lane) {
  bool ok = true;
  for (int q = 2 * lane; q < width; q += 64) {
    const double2 x = *reinterpret_cast<const double2*>(s + q);
    ok = ok && isfinite(x.x) && isfinite(x.y);
  }
  return __all_sync(0xffffffffu, ok);
}

// The output at (row, col) of a window row that is not finite: every tap,
// as tap_sums sums them, at the column's position taken afresh (FieldColumn: the
// same operations as FieldCols), so that the fast path keeps no positions.
template <int M, typename V>
__device__ __forceinline__ V slow_sum(const BandArgs<V>& a, const V* sv, int tile, int lo,
                                      float row, int col, float corr) {
  const int b0 = col < a.out_w ? a.base[static_cast<int64_t>(tile) * a.out_w + col] : lo;
  const float p = xrt::FieldColumn(a.ix_c, a.ncj, a.nci, static_cast<float>(col), a.inv).at(row);
  V acc = V(0);
  V acc_d = V(0);
  xrt::tap_sums<M>(sv + (b0 - lo), 1, p, b0, a.d_h, false, acc, acc_d);
  if (M == xrt::kTriangular) {
    V acc_dd = V(0);  // the (1, -1) taps of vd
    V unused = V(0);
    xrt::tap_sums<M>(sv + a.extent + (b0 - lo), 1, p, b0, a.d_h, false, unused, acc_dd);
    acc = xrt::fused_v(-corr, acc_dd, acc);
  }
  return acc;
}

template <typename V, int M, int G, int S>
__global__ void __launch_bounds__(kBandWarps * 32, min_blocks<V, M, S>())
    srw_horizontal_kernel(BandArgs<V> a) {
  constexpr bool kTri = M == xrt::kTriangular;
  constexpr int P = kBandPerLane;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const int cb = static_cast<int>(task % a.n_cb);
  const int j_first = static_cast<int>(task / a.n_cb) * kBandRows;
  if (j_first >= a.out_h) return;  // the whole warp: the kernel has no block barrier
  const int n_rows = static_cast<int>(a.out_h - j_first < kBandRows ? a.out_h - j_first
                                                                    : kBandRows);
  const int batch = static_cast<int>(a.batch);
  const int n_groups = (batch + G - 1) / G;
  const int n_items = n_rows * n_groups;  // (row, group of bands), the group fastest
  const int plane = (kTri ? 2 : 1) * a.extent;  // one band's window row (and vd's)
  const int stage = G * plane;
  extern __shared__ float4 smem4[];
  V* ring = reinterpret_cast<V*>(smem4) + warp * S * stage;
  const int32_t* win = a.win + cb * 2;
  const int win_step = static_cast<int>(a.n_cb) * 2;  // one row tile on
  const int row_tile = static_cast<int>(a.row_tile);

  // the next item to stage
  int is_r = 0, is_g = 0;
  auto issue = [&](int slot) {
    if (is_r < n_rows) {
      const int j = j_first + is_r;
      const int32_t* w = win + j / row_tile * win_step;
      const int w_lo = w[0], w_width = w[1] - w[0];
      V* dst = ring + slot * stage;
      // (one band an item: that band, which the compiler then keeps in
      // fewer registers)
      const int b_end = G == 1 ? is_g + 1 : min(batch, (is_g + 1) * G);
      for (int b = is_g * G; b < b_end; ++b, dst += plane) {
        const int64_t off = (b * a.out_h + j) * a.src_w;
        stage_row(dst, a.v + off, w_lo, w_width, a.src_w, a.vec4, lane);
        if (kTri) stage_row(dst + a.extent, a.vd + off, w_lo, w_width, a.src_w, a.vec4, lane);
      }
      if (++is_g == n_groups) {
        is_g = 0;
        ++is_r;
      }
    }
    xrt::cp_async_commit();  // (empty past the last item: the groups stay counted)
  };
  for (int s = 0; s < S - 1; ++s) issue(s);
  const int i0 = cb * kBandCols;
  const int out_w = static_cast<int>(a.out_w);
  const xrt::CoarseFields<2> g{{a.ix_c, a.iy_c}, static_cast<int>(a.ncj),
                               static_cast<int>(a.nci), a.inv};
  xrt::FieldCols<2, P, 32> fields(g, static_cast<float>(i0 + lane));
  // per column of the lane: the mask, s, and the window column off of a
  // pair of taps (off, off + 1) with their weights wa, wb (da, db for vd's
  // (1, -1) taps): the two taps that can weigh, each moved to its place in
  // the pair, and weight 0 where it lies outside the column's d_h taps
  float corr[P], wa[P], wb[P], da[P], db[P];
  int off[P];
  int ok = 0;  // bit k: column k inside the source
  int tile = -1, lo = 0, width = 0;

  int r = 0, grp = 0;
  for (int it = 0; it < n_items; ++it) {
    issue((it + S - 1) % S);
    xrt::cp_async_wait<S - 1>();
    __syncwarp();
    const int j = j_first + r;
    const float row = static_cast<float>(a.row0 + j);
    if (grp == 0) {
      const int t = j / row_tile;
      if (t != tile) {
        tile = t;
        lo = win[t * win_step];
        width = win[t * win_step + 1] - lo;
      }
      float f[2][P];
      fields.at(g, row, f);
      // the bounds in float32, as the JAX package compares them
      const float x_hi = static_cast<float>(static_cast<double>(a.src_w) - 0.5);
      const float y_hi = static_cast<float>(static_cast<double>(a.src_h) - 0.5);
      ok = 0;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int col = i0 + lane + 32 * k;
        const int tap0 = (col < out_w ? a.base[static_cast<int64_t>(tile) * out_w + col] : lo) - lo;
        const float p = f[0][k];
        const float iy = f[1][k];
        if (p > -0.5f && p < x_hi && iy > -0.5f && iy < y_hi) ok |= 1 << k;
        const float fp = floorf(p);
        if (kTri) {
          const float u = p - fp;
          const float vf = iy - floorf(iy);
          corr[k] = fminf(u * vf, (1.0f - u) * (1.0f - vf));
        }
        // srw_common.h's tap_sums where the window is finite: taps t and t + 1
        // from the column's first (t alone for nearest)
        const int t0 = static_cast<int>(M == xrt::kNearest ? rintf(p) : fp) - (tap0 + lo);
        const bool in0 = t0 >= 0 && t0 < a.d_h;
        const bool in1 = t0 + 1 >= 0 && t0 + 1 < a.d_h;
        if (M == xrt::kNearest) {
          off[k] = tap0 + (in0 ? t0 : 0);
          wa[k] = in0 ? 1.0f : 0.0f;
        } else {
          const float w0 = fmaxf(0.0f, 1.0f - fabsf(p - fp));
          const float w1 = fmaxf(0.0f, 1.0f - fabsf(p - (fp + 1.0f)));
          // both taps in: (t, t + 1); t alone: (t - 1, t); t + 1 alone: (t + 1, t + 2);
          // neither: (0, 1), all weights 0
          off[k] = tap0 + (in0 ? (in1 ? t0 : t0 - 1) : (in1 ? t0 + 1 : 0));
          wa[k] = in0 ? (in1 ? w0 : 0.0f) : (in1 ? w1 : 0.0f);
          wb[k] = in0 ? (in1 ? w1 : w0) : 0.0f;
          if (kTri) {
            da[k] = in0 ? (in1 ? 1.0f : 0.0f) : (in1 ? -1.0f : 0.0f);
            db[k] = in0 ? (in1 ? -1.0f : 1.0f) : 0.0f;
          }
        }
      }
    }
    const V* slot = ring + (it % S) * stage;
#pragma unroll 1
    for (int q = 0; q < G; ++q) {
      const int b = grp * G + q;
      if (b >= batch) break;
      const V* sv = slot + q * plane;
      // the outputs as if the window row were finite (acc = fma(w, s, 0)
      // first: tap_sums' first tap onto +0; a weight-0 tap of a finite
      // value leaves the sum as it is), while the row is tested
      V acc[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        acc[k] = xrt::fused_v(wa[k], sv[off[k]], V(0));
        if (M != xrt::kNearest) acc[k] = xrt::fused_v(wb[k], sv[off[k] + 1], acc[k]);
        if (kTri) {
          const V* sd = sv + a.extent;
          V acc_dd = xrt::fused_v(da[k], sd[off[k]], V(0));
          acc_dd = xrt::fused_v(db[k], sd[off[k] + 1], acc_dd);
          acc[k] = xrt::fused_v(-corr[k], acc_dd, acc[k]);
        }
      }
      bool finite = row_finite(sv, width, lane);
      if (kTri) finite = row_finite(sv + a.extent, width, lane) && finite;
      if (!finite) {
        // every tap, as K2 sums them, at each column's position again
#pragma unroll
        for (int k = 0; k < P; ++k) {
          acc[k] = slow_sum<M>(a, sv, tile, lo, row, i0 + lane + 32 * k, kTri ? corr[k] : 0.0f);
        }
      }
      V* ob = a.out + (b * a.out_h + j) * a.out_w + i0 + lane;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (i0 + lane + 32 * k < out_w) ob[32 * k] = (ok >> k & 1) ? acc[k] : a.fill;
      }
    }
    if (++grp == n_groups) {
      grp = 0;
      ++r;
    }
    __syncwarp();  // every lane is done with this buffer before it is staged again
  }
}

template <typename V, int M, int G, int S>
cudaError_t launch(const BandArgs<V>& a, int64_t blocks, int warps, size_t smem,
                   cudaStream_t stream) {
  const cudaError_t err = xrt::allow_smem(srw_horizontal_kernel<V, M, G, S>, smem);
  if (err != cudaSuccess) return err;
  srw_horizontal_kernel<V, M, G, S><<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// the launch plans srw_kernels.plan_band_launch makes: (G, S) of 4, 2 or 1
// bands an item in 3 stages, or 1 band in 1
template <typename V, int M>
cudaError_t launch(const BandArgs<V>& a, int group, int stages, int64_t blocks, int warps,
                   size_t smem, cudaStream_t stream) {
  if (stages == 3 && group == 4) return launch<V, M, 4, 3>(a, blocks, warps, smem, stream);
  if (stages == 3 && group == 2) return launch<V, M, 2, 3>(a, blocks, warps, smem, stream);
  if (stages == 3 && group == 1) return launch<V, M, 1, 3>(a, blocks, warps, smem, stream);
  if (stages == 1 && group == 1) return launch<V, M, 1, 1>(a, blocks, warps, smem, stream);
  return cudaErrorInvalidValue;
}

// K2 and its band form on values of type V (the two C entries below)
template <typename V>
int horizontal(const V* v, const V* vd, const float* ix_c, const float* iy_c,
               const int32_t* base_h, const int32_t* win, V* out, int64_t batch, int64_t out_h,
               int64_t out_w, int64_t src_h, int64_t src_w, int64_t ncj, int64_t nci, int step,
               int64_t row_tile, int d_h, int method, V fill, int cols, int extent,
               int64_t n_col_blocks, int group, int stages, int warps, int vec4, int64_t row0,
               void* stream) {
  const int64_t tasks = n_col_blocks * ((out_h + kBandRows - 1) / kBandRows);
  const size_t smem = sizeof(V) * static_cast<size_t>(warps) * stages * group *
                      (vd != nullptr ? 2 : 1) * static_cast<size_t>(extent);
  if (cols != kBandCols || extent % 4 != 0 || extent < 4 || batch < 1 || batch > 65536 ||
      out_h < 1 || out_h > INT32_MAX || row_tile < 1 || row_tile > INT32_MAX || step < 1 ||
      d_h < 2 || out_w > INT32_MAX - kBandCols || out_h * batch > INT32_MAX ||
      n_col_blocks != (out_w + kBandCols - 1) / kBandCols ||
      (method == xrt::kTriangular) != (vd != nullptr) || warps < 1 || warps > kBandWarps ||
      smem > 232448 || row0 < 0 || (tasks + warps - 1) / warps > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BandArgs<V> a{v, vd, ix_c, iy_c, base_h, win, out, batch, out_h, out_w, src_h, src_w,
                      ncj, nci, row_tile, n_col_blocks, row0, static_cast<float>(1.0 / step),
                      fill, d_h, extent, vec4 != 0};
  const int64_t blocks = (tasks + warps - 1) / warps;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (method) {
    case xrt::kBilinear:
      err = launch<V, xrt::kBilinear>(a, group, stages, blocks, warps, smem, s);
      break;
    case xrt::kNearest:
      err = launch<V, xrt::kNearest>(a, group, stages, blocks, warps, smem, s);
      break;
    case xrt::kTriangular:
      err = launch<V, xrt::kTriangular>(a, group, stages, blocks, warps, smem, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// K2 and its band form: v holds the band's out_h rows, from global row
// row0 (0 for K2); src_h is the source's true height (the mask's bound).
// cols is the windows' column block, which must be the kernel's segment
// (kBandCols); group, stages and warps are the host's launch plan
// (srw_kernels.plan_band_launch), held here to the kernel's limits.
extern "C" int xrt_srw_horizontal_f32(
    const float* v, const float* vd, const float* ix_c, const float* iy_c,
    const int32_t* base_h, const int32_t* win, float* out, int64_t batch,
    int64_t out_h, int64_t out_w, int64_t src_h, int64_t src_w, int64_t ncj,
    int64_t nci, int step, int64_t row_tile, int d_h, int method, float fill,
    int cols, int extent, int64_t n_col_blocks, int group, int stages, int warps,
    int vec4, int64_t row0, void* stream) {
  return horizontal<float>(v, vd, ix_c, iy_c, base_h, win, out, batch, out_h, out_w, src_h,
                           src_w, ncj, nci, step, row_tile, d_h, method, fill, cols, extent,
                           n_col_blocks, group, stages, warps, vec4, row0, stream);
}

// K2's float64 form and its band form: xrt_srw_horizontal_f32's arguments
// on float64 v, vd, out and fill (the geometry float32).
extern "C" int xrt_srw_horizontal_f64(
    const double* v, const double* vd, const float* ix_c, const float* iy_c,
    const int32_t* base_h, const int32_t* win, double* out, int64_t batch,
    int64_t out_h, int64_t out_w, int64_t src_h, int64_t src_w, int64_t ncj,
    int64_t nci, int step, int64_t row_tile, int d_h, int method, double fill,
    int cols, int extent, int64_t n_col_blocks, int group, int stages, int warps,
    int vec4, int64_t row0, void* stream) {
  return horizontal<double>(v, vd, ix_c, iy_c, base_h, win, out, batch, out_h, out_w, src_h,
                            src_w, ncj, nci, step, row_tile, d_h, method, fill, cols, extent,
                            n_col_blocks, group, stages, warps, vec4, row0, stream);
}
