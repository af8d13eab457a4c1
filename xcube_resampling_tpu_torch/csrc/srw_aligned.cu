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
// w the hat max(0, 1 - |p - k|) (bilinear) or rint(p) == k (nearest),
// zero-weight taps included so that 0 * NaN reaches the output as in the
// XLA path, and valid the tiled SRW's test on the unshifted ix and iy
// (srw.py:931-945, :1408-1413).
//
// Rounding: XLA's CPU backend drops the sum's initial zero and contracts
// the first two products as fma(w0, t0, w1 * t1), the product w1 * t1
// rounded on its own; every later tap is fma(w_d, t_d, acc).  tap_sum
// keeps that order (not K1's fma(w1, t1, w0 * t0), which misses the JAX
// package on some hundreds of pixels a 512^2 flagship by one ulp), and the
// library is built with -fmad=false, so nothing else is contracted.
//
// Design: the simple one.  A thread owns one output column and walks rows
// (grid.y row strides); per row it interpolates its position once, reads
// its tile's base and sums every band's taps.  A template argument drops
// the tile arithmetic where a pass has one tile (K14, K15, and a hybrid
// plan of one tile), and the register caps differ: at the flagship on an
// H100, K14 and K15 ran 12-24% slower with the tiled code at 64 registers
// and 4-29% slower without it at 54-72 than at 32.  Neighbouring threads read
// neighbouring columns (K14: the same source row but where s_v steps;
// K15: neighbouring v columns), so reads coalesce, and the bases of one
// warp share one or two tiles; the source stays in L2 at the flagship's
// sizes.  Offsets inside a plane are 32-bit (the wrappers refuse planes
// of 2^31 elements or more), band offsets 64-bit.
#include "srw_common.h"

namespace {

constexpr int kThreads = 128;
// blocks an SM that __launch_bounds__ asks for: with one tile 16, so 32
// registers a thread and every warp slot filled; tiled 8, up to 64
// registers (at 32 the tiled vertical pass spilled 4 bytes)
constexpr int kOneTileMinBlocks = 16;
constexpr int kTiledMinBlocks = 8;
constexpr int kMaxGridY = 65535;

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

__device__ __forceinline__ int clamp_int(int i, int n) { return i < 0 ? 0 : (i > n - 1 ? n - 1 : i); }

template <int M, bool kTiled>
__global__ void __launch_bounds__(kThreads, kTiled ? kTiledMinBlocks : kOneTileMinBlocks)
    srw_aligned_vertical_kernel(const float* __restrict__ src, const float* __restrict__ iystar_c,
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

template <int M, bool kTiled>
__global__ void __launch_bounds__(kThreads, kTiled ? kTiledMinBlocks : kOneTileMinBlocks)
    srw_aligned_horizontal_kernel(const float* __restrict__ v, const float* __restrict__ ix_c,
                                  const float* __restrict__ iy_c,
                                  const int32_t* __restrict__ s_h,
                                  const int32_t* __restrict__ base_h, float* __restrict__ out,
                                  int batch, int out_h, int src_w, int out_w, int src_h, int ncj,
                                  int nci, float inv, int row_tile, int d_h, float fill) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= out_w) return;
  const int k_one = kTiled ? 0 : base_h[c];  // the base of one row tile
  const xrt::CoarseFields<2> g{{ix_c, iy_c}, ncj, nci, inv};
  xrt::FieldCols<2, 1> fields(g, static_cast<float>(c));
  const float x_hi = static_cast<float>(src_w) - 0.5f;
  const float y_hi = static_cast<float>(src_h) - 0.5f;
  const int64_t v_plane = static_cast<int64_t>(out_h) * src_w;
  const int64_t out_plane = static_cast<int64_t>(out_h) * out_w;
  for (int r = blockIdx.y; r < out_h; r += gridDim.y) {
    float f[2][1];
    fields.at(g, static_cast<float>(r), f);
    const float ix = f[0][0];
    const float iy = f[1][0];
    const bool valid = ix > -0.5f && ix < x_hi && iy > -0.5f && iy < y_hi;
    const int k0 = kTiled ? base_h[(r / row_tile) * out_w + c] : k_one;
    const int sh = s_h[r];
    const float q = ix - static_cast<float>(sh);
    const int lo = k0 + sh;  // tap d reads v column clamp(lo + d)
    for (int b = 0; b < batch; ++b) {
      const float* row = v + b * v_plane + r * src_w;
      out[b * out_plane + r * out_w + c] =
          valid ? tap_sum<M>(q, k0, d_h, [&](int d) { return row[clamp_int(lo + d, src_w)]; })
                : fill;
    }
  }
}

dim3 grid_for(int64_t cols, int64_t rows) {
  return dim3(static_cast<unsigned>((cols + kThreads - 1) / kThreads),
              static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
}

}  // namespace

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
    srw_aligned_vertical_kernel<xrt::kBilinear, true><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else if (method == xrt::kBilinear) {
    srw_aligned_vertical_kernel<xrt::kBilinear, false><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else if (method == xrt::kNearest && tiled) {
    srw_aligned_vertical_kernel<xrt::kNearest, true><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else if (method == xrt::kNearest) {
    srw_aligned_vertical_kernel<xrt::kNearest, false><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XRT_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xrt_srw_aligned_horizontal_f32(const float* v, const float* ix_c,
                                              const float* iy_c, const int32_t* s_h,
                                              const int32_t* base_h, float* out, int64_t batch,
                                              int64_t out_h, int64_t src_w, int64_t out_w,
                                              int64_t src_h, int64_t ncj, int64_t nci, int step,
                                              int64_t row_tile, int d_h, int method, float fill,
                                              void* stream) {
  const float inv = static_cast<float>(1.0 / step);
  const dim3 grid = grid_for(out_w, out_h);
  const auto s = static_cast<cudaStream_t>(stream);
#define XRT_ARGS                                                                          \
  v, ix_c, iy_c, s_h, base_h, out, static_cast<int>(batch), static_cast<int>(out_h),       \
      static_cast<int>(src_w), static_cast<int>(out_w), static_cast<int>(src_h),           \
      static_cast<int>(ncj), static_cast<int>(nci), inv, static_cast<int>(row_tile), d_h,  \
      fill
  const bool tiled = row_tile < out_h;
  if (method == xrt::kBilinear && tiled) {
    srw_aligned_horizontal_kernel<xrt::kBilinear, true><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else if (method == xrt::kBilinear) {
    srw_aligned_horizontal_kernel<xrt::kBilinear, false><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else if (method == xrt::kNearest && tiled) {
    srw_aligned_horizontal_kernel<xrt::kNearest, true><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else if (method == xrt::kNearest) {
    srw_aligned_horizontal_kernel<xrt::kNearest, false><<<grid, kThreads, 0, s>>>(XRT_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XRT_ARGS
  return static_cast<int>(cudaGetLastError());
}
