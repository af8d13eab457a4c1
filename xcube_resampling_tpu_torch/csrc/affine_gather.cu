// K4: the separable affine gather.
//
// For each output pixel (b, j, i) the source plane b is sampled at
//   y = j * j_scale + j_off,  x = i * i_scale + i_off   (float64)
// by nearest or bilinear taps with the arithmetic of affine_gather.h;
// outside: the fill (cast by the wrapper to the source type for nearest,
// to its float type for bilinear).  The bilinear result is rounded once on
// store: to the source type (rint and saturation for integers) or kept in
// float64 (the two-pass NaN recovery divides it).
//
// Replaces the XLA device path of xcube_resampling_tpu/ops/gather.py:
// affine_gather and grid_gather_separable's separable branches (:29-143),
// which run eagerly under x64: positions and lerps in float64.  Hopper
// runs float64 natively (half its float32 rate), so the kernel keeps that
// arithmetic and agrees with it bit for bit.  These are not K3's edge
// conventions (K3 selects the fill outside the open interval
// (-0.5, n - 0.5)), so nothing of srw_common.h is shared.  The downscale
// runs K4's fused form (affine_gather_reduce.cu) where it can.
//
// Bound on the H100: device memory.  The work must read the source pixels
// its taps reach once and write every output once; a pixel takes about 20
// float64 operations.  What held the first version above its bound was
// per-pixel arithmetic (positions, floors and float64 -> int64 clips
// recomputed for every pixel, 64-bit offsets) and a grid of one block per
// 64 x 16 outputs.  Design: a block owns a tile of kTileCols columns,
// whose column table (tap, fractions, validity) it computes once in shared
// memory, and walks row tiles of kTileRows rows (one row table each; 8 was
// the fastest of 2 to 16 at the main path's shapes, by
// tools/tune_affine_gather.py) over every band, on a grid sized to the SMs
// (one wave).  A thread owns kVec adjacent columns of a row: it loads the
// source columns its taps reach together, lerps each once (bilinear_row),
// and stores the kVec results as one vector where out_w % kVec == 0.
// Offsets inside a plane are 32-bit where every source offset of the plane
// is below 2^31, 64-bit otherwise.
#include "affine_gather.h"

namespace {

using namespace xrt;

constexpr int kThreads = 128;                // threads of a block
constexpr int kVec = 4;                      // adjacent output columns of a thread
constexpr int kTileCols = kThreads * kVec;   // output columns of a block
constexpr int kTileRows = 8;                 // output rows of a row tile

struct Args {
  const void* src;
  void* out;
  int64_t batch, src_h, src_w, pitch_b, pitch_h, out_h, out_w, n_row_tiles;
  double j_scale, i_scale, j_off, i_off, fill;
  int64_t fill_bits;  // an integer fill's bits (nearest), exact past 2^53
  bool vec;  // out_w % kVec == 0: every thread's columns take one vector store
};

template <typename O>
struct alignas(sizeof(O) * kVec) Pack {
  O v[kVec];
};

// The kVec bilinear outputs of a thread in one row whose taps read the
// source rows p0 and p1.  Where the outputs' tap columns span at most
// kVec + 1 source columns (scales up to 1), the row lerps at those columns
// are taken once, their loads issued together, and each output picks its
// two; else each output lerps its own two columns.
template <typename T, typename O, typename I>
__device__ __forceinline__ void bilinear_row(O (&res)[kVec], const T* p0, const T* p1,
                                             double fy, double gy, const I* x0s,
                                             const double* fxs, const double* gxs,
                                             I last_col, O fill) {
  auto lerp = [&](I x) { return row_lerp(p0[x], p1[x], fy, gy); };
  I x0[kVec];
  I lo = last_col + 1, hi = -1;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    x0[v] = x0s[v];
    if (x0[v] >= 0) {
      lo = imin(lo, x0[v]);
      hi = x0[v] > hi ? x0[v] : hi;
    }
  }
  if (hi < 0) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) res[v] = fill;
    return;
  }
  if (hi + 1 - lo <= kVec) {
    double c[kVec + 1];
#pragma unroll
    for (int k = 0; k <= kVec; ++k) c[k] = lerp(imin(lo + static_cast<I>(k), last_col));
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (x0[v] < 0) {
        res[v] = fill;
        continue;
      }
      const int d0 = static_cast<int>(x0[v] - lo);
      const int d1 = static_cast<int>(imin(x0[v] + 1, last_col) - lo);
      double c0 = c[0], c1 = c[0];
#pragma unroll
      for (int k = 1; k <= kVec; ++k) {
        c0 = d0 == k ? c[k] : c0;
        c1 = d1 == k ? c[k] : c1;
      }
      res[v] = round_from<O>(c0 * gxs[v] + c1 * fxs[v]);
    }
    return;
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    res[v] = x0[v] < 0 ? fill
                       : round_from<O>(lerp(x0[v]) * gxs[v] +
                                       lerp(imin(x0[v] + 1, last_col)) * fxs[v]);
  }
}

template <typename T, typename O, int ORDER, typename I>
__global__ void __launch_bounds__(kThreads) affine_gather_kernel(const Args a) {
  __shared__ I col_x0[kTileCols];  // -1 where the column lies outside
  __shared__ double col_f[kTileCols], col_g[kTileCols];
  __shared__ I row_r0[kTileRows], row_r1[kTileRows];  // -1 where the row lies outside
  __shared__ double row_f[kTileRows], row_g[kTileRows];

  const int tid = threadIdx.x;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTileCols;
  for (int e = tid; e < kTileCols; e += kThreads) {
    I x0 = -1;
    double f = 0.0, g = 0.0;
    if (col0 + e < a.out_w) {
      const Axis<I> ax = ORDER == 0 ? nearest_axis<I>(col0 + e, a.i_scale, a.i_off, a.src_w)
                                    : bilinear_axis<I>(col0 + e, a.i_scale, a.i_off, a.src_w);
      if (ax.ok) x0 = ax.t0;
      f = ax.f;
      g = ax.g;
    }
    col_x0[e] = x0;
    col_f[e] = f;
    col_g[e] = g;
  }

  const T* __restrict__ src = static_cast<const T*>(a.src);
  O* __restrict__ out = static_cast<O*>(a.out);
  const O fill = ORDER == 0 && std::is_integral<O>::value ? static_cast<O>(a.fill_bits)
                                                          : round_from<O>(a.fill);
  const I last_col = static_cast<I>(a.src_w - 1);
  const I pitch = static_cast<I>(a.pitch_h);
  const int c0 = tid * kVec;  // the thread's first column in the tile
  const int64_t i0 = col0 + c0;
  const int64_t n_items = a.batch * a.n_row_tiles;
  for (int64_t item = blockIdx.y; item < n_items; item += gridDim.y) {
    const int64_t b = item / a.n_row_tiles;
    const int64_t j0 = (item - b * a.n_row_tiles) * kTileRows;
    __syncthreads();  // the column table is built, the last row table read
    if (tid < kTileRows) {
      I r0 = -1, r1 = -1;
      double f = 0.0, g = 0.0;
      if (j0 + tid < a.out_h) {
        const Axis<I> ax = ORDER == 0 ? nearest_axis<I>(j0 + tid, a.j_scale, a.j_off, a.src_h)
                                      : bilinear_axis<I>(j0 + tid, a.j_scale, a.j_off, a.src_h);
        if (ax.ok) {
          r0 = ax.t0 * pitch;
          r1 = imin(ax.t0 + 1, static_cast<I>(a.src_h - 1)) * pitch;
        }
        f = ax.f;
        g = ax.g;
      }
      row_r0[tid] = r0;
      row_r1[tid] = r1;
      row_f[tid] = f;
      row_g[tid] = g;
    }
    __syncthreads();
    if (i0 >= a.out_w) continue;
    const T* p = src + b * a.pitch_b;
    O* o = out + (b * a.out_h + j0) * a.out_w + i0;
    const int rows = static_cast<int>(a.out_h - j0 < kTileRows ? a.out_h - j0 : kTileRows);
    for (int rr = 0; rr < rows; ++rr, o += a.out_w) {
      const I r0 = row_r0[rr];
      Pack<O> res;
      if (r0 < 0) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) res.v[v] = fill;
      } else if constexpr (ORDER == 0) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const I x0 = col_x0[c0 + v];
          res.v[v] = x0 < 0 ? fill : static_cast<O>(p[r0 + x0]);
        }
      } else {
        bilinear_row(res.v, p + r0, p + row_r1[rr], row_f[rr], row_g[rr], col_x0 + c0,
                     col_f + c0, col_g + c0, last_col, fill);
      }
      if (a.vec) {
        *reinterpret_cast<Pack<O>*>(o) = res;
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          if (i0 + v < a.out_w) o[v] = res.v[v];
      }
    }
  }
}

template <typename T, typename O, int ORDER, typename I>
cudaError_t launch_as(const Args& a, cudaStream_t s) {
  const auto kernel = affine_gather_kernel<T, O, ORDER, I>;
  const int64_t tiles = (a.out_w + kTileCols - 1) / kTileCols;
  unsigned rows = 1;
  const cudaError_t e = wave_rows(kernel, kThreads, 0, tiles, a.batch * a.n_row_tiles, &rows);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(static_cast<unsigned>(tiles), rows), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, typename O, int ORDER>
cudaError_t launch(const Args& a, bool wide, cudaStream_t s) {
  return wide ? launch_as<T, O, ORDER, int64_t>(a, s) : launch_as<T, O, ORDER, int32_t>(a, s);
}

}  // namespace

// order 0 (nearest, out_code == in_code) or 1 (bilinear, out_code the
// source's or float64); pitches in elements; fill the fill in the source's
// type (nearest) or float type (bilinear), fill_bits the bits of an integer
// nearest fill; returns cudaGetLastError().
extern "C" int xrt_affine_gather(
    const void* src, void* out, int64_t batch, int64_t src_h, int64_t src_w,
    int64_t pitch_b, int64_t pitch_h, int64_t out_h, int64_t out_w,
    double j_scale, double i_scale, double j_off, double i_off, int order,
    double fill, int64_t fill_bits, int in_code, int out_code, void* stream) {
  if (batch < 1 || src_h < 1 || src_w < 1 || out_h < 1 || out_w < 1 ||
      pitch_b < 0 || pitch_h < 0 || (order != 0 && order != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{src, out, batch, src_h, src_w, pitch_b, pitch_h, out_h, out_w,
               (out_h + kTileRows - 1) / kTileRows, j_scale, i_scale, j_off, i_off,
               fill, fill_bits, out_w % kVec == 0};
  // 32-bit offsets where every offset into a source plane fits
  const bool wide = (src_h - 1) * pitch_h + src_w >= (int64_t{1} << 31);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_data_type(in_code, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    if (out_code == code_of<T>()) {
      return order == 0 ? launch<T, T, 0>(a, wide, s) : launch<T, T, 1>(a, wide, s);
    }
    if (out_code == kF64 && order == 1) return launch<T, double, 1>(a, wide, s);
    return cudaErrorInvalidValue;
  }));
}
