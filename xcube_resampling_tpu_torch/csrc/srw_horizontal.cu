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
// Design: a block covers `rows` output rows inside one row tile (one set of
// bases) by `cols` output columns.  It stages the row segment of v its taps
// read in shared memory with cp.async, two buffers deep: the next
// (row block, band) window loads while the current one is summed.  The
// window is the host-planned [lo, lo + extent) of tap columns, unclipped
// and 4-aligned: window column q holds v column clamp(lo + q), so the copy
// does the edge clamp (16-byte copies for 4-column groups inside v) and
// the tap loop has none.  The bases and the geometry (positions, mask, s)
// go to shared memory once per row block and serve every band.  Where the
// staged window is all finite, the tap sums take the exact two-tap
// shortcut of srw_common.h.  A warp reads 32 neighbouring output columns,
// whose taps fall on neighbouring or equal columns of the window: few bank
// conflicts.  Writes are coalesced.  The method is a template parameter,
// the tap loop 32-bit; output offsets are 64-bit.  What still holds it
// above its bound is the per-block work between barriers, as for K1
// (tools/tune_srw.py).
//
// The band form (srw_horizontal_band; B = true) is the sharded SRW's
// horizontal pass, xcube_resampling_tpu/parallel/halo.py:450-481: v holds
// one mesh band's rows, output row j lies at global target row row0 + j,
// where its geometry (positions, mask, s) is interpolated, and the bases
// are the band's tiles of base_h.  The tile of row j is j / row_tile, which
// on the band's last, overlapping tile is min(j / row_tile, tiles - 1),
// as halo.py:472-474 takes it.  B is a template parameter: the
// single-chip kernels (B = false) compile as before.
#include "srw_common.h"

namespace {

constexpr int kThreads = 256;

// Copy columns [lo, lo + width) of rows [0, h) of v (row stride ld) into
// s (row stride sw): window column q holds v column clamp(lo + q).  With
// vec4, lo, width and the row length src_w are multiples of 4, so a
// 4-column group lies wholly inside v (one 16-byte copy) or wholly outside
// (four copies of the edge column).
__device__ __forceinline__ void load_cols_async(float* s, int sw,
                                                const float* g, int64_t ld,
                                                int h, int lo, int width,
                                                int64_t src_w, bool vec4) {
  const int per_row = vec4 ? width >> 2 : width;
  for (int e = threadIdx.x; e < h * per_row; e += kThreads) {
    const int r = e / per_row;
    const int q = e - r * per_row;
    const float* row = g + r * ld;
    float* dst = s + r * sw;
    if (vec4) {
      const int c = lo + 4 * q;
      if (c >= 0 && c + 4 <= src_w) {
        xrt::cp_async16(dst + 4 * q, row + c);
      } else {
        for (int t = 0; t < 4; ++t) {
          xrt::cp_async4(dst + 4 * q + t, row + xrt::clamp_index(c + t, src_w));
        }
      }
    } else {
      xrt::cp_async4(dst + q, row + xrt::clamp_index(lo + q, src_w));
    }
  }
}

template <int M, bool B>
__global__ void __launch_bounds__(kThreads) srw_horizontal_kernel(
    const float* __restrict__ v, const float* __restrict__ vd,
    const float* __restrict__ ix_c, const float* __restrict__ iy_c,
    const int32_t* __restrict__ base, const int32_t* __restrict__ win,
    float* __restrict__ out, int64_t batch, int64_t out_h, int64_t out_w,
    int64_t src_h, int64_t src_w, int64_t ncj, int64_t nci, float inv,
    int64_t row_tile, int d_h, float fill, int rows, int cols, int extent,
    int64_t n_col_blocks, bool vec4, int64_t band_row0) {
  constexpr bool kTri = M == xrt::kTriangular;
  const int64_t row0 = B ? band_row0 : 0;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int plane = rows * extent;        // floats of one window
  const int stage = (kTri ? 2 : 1) * plane;  // v (and vd) of one buffer
  float* spos = smem + 2 * stage;         // (rows, cols)
  float* ss = spos + rows * cols;         // (rows, cols), triangular
  int* sbase = reinterpret_cast<int*>(ss + (kTri ? rows * cols : 0));  // (cols,)
  unsigned char* sok = reinterpret_cast<unsigned char*>(sbase + cols);  // (rows, cols)

  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int ncols = static_cast<int>(out_w - i0 < cols ? out_w - i0 : cols);
  const int cx = threadIdx.x % cols;
  const int ry = threadIdx.x / cols;
  const int row_groups = kThreads / cols;
  const int64_t n_rb = (out_h + rows - 1) / rows;
  const int64_t n_mine = blockIdx.y < n_rb
      ? (n_rb - blockIdx.y + gridDim.y - 1) / gridDim.y : 0;
  const int64_t n_items = n_mine * batch;
  // the bounds in float32, as the JAX package compares them
  const float x_hi = static_cast<float>(static_cast<double>(src_w) - 0.5);
  const float y_hi = static_cast<float>(static_cast<double>(src_h) - 0.5);

  auto row_block = [&](int64_t it) { return blockIdx.y + (it / batch) * gridDim.y; };
  auto window = [&](int64_t rb) {
    return win + ((rb * rows / row_tile) * n_col_blocks + blockIdx.x) * 2;
  };
  auto issue = [&](int64_t it) {
    const int64_t rb = row_block(it);
    const int64_t b = it % batch;
    const int64_t j0 = rb * rows;
    const int nrows = static_cast<int>(out_h - j0 < rows ? out_h - j0 : rows);
    const int32_t* w = window(rb);
    const int64_t off = (b * out_h + j0) * src_w;
    float* dst = smem + (it & 1) * stage;
    load_cols_async(dst, extent, v + off, src_w, nrows, w[0], w[1] - w[0], src_w, vec4);
    if (kTri) {
      load_cols_async(dst + plane, extent, vd + off, src_w, nrows, w[0],
                      w[1] - w[0], src_w, vec4);
    }
    xrt::cp_async_commit();
  };

  if (n_items > 0) issue(0);
  for (int64_t it = 0; it < n_items; ++it) {
    const int64_t rb = row_block(it);
    const int64_t b = it % batch;
    const int64_t j0 = rb * rows;
    const int nrows = static_cast<int>(out_h - j0 < rows ? out_h - j0 : rows);
    const bool more = it + 1 < n_items;
    if (more) issue(it + 1);
    if (b == 0) {
      // bases and geometry of this row block, once for every band
      const int64_t tile = j0 / row_tile;
      for (int q = threadIdx.x; q < ncols; q += kThreads) {
        sbase[q] = base[tile * out_w + i0 + q];
      }
      // each thread computes the geometry of the outputs it sums
      const float col = static_cast<float>(i0 + cx);
      xrt::FieldColumn fx(ix_c, ncj, nci, col, inv);
      xrt::FieldColumn fy(iy_c, ncj, nci, col, inv);
      for (int r = ry; r < nrows; r += row_groups) {
        const int e = r * cols + cx;
        const float row = static_cast<float>(row0 + j0 + r);
        const float p = fx.at(row);
        const float iy = fy.at(row);
        spos[e] = p;
        sok[e] = p > -0.5f && p < x_hi && iy > -0.5f && iy < y_hi;
        if (kTri) {
          const float u = p - floorf(p);
          const float vf = iy - floorf(iy);
          ss[e] = fminf(u * vf, (1.0f - u) * (1.0f - vf));
        }
      }
    }
    if (more) {
      xrt::cp_async_wait<1>();
    } else {
      xrt::cp_async_wait<0>();
    }
    __syncthreads();
    const float* sv = smem + (it & 1) * stage;
    const int32_t* w = window(rb);
    const int lo = w[0];
    bool finite = !xrt::window_has_nonfinite(sv, extent, nrows, w[1] - lo);
    if (kTri) finite = !xrt::window_has_nonfinite(sv + plane, extent, nrows, w[1] - lo) && finite;
    if (cx < ncols) {
      const int b0 = sbase[cx];
      const int tap0 = b0 - lo;
      float* ob = out + (b * out_h + j0) * out_w + i0 + cx;
      for (int r = ry; r < nrows; r += row_groups) {
        const int e = r * cols + cx;
        float acc = 0.0f;
        float acc_d = 0.0f;
        xrt::tap_sums<M>(sv + r * extent + tap0, 1, spos[e], b0, d_h, finite, acc,
                         acc_d);
        if (kTri) {
          float acc_dd = 0.0f;  // the (1, -1) taps of vd
          float unused = 0.0f;
          xrt::tap_sums<M>(sv + plane + r * extent + tap0, 1, spos[e], b0, d_h,
                           finite, unused, acc_dd);
          acc = fmaf(-ss[e], acc_dd, acc);
        }
        ob[r * out_w] = sok[e] ? acc : fill;
      }
    }
    __syncthreads();  // the buffer and the geometry are rewritten next
  }
}

template <int M, bool B>
cudaError_t launch(const float* v, const float* vd, const float* ix_c,
                   const float* iy_c, const int32_t* base_h,
                   const int32_t* win, float* out, int64_t batch,
                   int64_t out_h, int64_t out_w, int64_t src_h, int64_t src_w,
                   int64_t ncj, int64_t nci, float inv, int64_t row_tile,
                   int d_h, float fill, int rows, int cols, int extent,
                   int64_t n_col_blocks, dim3 grid, size_t smem, bool vec4,
                   int64_t row0, cudaStream_t stream) {
  const cudaError_t err = xrt::allow_smem(srw_horizontal_kernel<M, B>, smem);
  if (err != cudaSuccess) return err;
  srw_horizontal_kernel<M, B><<<grid, kThreads, smem, stream>>>(
      v, vd, ix_c, iy_c, base_h, win, out, batch, out_h, out_w, src_h, src_w,
      ncj, nci, inv, row_tile, d_h, fill, rows, cols, extent, n_col_blocks,
      vec4, row0);
  return cudaGetLastError();
}

template <bool B>
int dispatch(const float* v, const float* vd, const float* ix_c,
             const float* iy_c, const int32_t* base_h, const int32_t* win,
             float* out, int64_t batch, int64_t out_h, int64_t out_w,
             int64_t src_h, int64_t src_w, int64_t ncj, int64_t nci, int step,
             int64_t row_tile, int d_h, int method, float fill, int rows,
             int cols, int extent, int64_t n_col_blocks, int64_t walkers,
             int vec4, int64_t row0, void* stream) {
  if (cols < 1 || cols > kThreads || kThreads % cols != 0 || extent % 4 != 0 ||
      (method == xrt::kTriangular) != (vd != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t tri = vd != nullptr ? 1 : 0;
  const size_t rc = static_cast<size_t>(rows) * cols;
  const size_t smem = sizeof(float) * (2 * (1 + tri) * rows * static_cast<size_t>(extent) +
                                       (1 + tri) * rc + cols) + rc;
  const float inv = static_cast<float>(1.0 / step);
  const dim3 grid(static_cast<unsigned>(n_col_blocks), static_cast<unsigned>(walkers));
  const auto s = static_cast<cudaStream_t>(stream);
#define XRT_LAUNCH(M)                                                          \
  launch<M, B>(v, vd, ix_c, iy_c, base_h, win, out, batch, out_h, out_w,     \
               src_h, src_w, ncj, nci, inv, row_tile, d_h, fill, rows, cols,  \
               extent, n_col_blocks, grid, smem, vec4 != 0, row0, s)
  cudaError_t err;
  switch (method) {
    case xrt::kBilinear: err = XRT_LAUNCH(xrt::kBilinear); break;
    case xrt::kNearest: err = XRT_LAUNCH(xrt::kNearest); break;
    case xrt::kTriangular: err = XRT_LAUNCH(xrt::kTriangular); break;
    default: err = cudaErrorInvalidValue;
  }
#undef XRT_LAUNCH
  return static_cast<int>(err);
}

}  // namespace

extern "C" int xrt_srw_horizontal_f32(
    const float* v, const float* vd, const float* ix_c, const float* iy_c,
    const int32_t* base_h, const int32_t* win, float* out, int64_t batch,
    int64_t out_h, int64_t out_w, int64_t src_h, int64_t src_w, int64_t ncj,
    int64_t nci, int step, int64_t row_tile, int d_h, int method, float fill,
    int rows, int cols, int extent, int64_t n_col_blocks, int64_t walkers,
    int vec4, void* stream) {
  return dispatch<false>(v, vd, ix_c, iy_c, base_h, win, out, batch, out_h, out_w,
                         src_h, src_w, ncj, nci, step, row_tile, d_h, method, fill,
                         rows, cols, extent, n_col_blocks, walkers, vec4, 0, stream);
}

// The band form: v holds the band's out_h rows, from global row row0;
// src_h is the source's true height (the mask's bound).
extern "C" int xrt_srw_horizontal_band_f32(
    const float* v, const float* vd, const float* ix_c, const float* iy_c,
    const int32_t* base_h, const int32_t* win, float* out, int64_t batch,
    int64_t out_h, int64_t out_w, int64_t src_h, int64_t src_w, int64_t ncj,
    int64_t nci, int step, int64_t row_tile, int d_h, int method, float fill,
    int rows, int cols, int extent, int64_t n_col_blocks, int64_t walkers,
    int vec4, int64_t row0, void* stream) {
  return dispatch<true>(v, vd, ix_c, iy_c, base_h, win, out, batch, out_h, out_w,
                        src_h, src_w, ncj, nci, step, row_tile, d_h, method, fill,
                        rows, cols, extent, n_col_blocks, walkers, vec4, row0, stream);
}
