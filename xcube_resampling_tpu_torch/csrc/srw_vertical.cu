// K1: the SRW vertical tap pass.
//
//   p           = interp_field(iystar_c, j, c)
//   v[b, j, c]  = sum_{d < d_v} w(p, base + d)  * src[b, clamp(base + d), c]
//   vd[b, j, c] = sum_{d < d_v} dw(p, base + d) * src[b, clamp(base + d), c]
//   with base = base_v[j, c / col_tile]; vd only for triangular.
//
// Replaces the Pallas kernel xcube_resampling_tpu/ops/pallas_kernels.py:
// srw_vertical_pallas and the XLA taps of ops/srw.py:make_srw_fn
// (:647-668) with its position precompute (:609-614).  It follows the XLA
// taps' semantics: exactly d_v taps from base, zero-weight taps included,
// so a NaN source row reaches exactly the outputs whose taps read it.
//
// Bound on the H100: device memory.  The work must read the source once
// and write v once (vd too for triangular); the positions come from a
// coarse field of a few MB that stays in L2.  Read naively, each output
// reads d_v source values through L1/L2, d_v times the source per call.
//
// Design, as the Pallas kernel stages a source window in VMEM: a block
// covers `cols` source columns inside one column tile (one base per output
// row) by `rows` output rows, and stages the source rows its taps read in
// shared memory with cp.async (16-byte copies where aligned), so the
// source is read about (rows + d_v) / rows times.  The window is the
// host-planned [lo, lo + extent) of tap rows, unclipped: window row r holds
// source row clamp(lo + r), so the copy does the edge clamp once and the
// tap loop has none.  A block walks several row blocks and every band of
// each; the next (row block, band) window loads while the current one is
// summed (two buffers).  Positions and bases go to shared memory once per
// row block and serve every band.  Where the staged window is all finite,
// the tap sums take the exact two-tap shortcut of srw_common.h.
// Neighbouring threads read neighbouring columns: no bank conflicts.  The
// method is a template parameter, the tap loop 32-bit; output offsets are
// 64-bit.  What still holds it above its bound: not bytes and, after the
// shortcut, not instructions; the block-shape sweep (tools/tune_srw.py)
// finds the fewest, largest blocks fastest, so the per-block work between
// barriers (geometry, window check, the wait on the copy) sets the time.
//
// The band form (srw_vertical_band; B = true) is the sharded SRW's
// vertical pass, xcube_resampling_tpu/parallel/halo.py:423-448: the source
// is one row band of the mesh extended by its halo (ext, ext_h rows, its
// row 0 at global source row `off`, negative on the first band), output
// row j lies at global target row row0 + j (its position interpolated
// there, its base in the band's rows of base_v), and tap k reads ext row
// clamp(k, 0, src_h - 1) - off of the true source height src_h, its weight
// at the true position.  Both the clamp and the offset go into the staging
// copy, so the tap loop is the single-chip one.  B is a template
// parameter: the single-chip kernels (B = false) compile as before.
//
// Data types (T, a template parameter, dispatched from the dtype code):
// float32 sources are staged with cp.async as above.  The other data types
// but float64 are read in place: the staging copy loads each value in its
// own type and converts it to float32 in registers, so the source is never
// copied to float32 first and the sums are K1's float32 sums of the
// converted values, as jnp promotes a float32 weight times an integer,
// bool or half value.  float64 sources stage float64 and sum in float64,
// the float32 weights widened before each product, as jnp promotes
// float32 * float64; v (and vd) are then float64.  The typed copies are
// synchronous loads (cp.async copies 4 or 16 bytes, not 1, 2 or 8 of a
// value in place).  (One kernel for every typed source, the type switched
// inside its staging copy, spilled: a kernel per type does not.)
#include "kernel_types.h"
#include "srw_common.h"

namespace {

constexpr int kThreads = 256;

// The value type of the staged window and of v: float64 for float64
// sources, float32 for the others
template <typename T>
using ValueOf = std::conditional_t<std::is_same<T, double>::value, double, float>;

// The band form's offsets: output row j at global target row row0 + j;
// the plane's row 0 at global source row off; src_h the source's true
// height, to which taps clamp.
struct Band {
  int64_t row0, off, src_h;
};

// Copy window rows [0, h) of one band's column block into s (row stride
// cols): window row r is plane row clamp(lo + r, src_h) - off; `width`
// columns.
__device__ __forceinline__ void load_rows_async(float* s, int cols,
                                                const float* g, int64_t ld,
                                                int lo, int h, int64_t src_h,
                                                int64_t off, int width,
                                                bool vec4) {
  const int per_row = vec4 ? width >> 2 : width;
  for (int e = threadIdx.x; e < h * per_row; e += kThreads) {
    const int r = e / per_row;
    const int q = e - r * per_row;
    const float* row = g + (xrt::clamp_index(lo + r, src_h) - off) * ld;
    if (vec4) {
      xrt::cp_async16(s + r * cols + 4 * q, row + 4 * q);
    } else {
      xrt::cp_async4(s + r * cols + q, row + q);
    }
  }
}

// load_rows_async's window of a source of type T, each value loaded in its
// type and converted in registers to the value type V
template <typename T, typename V>
__device__ __forceinline__ void load_rows_as(V* s, int cols, const T* g, int64_t ld, int lo,
                                             int h, int64_t src_h, int64_t off, int width) {
  // not unrolled: unrolled, the triangular band kernels of the 1-byte
  // types spilled 4-12 bytes
#pragma unroll 1
  for (int e = threadIdx.x; e < h * width; e += kThreads) {
    const int r = e / width;
    const int q = e - r * width;
    const T x = xrt::ldg(g + (xrt::clamp_index(lo + r, src_h) - off) * ld + q);
    if constexpr (sizeof(V) == 8) {
      s[r * cols + q] = xrt::to_f64(x);
    } else {
      s[r * cols + q] = xrt::to_f32(x);
    }
  }
}

// The window of plane element `first` on: cp.async for float32, typed
// loads for the others
template <typename T>
__device__ __forceinline__ void stage_window(ValueOf<T>* s, int cols, const T* src,
                                             int64_t first, int64_t ld, int lo, int h,
                                             int64_t src_h, int64_t off, int width, bool vec4) {
  if constexpr (std::is_same<T, float>::value) {
    load_rows_async(s, cols, src + first, ld, lo, h, src_h, off, width, vec4);
  } else {
    load_rows_as(s, cols, src + first, ld, lo, h, src_h, off, width);
  }
}

// src_h: the rows of a plane of src (the band's ext_h for B)
template <int M, bool B, typename T>
__global__ void __launch_bounds__(kThreads) srw_vertical_kernel(
    const T* __restrict__ src, const float* __restrict__ iystar_c,
    const int32_t* __restrict__ base, const int32_t* __restrict__ win,
    ValueOf<T>* __restrict__ v, ValueOf<T>* __restrict__ vd, int64_t batch,
    int64_t src_h, int64_t src_w, int64_t out_h, int64_t ncj, int64_t ncc,
    float inv, int64_t n_col_tiles, int64_t col_tile, int d_v, int rows,
    int cols, int extent, bool vec4, Band band) {
  using V = ValueOf<T>;
  extern __shared__ float4 smem4[];
  const int64_t row0 = B ? band.row0 : 0;
  const int64_t clamp_h = B ? band.src_h : src_h;
  const int64_t off = B ? band.off : 0;
  V* smem = reinterpret_cast<V*>(smem4);
  const int stage = extent * cols;  // values per window buffer
  float* spos = reinterpret_cast<float*>(smem + 2 * stage);  // (rows, cols) positions
  int* sbase = reinterpret_cast<int*>(spos + rows * cols);  // (rows,)

  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int width = static_cast<int>(src_w - c0 < cols ? src_w - c0 : cols);
  const int64_t tile = c0 / col_tile;
  const int cx = threadIdx.x % cols;
  const int ry = threadIdx.x / cols;
  const int row_groups = kThreads / cols;
  const int64_t n_rb = (out_h + rows - 1) / rows;
  // this block's items: row blocks blockIdx.y, + gridDim.y, ..., each band
  const int64_t n_mine = blockIdx.y < n_rb
      ? (n_rb - blockIdx.y + gridDim.y - 1) / gridDim.y : 0;
  const int64_t n_items = n_mine * batch;

  auto row_block = [&](int64_t it) { return blockIdx.y + (it / batch) * gridDim.y; };
  auto issue = [&](int64_t it) {
    const int64_t b = it % batch;
    const int32_t* w = win + (row_block(it) * n_col_tiles + tile) * 2;
    stage_window<T>(smem + (it & 1) * stage, cols, src, b * src_h * src_w + c0, src_w, w[0],
                    w[1] - w[0], clamp_h, off, width, vec4);
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
      // positions and bases of this row block, once for every band; each
      // thread computes the positions it sums
      xrt::FieldColumn field(iystar_c, ncj, ncc, static_cast<float>(c0 + cx), inv);
      for (int r = ry; r < nrows; r += row_groups) {
        spos[r * cols + cx] = field.at(static_cast<float>(row0 + j0 + r));
      }
      for (int r = threadIdx.x; r < nrows; r += kThreads) {
        sbase[r] = base[(j0 + r) * n_col_tiles + tile];
      }
    }
    if (more) {
      xrt::cp_async_wait<1>();
    } else {
      xrt::cp_async_wait<0>();
    }
    __syncthreads();
    const V* st = smem + (it & 1) * stage;
    const int32_t* w = win + (rb * n_col_tiles + tile) * 2;
    const int lo = w[0];
    const bool finite = !xrt::window_has_nonfinite(st, cols, w[1] - lo, width);
    if (cx < width) {
      V* vb = v + (b * out_h + j0) * src_w + c0 + cx;
      V* vdb = M == xrt::kTriangular ? vd + (b * out_h + j0) * src_w + c0 + cx : nullptr;
      for (int r = ry; r < nrows; r += row_groups) {
        const int b0 = sbase[r];
        V acc = V(0);
        V acc_d = V(0);
        xrt::tap_sums<M, V>(st + (b0 - lo) * cols + cx, cols, spos[r * cols + cx], b0, d_v,
                            finite, acc, acc_d);
        vb[r * src_w] = acc;
        if (M == xrt::kTriangular) vdb[r * src_w] = acc_d;
      }
    }
    __syncthreads();  // the buffer and the geometry are rewritten next
  }
}

template <int M, bool B, typename T>
cudaError_t launch(const void* src, const float* iystar_c,
                   const int32_t* base_v, const int32_t* win, void* v,
                   void* vd, int64_t batch, int64_t src_h, int64_t src_w,
                   int64_t out_h, int64_t ncj, int64_t ncc, float inv,
                   int64_t n_col_tiles, int64_t col_tile, int d_v, int rows,
                   int cols, int extent, dim3 grid, size_t smem, bool vec4,
                   Band band, cudaStream_t stream) {
  using V = ValueOf<T>;
  const cudaError_t err = xrt::allow_smem(srw_vertical_kernel<M, B, T>, smem);
  if (err != cudaSuccess) return err;
  srw_vertical_kernel<M, B, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(src), iystar_c, base_v, win, static_cast<V*>(v),
      static_cast<V*>(vd), batch, src_h, src_w, out_h, ncj, ncc, inv, n_col_tiles, col_tile,
      d_v, rows, cols, extent, vec4, band);
  return cudaGetLastError();
}

template <bool B>
int dispatch(const void* src, const float* iystar_c, const int32_t* base_v,
             const int32_t* win, void* v, void* vd, int64_t batch,
             int64_t src_h, int64_t src_w, int64_t out_h, int64_t ncj,
             int64_t ncc, int step, int64_t n_col_tiles, int64_t col_tile,
             int d_v, int method, int rows, int cols, int extent,
             int64_t n_col_blocks, int64_t walkers, int vec4, Band band,
             int code, void* stream) {
  if (cols < 1 || cols > kThreads || kThreads % cols != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float inv = static_cast<float>(1.0 / step);
  const dim3 grid(static_cast<unsigned>(n_col_blocks), static_cast<unsigned>(walkers));
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(xrt::with_data_type(code, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    const size_t smem = sizeof(ValueOf<T>) * 2 * static_cast<size_t>(extent) * cols +
                        sizeof(float) * (static_cast<size_t>(rows) * cols + rows);
    const bool v4 = vec4 != 0 && std::is_same<T, float>::value;
#define XRT_LAUNCH(M)                                                                \
  launch<M, B, T>(src, iystar_c, base_v, win, v, vd, batch, src_h, src_w, out_h, ncj, \
                  ncc, inv, n_col_tiles, col_tile, d_v, rows, cols, extent, grid,    \
                  smem, v4, band, s)
    switch (method) {
      case xrt::kBilinear: return XRT_LAUNCH(xrt::kBilinear);
      case xrt::kNearest: return XRT_LAUNCH(xrt::kNearest);
      case xrt::kTriangular: return XRT_LAUNCH(xrt::kTriangular);
      default: return cudaErrorInvalidValue;
    }
#undef XRT_LAUNCH
  }));
}

}  // namespace

// K1: src (batch, src_h, src_w) of data type `code` (csrc/kernel_types.h);
// v and vd float32, float64 for float64 sources.
extern "C" int xrt_srw_vertical(
    const void* src, const float* iystar_c, const int32_t* base_v,
    const int32_t* win, void* v, void* vd, int64_t batch, int64_t src_h,
    int64_t src_w, int64_t out_h, int64_t ncj, int64_t ncc, int step,
    int64_t n_col_tiles, int64_t col_tile, int d_v, int method, int rows,
    int cols, int extent, int64_t n_col_blocks, int64_t walkers, int vec4,
    int code, void* stream) {
  return dispatch<false>(src, iystar_c, base_v, win, v, vd, batch, src_h, src_w,
                         out_h, ncj, ncc, step, n_col_tiles, col_tile, d_v,
                         method, rows, cols, extent, n_col_blocks, walkers, vec4,
                         Band{0, 0, src_h}, code, stream);
}

// The band form: src is the band's ext (batch, ext_h, src_w); out_h its
// output rows, from global row row0; off the global row of ext's row 0;
// src_h the source's true height.
extern "C" int xrt_srw_vertical_band(
    const void* ext, const float* iystar_c, const int32_t* base_v,
    const int32_t* win, void* v, void* vd, int64_t batch, int64_t ext_h,
    int64_t src_w, int64_t out_h, int64_t ncj, int64_t ncc, int step,
    int64_t n_col_tiles, int64_t col_tile, int d_v, int method, int rows,
    int cols, int extent, int64_t n_col_blocks, int64_t walkers, int vec4,
    int64_t row0, int64_t off, int64_t src_h, int code, void* stream) {
  return dispatch<true>(ext, iystar_c, base_v, win, v, vd, batch, ext_h, src_w,
                        out_h, ncj, ncc, step, n_col_tiles, col_tile, d_v,
                        method, rows, cols, extent, n_col_blocks, walkers, vec4,
                        Band{row0, off, src_h}, code, stream);
}

extern "C" const char* xrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
