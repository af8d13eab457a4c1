// K3 and its band form on the data types other than float32: the fused
// direct gather of fused_reproject.cu with gather_interp's per-dtype
// semantics (xcube_resampling_tpu/ops/reproject_ops.py:108-147), as jnp
// computes them:
//   nearest keeps the source type (the tap copied, the fill cast to it);
//   bilinear and triangular take the tap differences in the source type
//   (integers wrap, float16 and bfloat16 round) and lerp them as fused
//   multiply-adds in float32, or in float64 for float64 sources, whose
//   output is float64; bool bilinear raises in jnp (boolean subtract), and
//   the wrapper refuses it before the launch.
// The taps, positions, mask and clamps are K3's (gather_taps.h, the
// FieldCols of srw_common.h), so only the value type differs.
//
// Bound on the H100: device memory, as K3.  Design, the simplest that is
// right: a thread a target column, walking the rows of a grid stride (the
// field's row lerps kept while the rows stay in one coarse cell), each
// pixel's taps taken once for every band, the taps read through the
// read-only path.  Nearest depends on the value's width only: the kernels
// copy 1-, 2-, 4- or 8-byte words, so every data type's nearest shares four
// instantiations a form.  The band form's mask, clamp and rebase are K3's
// band form's (fused_reproject.cu).
#include "affine_gather.h"
#include "gather_taps.h"

namespace {

constexpr int kThreads = 128;

struct Args {
  const void* src;
  void* out;
  xrt::CoarseFields<2> field;  // ix_c, iy_c
  int64_t batch;
  xrt::TapBounds tb;  // the source plane's (the band's ext for the band form)
  int out_h, out_w;
  double fill;
  int64_t fill_bits;  // an integer fill's bits
  // the band form's: the global target row of output row 0, the true
  // source's bounds and the band's row offset
  int row0;
  xrt::TapBounds global;
  float off;
};

// The words nearest copies, by the data type's width
template <typename T>
using WordOf = std::conditional_t<
    sizeof(T) == 1, uint8_t,
    std::conditional_t<sizeof(T) == 2, uint16_t,
                       std::conditional_t<sizeof(T) == 4, uint32_t, uint64_t>>>;

template <int M, bool B>
__device__ __forceinline__ xrt::Taps pixel_taps(float ix, float iy, const Args& a) {
  if constexpr (!B) {
    return xrt::taps<M>(ix, iy, a.tb);
  } else {
    const xrt::TapBounds& g = a.global;
    const bool in_src = ix > -0.5f && ix < g.x_hi && iy > -0.5f && iy < g.y_hi;
    xrt::Taps t = xrt::taps<M>(ix, fminf(fmaxf(iy, 0.0f), g.y_max) - a.off, a.tb);
    t.ok = in_src && t.ok;
    return t;
  }
}

// T: the data type (for nearest, the word of its width); O its output type
template <int M, typename T, bool B>
__global__ void __launch_bounds__(kThreads) fused_reproject_typed_kernel(const Args a) {
  using O = xrt::GatherOut<M, T>;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.out_w) return;
  const int64_t src_plane = static_cast<int64_t>(a.tb.src_h) * a.tb.src_w;
  const int64_t out_plane = static_cast<int64_t>(a.out_h) * a.out_w;
  O fill;
  if constexpr (std::is_integral<O>::value) {
    fill = static_cast<O>(a.fill_bits);
  } else {
    fill = xrt::round_from<O>(a.fill);
  }
  const T* __restrict__ src = static_cast<const T*>(a.src);
  O* __restrict__ out = static_cast<O*>(a.out);
  xrt::FieldCols<2, 1> field(a.field, static_cast<float>(i));
  for (int j = blockIdx.y; j < a.out_h; j += gridDim.y) {
    float f[2][1];  // ix, iy
    field.at(a.field, static_cast<float>(B ? a.row0 + j : j), f);
    const xrt::Taps t = pixel_taps<M, B>(f[0][0], f[1][0], a);
    for (int64_t b = 0; b < a.batch; ++b) {
      out[b * out_plane + static_cast<int64_t>(j) * a.out_w + i] =
          t.ok ? xrt::gather_t<M, T>(src + b * src_plane, t) : fill;
    }
  }
}

template <int M, typename T, bool B>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const auto kernel = fused_reproject_typed_kernel<M, T, B>;
  const int64_t cols = (a.out_w + kThreads - 1) / kThreads;
  unsigned rows = 1;
  const cudaError_t e = xrt::wave_rows(kernel, kThreads, 0, cols, a.out_h, &rows);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(static_cast<unsigned>(cols), rows), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool B>
cudaError_t dispatch(const Args& a, int method, int code, cudaStream_t s) {
  return xrt::with_data_type(code, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    if constexpr (std::is_same<T, float>::value) {
      return cudaErrorInvalidValue;  // fused_reproject.cu's kernels
    } else {
      switch (method) {
        case xrt::kNearest: return launch<xrt::kNearest, WordOf<T>, B>(a, s);
        case xrt::kBilinear:
        case xrt::kTriangular:
          if constexpr (std::is_same<T, bool>::value) {
            return cudaErrorInvalidValue;  // jnp's boolean subtract raises
          } else {
            return method == xrt::kBilinear ? launch<xrt::kBilinear, T, B>(a, s)
                                            : launch<xrt::kTriangular, T, B>(a, s);
          }
        default: return cudaErrorInvalidValue;
      }
    }
  });
}

}  // namespace

// K3 (row0 = off = 0, src_h the source's) and its band form on a source of
// data type `code` but float32: src (batch, src_h, src_w); out (batch,
// out_h, out_w) of gather_interp's output type (the source's for nearest,
// float64 for float64, else float32); fill the fill in that type, fill_bits
// an integer fill's bits; the band form's ext holds the global rows from
// off of a source true_h rows high.
extern "C" int xrt_fused_reproject_typed(
    const void* src, const float* ix_c, const float* iy_c, void* out, int64_t batch,
    int64_t src_h, int64_t src_w, int64_t ncj, int64_t nci, int64_t out_h, int64_t out_w,
    int step, int method, double fill, int64_t fill_bits, int64_t row0, int64_t off,
    int64_t true_h, int band, int code, void* stream) {
  constexpr int64_t kMaxPlane = (int64_t{1} << 31) - 1;
  if (src_h * src_w > kMaxPlane || out_h * out_w > kMaxPlane || ncj * nci > kMaxPlane ||
      step < 1 || batch < 1 || row0 < 0 || row0 + out_h > kMaxPlane || ncj < 2 || nci < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{src, out,
               {{ix_c, iy_c}, static_cast<int>(ncj), static_cast<int>(nci),
                static_cast<float>(1.0 / step)},
               batch, xrt::tap_bounds(src_h, src_w), static_cast<int>(out_h),
               static_cast<int>(out_w), fill, fill_bits, static_cast<int>(row0),
               xrt::tap_bounds(true_h, src_w), static_cast<float>(off)};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(band ? dispatch<true>(a, method, code, s)
                               : dispatch<false>(a, method, code, s));
}
