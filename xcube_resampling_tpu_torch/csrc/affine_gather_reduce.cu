// K4's downscale form: the bilinear affine gather reduced in windows.
//
// Every output pixel (b, oj, oi) is the window reduction (coarsen_reduce.h,
// the reducers of K5) of the j_div x i_div pixels (oj * j_div + r,
// oi * i_div + q) of the inflated image that K4 would gather bilinearly
// (affine_gather.h) at the residual scales (at most 1 in magnitude): each
// inflated pixel is rounded to the source type exactly as K4 stores it
// (round_from<T>, the fill outside) and handed to the reducer in row-major
// window order.  The result equals K4 -> K5 bit for bit, without the
// inflated image.
//
// Replaces the XLA device path of xcube_resampling_tpu/affine.py:
// _resample_array's downscale branch (:212-222): gather.affine_gather at
// the inflated size (xcube_resampling_tpu/ops/gather.py:29-143), then
// coarsen_jax (xcube_resampling_tpu/ops/coarsen_ops.py:36-87).
//
// Bound on the H100: device memory.  The work must read the source once
// and write the coarse image once (at the 20480^2 -> 5050^2 pre-downscale
// 1.78 GB, 0.53 ms).  Per inflated pixel it must round a float64 column
// lerp to the source type and widen it back for the reducer, two
// conversions that sm_90 runs at 16 a clock an SM (at the pre-downscale
// 0.31 ms alone), besides the float64 lerps.
//
// Design (the cached kernel, windows of 1 .. kMaxWidth columns; a template
// on the width): a thread owns one output column and walks the output rows
// of every band (a grid-stride loop, the grid one wave on the SMs), with no
// block barrier.  Its window's columns are the same in every row, so it
// keeps in registers each tap's column (relative to the first source
// column its taps reach), fraction and validity, and the ID + 1 source
// columns it loads (clamped to the source, so that no load is skipped).
// For each window row (the reducer's row(r)) it loads the row's two source
// rows at those columns together, lerps each column once and keeps the
// lerps in pairs (a column's lerp and the next's) in its slice of shared
// memory; each tap (the reducer's tap(q), all unrolled) is then one pair
// and one column lerp, rounded to T.  std and var take the window twice
// (their centred pass).  Keeping a window row's source rows for the next
// (about half the loads and conversions at the pre-downscale) was slower
// on an H100: its choices split the two rows' loads apart (2.585 ms
// against 2.268 there, tools/tune_affine_gather.py).  A positional pick, which needs one tap a window, windows
// wider than kMaxWidth and windows whose taps step over a source column
// (possible only where a scale's rounding moves a position across one,
// ops/gather.py plan_gather_reduce checks) take the direct kernel: the taps
// computed as the reducer asks for them.  Offsets are 64-bit.
//
// A design that staged each block's source rows in shared memory (16-byte
// cp.async copies, each value widened once, the taps' row lerps shared by
// the block) ran slower than this one on an H100: its phases, each a chain
// of dependent steps between block barriers, left 4 blocks of 4 warps an
// SM waiting (PERF.md; tools/tune_affine_gather.py).
#include <climits>

#include "affine_gather.h"
#include "coarsen_reduce.h"

namespace {

using namespace xrt;

constexpr int kThreads = 128;
// the widest window the cached kernel takes (a template on the width)
constexpr int kMaxWidth = 8;
// the taps rounded to T (0: not rounded, a ceiling for tools/, wrong
// output)
constexpr int kRound = 1;

struct Args {
  const void* src;
  void* out;
  int64_t src_h, src_w, pitch_b, pitch_h, oh, ow, jd, id, pa, pb, n_rows;
  double j_scale, i_scale, j_off, i_off, fill;
};

// One thread's window columns: tap q's pair (its column relative to the
// first the window's taps reach), its fraction, and whether it lies inside
// the source.
template <int ID>
struct CachedCols {
  int d[ID];
  double f[ID];
  unsigned ok = 0;

  __device__ __forceinline__ void set(int q, int dq, double fq, bool okq) {
#pragma unroll
    for (int k = 0; k < ID; ++k) {
      if (k == q) {
        d[k] = dq;
        f[k] = fq;
      }
    }
    ok |= static_cast<unsigned>(okq) << q;
  }
};

// What a cached tap hands the reducer: T, or (kRound 0, float data, a
// reducer that widens its taps to float64) the unrounded lerp.
template <typename T, int AGG>
using TapOf = std::conditional_t<kRound == 0 && std::is_floating_point<T>::value &&
                                     (AGG == kMean || AGG == kSum || AGG == kStd ||
                                      AGG == kVar || AGG == kProd),
                                 double, T>;

// The inflated pixels of one window, as the reducer asks for them (the
// cached kernel).
template <typename T, int AGG, int ID>
struct CachedTaps {
  static constexpr int M = ID + 1;
  using V = TapOf<T, AGG>;
  const Args& a;
  const T* p;                  // the band's plane, at the first column
  int64_t j0;                  // the window's first inflated row
  const int* cm;               // [M]: the columns loaded, relative, clamped
  const CachedCols<ID>& cols;
  double2* pairs;              // [m * nt]
  int nt;
  T fill;

  // Window row r: its two source rows loaded together at the thread's
  // columns and lerped into the pairs; then each tap is one pair and one
  // column lerp.
  struct Row;

  __device__ __forceinline__ Row row(int64_t r) const {
    const Axis<int64_t> ax = bilinear_axis<int64_t>(j0 + r, a.j_scale, a.j_off, a.src_h);
    if (ax.ok) {
      const T* p0 = p + ax.t0 * a.pitch_h;
      const T* p1 = p + (ax.t0 + 1 < a.src_h ? ax.t0 + 1 : a.src_h - 1) * a.pitch_h;
      T v0[M], v1[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        v0[m] = p0[cm[m]];
        v1[m] = p1[cm[m]];
      }
      double c[M];
#pragma unroll
      for (int m = 0; m < M; ++m) c[m] = row_lerp(v0[m], v1[m], ax.f, ax.g);
#pragma unroll
      for (int m = 0; m < M; ++m) pairs[m * nt] = make_double2(c[m], c[m + 1 < M ? m + 1 : m]);
    }
    return Row{cols, pairs, nt, static_cast<V>(fill), static_cast<bool>(ax.ok)};
  }

  // A window row's taps (a functor, so that its calls are inlined).
  struct Row {
    const CachedCols<ID>& c;
    const double2* pairs;
    int nt;
    V fill;
    bool ok;
    template <typename Q>
    __device__ __forceinline__ V operator()(Q q) const {
      const int k = static_cast<int>(tap_index(q));
      const double2 w = pairs[c.d[k] * nt];
      const double f = c.f[k];
      const double x = w.x * (1.0 - f) + w.y * f;
      V v;
      if constexpr (std::is_same<V, T>::value) {
        v = round_from<T>(x);
      } else {
        v = x;
      }
      return ok && ((c.ok >> k) & 1u) ? v : fill;
    }
  };
};

template <typename T, int AGG, int ID>
__device__ __forceinline__ void cached_body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using O = typename OutType<T, AGG>::type;
  constexpr int M = ID + 1;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t oi = static_cast<int64_t>(blockIdx.x) * nt + tid;
  if (oi >= a.ow) return;
  double2* pairs = reinterpret_cast<double2*>(smem) + tid;
  // the window's columns: the first its (clipped) taps reach, each tap's
  // pair, weights and validity, and the M columns loaded from the first
  const Axis<int64_t> xa = bilinear_axis<int64_t>(oi * ID, a.i_scale, a.i_off, a.src_w);
  const Axis<int64_t> xb = bilinear_axis<int64_t>(oi * ID + ID - 1, a.i_scale, a.i_off, a.src_w);
  const int64_t x_base = xa.t0 < xb.t0 ? xa.t0 : xb.t0;
  CachedCols<ID> cols;
#pragma unroll
  for (int q = 0; q < ID; ++q) {
    const Axis<int64_t> cx = bilinear_axis<int64_t>(oi * ID + q, a.i_scale, a.i_off, a.src_w);
    cols.set(q, static_cast<int>(cx.t0 - x_base), cx.f, cx.ok);
  }
  int cm[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    cm[m] = static_cast<int>(x_base + m < a.src_w ? m : a.src_w - 1 - x_base);
  }
  const T* __restrict__ src = static_cast<const T*>(a.src);
  O* __restrict__ out = static_cast<O*>(a.out);
  const T fill = round_from<T>(a.fill);
  // the band b and output row oj of `row`, stepped without a division;
  // the first and the step in 32 bits (the grid's rows stay below 2^16), as
  // a 64-bit division is a call, around which ptxas spills what is live
  const unsigned oh32 = a.oh < 65536 ? static_cast<unsigned>(a.oh) : 65536u;
  const int64_t step_b = gridDim.y / oh32;
  const int64_t step_j = gridDim.y - step_b * a.oh;
  int64_t b = blockIdx.y / oh32;
  int64_t oj = blockIdx.y - b * a.oh;
  for (int64_t row = blockIdx.y; row < a.n_rows; row += gridDim.y) {
    if (row != blockIdx.y) {
      b += step_b;
      oj += step_j;
      if (oj >= a.oh) {
        oj -= a.oh;
        ++b;
      }
    }
    CachedTaps<T, AGG, ID> taps{a, src + b * a.pitch_b + x_base, oj * a.jd, cm, cols, pairs,
                                nt, fill};
    out[row * a.ow + oi] =
        reduce<T, AGG>(taps, a.jd, std::integral_constant<int, ID>{}, a.pa, a.pb);
  }
}

// float32 (the main path): ptxas's own register target, which spills none
// of these kernels (held to one block an SM at least, they took more
// registers and ran 8% slower at the pre-downscale on an H100).
template <int AGG, int ID>
__global__ void __launch_bounds__(kThreads) affine_gather_reduce_cached_f32(const Args a) {
  cached_body<float, AGG, ID>(a);
}

// The other dtypes: one block an SM at least, which sets no register target
// for occupancy (with only the block's size ptxas spilled 4-24 bytes in 29
// of them, at 56-80 registers).
template <typename T, int AGG, int ID>
__global__ void __launch_bounds__(kThreads, 1) affine_gather_reduce_cached(const Args a) {
  cached_body<T, AGG, ID>(a);
}

// The inflated pixels of one window, gathered as the reducer asks for
// them (the direct kernel): each tap lerps its own two columns.
template <typename T>
struct WindowTaps {
  const Args& a;
  const T* p;      // the band's plane
  int64_t j0, i0;  // the window's first inflated row and column
  T fill;

  __device__ __forceinline__ auto row(int64_t r) const {
    const Axis<int64_t> ax = bilinear_axis<int64_t>(j0 + r, a.j_scale, a.j_off, a.src_h);
    const T* p0 = p + ax.t0 * a.pitch_h;
    const T* p1 = p + (ax.t0 + 1 < a.src_h ? ax.t0 + 1 : a.src_h - 1) * a.pitch_h;
    const Args& args = a;
    const int64_t i0_ = i0;
    const T fill_ = fill;
    return [=, &args](int64_t q) -> T {
      const Axis<int64_t> cx = bilinear_axis<int64_t>(i0_ + q, args.i_scale, args.i_off, args.src_w);
      if (!ax.ok || !cx.ok) return fill_;
      const int64_t x1 = cx.t0 + 1 < args.src_w ? cx.t0 + 1 : args.src_w - 1;
      return round_from<T>(row_lerp(p0[cx.t0], p1[cx.t0], ax.f, ax.g) * cx.g +
                           row_lerp(p0[x1], p1[x1], ax.f, ax.g) * cx.f);
    };
  }
};

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreads) affine_gather_reduce_direct(const Args a) {
  using O = typename OutType<T, AGG>::type;
  const int64_t oi = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (oi >= a.ow) return;
  const T* __restrict__ src = static_cast<const T*>(a.src);
  O* __restrict__ out = static_cast<O*>(a.out);
  const T fill = round_from<T>(a.fill);
  for (int64_t row = blockIdx.y; row < a.n_rows; row += gridDim.y) {
    const int64_t b = row / a.oh;
    const int64_t oj = row - b * a.oh;
    WindowTaps<T> taps{a, src + b * a.pitch_b, oj * a.jd, oi * a.id, fill};
    out[row * a.ow + oi] = reduce<T, AGG>(taps, a.jd, a.id, a.pa, a.pb);
  }
}

// Blocks of kThreads output columns, one wave of them down (a grid-stride
// loop over the rows).
template <typename K>
cudaError_t launch_grid(K kernel, const Args& a, size_t smem, cudaStream_t s) {
  const int64_t cols = (a.ow + kThreads - 1) / kThreads;
  unsigned rows = 1;
  const cudaError_t e = wave_rows(kernel, kThreads, smem, cols, a.n_rows, &rows);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(static_cast<unsigned>(cols), rows), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The cached kernel of the window's width (1 .. kMaxWidth).
template <typename T, int AGG, int W = 1>
auto cached_kernel(int64_t width) -> void (*)(const Args) {
  if constexpr (W <= kMaxWidth) {
    if (width == W) {
      if constexpr (std::is_same<T, float>::value) {
        return affine_gather_reduce_cached_f32<AGG, W>;
      } else {
        return affine_gather_reduce_cached<T, AGG, W>;
      }
    }
    return cached_kernel<T, AGG, W + 1>(width);
  } else {
    return nullptr;
  }
}

// The data types with cached kernels: the seven the downscale form took
// before it took every data type (a template on the width 1-8 for each of
// 8 reducers: the build's longest source); the others take the direct
// kernel (srw_kernels' plan_gather_reduce routes them there).
template <typename T>
constexpr bool kCachedType =
    std::is_floating_point<T>::value ||
    (std::is_integral<T>::value && sizeof(T) <= 4 && !std::is_same<T, uint32_t>::value &&
     !std::is_same<T, bool>::value);

// route 1: the cached kernel (its pairs, kThreads x (id + 1), in shared
// memory); route 0: the direct kernel.
template <typename T, int AGG>
cudaError_t launch(const Args& a, int route, cudaStream_t s) {
  if constexpr (AGG != kPick && kCachedType<T>) {
    if (route == 1) {
      auto kernel = cached_kernel<T, AGG>(a.id);
      if (kernel == nullptr) return cudaErrorInvalidValue;
      return launch_grid(kernel, a, static_cast<size_t>(kThreads) * (a.id + 1) * sizeof(double2),
                         s);
    }
  }
  if (route != 0) return cudaErrorInvalidValue;
  return launch_grid(affine_gather_reduce_direct<T, AGG>, a, 0, s);
}

}  // namespace

// The downscale of a (batch, src_h, src_w) source, strided by pitch_b and
// pitch_h (elements), into a (batch, out_h, out_w) image of j_div x i_div
// windows of the bilinear gather at the residual scales (|scale| <= 1);
// agg the reducer code of coarsen_reduce.h, (pa, pb) the tap of a pick;
// fill the fill in the source's float type; route 1 the cached kernel
// (windows up to kMaxWidth wide whose taps step by at most one source
// column, no pick), 0 the direct kernel.  Returns cudaGetLastError().
extern "C" int xrt_affine_gather_reduce(
    const void* src, void* out, int64_t batch, int64_t src_h, int64_t src_w,
    int64_t pitch_b, int64_t pitch_h, int64_t out_h, int64_t out_w,
    int64_t j_div, int64_t i_div, double j_scale, double i_scale, double j_off,
    double i_off, double fill, int agg, int64_t pa, int64_t pb, int code,
    int route, void* stream) {
  if (batch < 1 || src_h < 1 || src_w < 1 || src_w >= INT_MAX || out_h < 1 || out_w < 1 ||
      j_div < 1 || i_div < 1 || j_div > (int64_t{1} << 16) || i_div > (int64_t{1} << 16) ||
      !(fabs(j_scale) <= 1.0) || !(fabs(i_scale) <= 1.0) || pitch_b < 0 || pitch_h < 0 ||
      pa < 0 || pa >= j_div || pb < 0 || pb >= i_div) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{src, out, src_h, src_w, pitch_b, pitch_h, out_h, out_w, j_div, i_div,
               pa, pb, batch * out_h, j_scale, i_scale, j_off, i_off, fill};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_data_type(code, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    return with_agg(agg, [&](auto r) { return launch<T, decltype(r)::value>(a, route, s); });
  }));
}
