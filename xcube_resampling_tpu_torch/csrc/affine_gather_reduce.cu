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
// 1.78 GB, 0.53 ms).  Per inflated pixel it converts about 4.4 values
// between float32 and float64 and takes about 9 float64 operations, which
// at 16 conversions and 64 operations a clock on an SM is of the same
// order.  Design (the cached kernel, windows up to kMaxWidth wide): a
// thread owns one output column and walks the output rows of every band
// (a grid-stride loop, the grid one wave on the SMs).  Its window's
// inflated columns are the same in every row, so it takes their taps and
// fractions once, relative to the first of the source columns they reach
// (at most kMaxWidth + 1), into its slice of shared memory.  For each
// window row (the reducer's row(r)) it loads the two source rows at those
// columns together, lerps each column once and keeps the lerps in pairs (a
// column's and its right tap's); each tap (the reducer's tap(q), four
// unrolled at a time) is then one pair and one column lerp, rounded to T.
// std and var take the window twice (their centred pass).  A positional
// pick, which needs one tap a window, and windows wider than kMaxWidth
// take the direct kernel: the taps computed as the reducer asks for them.
// Offsets are 64-bit.
#include <climits>

#include "affine_gather.h"
#include "coarsen_reduce.h"

namespace {

using namespace xrt;

constexpr int kThreads = 128;
// the cached kernel takes windows up to kMaxWidth wide; their rows reach at
// most kMaxWidth + 1 source columns (residual scales up to 1), kept for
// kMaxCols
constexpr int kMaxWidth = 8;
constexpr int kMaxCols = kMaxWidth + 2;

struct Args {
  const void* src;
  void* out;
  int64_t src_h, src_w, pitch_b, pitch_h, oh, ow, jd, id, pa, pb, n_rows;
  double j_scale, i_scale, j_off, i_off, fill;
};

// The cached kernel's shared memory a thread: its window columns' taps
// (int, -1 outside) and fractions, and the row lerps of its source columns
// in pairs (lerp at column m, lerp at its right tap column), each array
// laid out [entry][thread] so that a warp's accesses fall on distinct banks.
__host__ __device__ inline size_t cached_smem(int nt, int id) {
  return static_cast<size_t>(nt) * (id * (sizeof(int) + sizeof(double)) +
                                    kMaxCols * sizeof(double2));
}

// The inflated pixels of one window, as the reducer asks for them (the
// cached kernel).
template <typename T>
struct CachedTaps {
  const Args& a;
  const T* p;          // the band's plane, at the thread's first source column
  int64_t j0;          // the window's first inflated row
  int ncols, nt;       // the thread's source columns; the table's stride
  const int* d0;       // [q * nt]: the tap column, relative (-1: outside)
  const double* fx;    // [q * nt]
  double2* pairs;      // [m * nt]
  T fill;

  // The lerps of source rows p0 and p1 at the thread's first M >= ncols
  // columns, loaded together, into the pairs.
  template <int M>
  __device__ __forceinline__ void lerp_row(const T* p0, const T* p1, double fy, double gy) {
    T v0[M], v1[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m < ncols) {
        v0[m] = p0[m];
        v1[m] = p1[m];
      }
    }
    double c[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m < ncols) c[m] = row_lerp(v0[m], v1[m], fy, gy);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      // the right tap of the last column is the column itself
      if (m < ncols) pairs[m * nt] = make_double2(c[m], m + 1 < ncols ? c[m + 1] : c[m]);
    }
  }

  // Window row r: its two source rows lerped at the thread's columns into
  // the pairs; then each tap is one pair and one column lerp.
  __device__ __forceinline__ auto row(int64_t r) {
    const Axis<int64_t> ax = bilinear_axis<int64_t>(j0 + r, a.j_scale, a.j_off, a.src_h);
    const bool ok = ax.ok && ncols > 0;
    if (ok) {
      const T* p0 = p + ax.t0 * a.pitch_h;
      const T* p1 = p + (ax.t0 + 1 < a.src_h ? ax.t0 + 1 : a.src_h - 1) * a.pitch_h;
      // as few load slots as the window's width needs (i_div + 2)
      if (a.id <= 2) {
        lerp_row<4>(p0, p1, ax.f, ax.g);
      } else if (a.id <= 4) {
        lerp_row<6>(p0, p1, ax.f, ax.g);
      } else {
        lerp_row<kMaxCols>(p0, p1, ax.f, ax.g);
      }
    }
    const int* d0_ = d0;
    const double* fx_ = fx;
    const double2* pairs_ = pairs;
    const int nt_ = nt;
    const T fill_ = fill;
    return [=](int64_t q) -> T {
      const int d = d0_[q * nt_];
      const double f = fx_[q * nt_];
      const double2 c = pairs_[(d > 0 ? d : 0) * nt_];
      const T v = round_from<T>(c.x * (1.0 - f) + c.y * f);
      return ok && d >= 0 ? v : fill_;
    };
  }
};

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreads) affine_gather_reduce_cached(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using O = typename OutType<T, AGG>::type;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int id = static_cast<int>(a.id);
  double2* pairs = reinterpret_cast<double2*>(smem) + tid;
  double* fx = reinterpret_cast<double*>(smem + sizeof(double2) * kMaxCols * nt) + tid;
  int* d0 = reinterpret_cast<int*>(smem + (sizeof(double2) * kMaxCols + sizeof(double) * id) * nt) + tid;
  const int64_t oi = static_cast<int64_t>(blockIdx.x) * nt + tid;
  if (oi >= a.ow) return;
  // the window's columns: taps and fractions, and the source columns
  // x_base .. x_base + ncols - 1 that they reach
  int64_t x_base = a.src_w, x_end = -1;
  for (int q = 0; q < id; ++q) {
    const Axis<int64_t> ax = bilinear_axis<int64_t>(oi * a.id + q, a.i_scale, a.i_off, a.src_w);
    if (ax.ok) {
      x_base = ax.t0 < x_base ? ax.t0 : x_base;
      const int64_t x1 = ax.t0 + 1 < a.src_w ? ax.t0 + 1 : a.src_w - 1;
      x_end = x1 > x_end ? x1 : x_end;
    }
  }
  const int ncols = x_end >= 0 ? static_cast<int>(x_end - x_base + 1) : 0;
  for (int q = 0; q < id; ++q) {
    const Axis<int64_t> ax = bilinear_axis<int64_t>(oi * a.id + q, a.i_scale, a.i_off, a.src_w);
    d0[q * nt] = ax.ok ? static_cast<int>(ax.t0 - x_base) : -1;
    fx[q * nt] = ax.f;
  }
  const T* __restrict__ src = static_cast<const T*>(a.src);
  O* __restrict__ out = static_cast<O*>(a.out);
  const T fill = round_from<T>(a.fill);
  // the band b and output row oj of `row`, stepped without a division
  const int64_t step_b = gridDim.y / a.oh;
  const int64_t step_j = gridDim.y - step_b * a.oh;
  int64_t b = blockIdx.y / a.oh;
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
    CachedTaps<T> taps{a, src + b * a.pitch_b + (ncols > 0 ? x_base : 0), oj * a.jd,
                       ncols, nt, d0, fx, pairs, fill};
    out[row * a.ow + oi] = reduce<T, AGG>(taps, a.jd, a.id, a.pa, a.pb);
  }
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

// Blocks of *threads* across the output width, one wave of them down (a
// grid-stride loop over the rows).
template <typename K>
cudaError_t launch_grid(K kernel, const Args& a, int threads, size_t smem, cudaStream_t s) {
  const int64_t cols = (a.ow + threads - 1) / threads;
  unsigned rows = 1;
  const cudaError_t e = wave_rows(kernel, threads, smem, cols, a.n_rows, &rows);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(static_cast<unsigned>(cols), rows), threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int AGG>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (AGG != kPick && a.id <= kMaxWidth) {
    return launch_grid(affine_gather_reduce_cached<T, AGG>, a, kThreads,
                       cached_smem(kThreads, static_cast<int>(a.id)), s);
  }
  return launch_grid(affine_gather_reduce_direct<T, AGG>, a, kThreads, 0, s);
}

}  // namespace

// The downscale of a (batch, src_h, src_w) source, strided by pitch_b and
// pitch_h (elements), into a (batch, out_h, out_w) image of j_div x i_div
// windows of the bilinear gather at the residual scales (|scale| <= 1);
// agg the reducer code of coarsen_reduce.h, (pa, pb) the tap of a pick;
// fill the fill in the source's float type.  Returns cudaGetLastError().
extern "C" int xrt_affine_gather_reduce(
    const void* src, void* out, int64_t batch, int64_t src_h, int64_t src_w,
    int64_t pitch_b, int64_t pitch_h, int64_t out_h, int64_t out_w,
    int64_t j_div, int64_t i_div, double j_scale, double i_scale, double j_off,
    double i_off, double fill, int agg, int64_t pa, int64_t pb, int code,
    void* stream) {
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
    return with_agg(agg, [&](auto r) { return launch<T, decltype(r)::value>(a, s); });
  }));
}
