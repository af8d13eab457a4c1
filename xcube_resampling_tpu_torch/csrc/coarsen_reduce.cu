// K5: the window reducers (statistics and positional picks).
//
// Every j_div x i_div window of a (batch, h, w) array becomes one value of
// a (batch, h / j_div, w / i_div) array, by the reducers of
// coarsen_reduce.h (mean, sum, std, var, min, max, prod, count, and the
// picks first, last, center), which K4's downscale form
// (affine_gather_reduce.cu) shares.
//
// Replaces the XLA device path of xcube_resampling_tpu/ops/coarsen_ops.py:
// coarsen_jax (:36-87), whose semantics these are under x64.  JAX sums
// float32 in float32 in XLA's order; accumulating in float64 and rounding
// once puts the kernel within a few float32 ulp of it (PERF.md).
//
// Bound on the H100: device memory.  The work must read every input once
// (a pick only the sectors its taps touch) and write every output once,
// with one or two float64 operations a tap.  Design: a thread owns one
// output; neighbouring threads take neighbouring windows of one output
// row, so a warp's loads of one window position are i_div elements apart
// and the other positions hit the same sectors in L1.  The reducer is a
// template parameter; offsets are 64-bit.
#include "coarsen_reduce.h"

namespace {

using namespace xrt;

constexpr int kThreads = 128;

struct Args {
  const void* src;
  void* out;
  int64_t h, w, oh, ow, jd, id, pa, pb, n_rows;  // n_rows = batch * oh
};

// The taps of a window in device memory, rows w apart.
template <typename T>
struct Window {
  const T* p;
  int64_t w;
  __device__ __forceinline__ auto row(int64_t r) const {
    const T* rp = p + r * w;
    return [rp](int64_t q) -> T { return rp[q]; };
  }
};

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreads) coarsen_reduce_kernel(const Args a) {
  using O = typename OutType<T, AGG>::type;
  const int64_t oi = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (oi >= a.ow) return;
  const T* __restrict__ src = static_cast<const T*>(a.src);
  O* __restrict__ out = static_cast<O*>(a.out);
  for (int64_t row = blockIdx.y; row < a.n_rows; row += gridDim.y) {
    const int64_t b = row / a.oh;
    const int64_t oj = row - b * a.oh;
    Window<T> taps{src + (b * a.h + oj * a.jd) * a.w + oi * a.id, a.w};
    out[row * a.ow + oi] = reduce<T, AGG>(taps, a.jd, a.id, a.pa, a.pb);
  }
}

template <typename T, int AGG>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.ow + kThreads - 1) / kThreads),
                  static_cast<unsigned>(a.n_rows < 65535 ? a.n_rows : 65535));
  coarsen_reduce_kernel<T, AGG><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// agg: the Agg code; (pa, pb) the tap of kPick; returns cudaGetLastError().
extern "C" int xrt_coarsen_reduce(
    const void* src, void* out, int64_t batch, int64_t h, int64_t w,
    int64_t j_div, int64_t i_div, int agg, int64_t pa, int64_t pb, int code,
    void* stream) {
  if (batch < 1 || j_div < 1 || i_div < 1 || h < j_div || w < i_div ||
      h % j_div || w % i_div || pa < 0 || pa >= j_div || pb < 0 || pb >= i_div) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{src, out, h, w, h / j_div, w / i_div, j_div, i_div, pa, pb,
               batch * (h / j_div)};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_data_type(code, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    return with_agg(agg, [&](auto r) { return launch<T, decltype(r)::value>(a, s); });
  }));
}
