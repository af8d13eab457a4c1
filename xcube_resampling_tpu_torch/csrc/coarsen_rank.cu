// K6: the rank reducers of a window: categorical mode and median.
//
// Every j_div x i_div window (w taps, in row-major window order) of a
// (batch, h, w) array becomes one value of its data type:
//   mode: count[t] = #{k : tap k == tap t}; walking the taps in order, a
//     tap replaces the best when its count is higher, or equal with a
//     smaller value: the smallest value among those of the highest count.
//     NaN never equals itself (count 0), so NaN is the result only of an
//     all-NaN window.
//   median: every valid (non-NaN) tap t gets the unique rank
//     #{k valid : tap k < tap t, or tap k == tap t and k < t}; an odd
//     count n takes the tap of rank (n - 1) / 2, an even count
//     (lo + hi) * 0.5 of ranks n / 2 - 1 and n / 2 in the data's float
//     type (float64 for integers, then rint); NaN for an all-NaN window.
//
// Replaces the XLA device path of xcube_resampling_tpu/ops/coarsen_ops.py:
// _mode_jax (:95-148; pairwise counts up to 64 taps, sort and run length
// above: both give the result defined above, so the kernel counts pairs
// for every window size and needs no sort) and jnp.nanmedian in
// coarsen_jax (:66-69).
//
// Bound on the H100: device memory for small windows (the work must read
// every input once and write every output once), the w^2 compares of a
// window for large ones (64 taps: 4096 compares an output).  Design: a
// thread owns one output and stages its window in shared memory, tap k at
// k * threads + thread (no bank conflicts, no barrier: a thread reads only
// its own column), then counts from there.  Where even 32 windows do not
// fit the wrapper's budget, the thread reads its taps from device memory
// (through L1) instead.
#include "kernel_types.h"

namespace {

struct Args {
  const void* src;
  void* out;
  int64_t h, w, oh, ow, jd, id, n_rows;  // n_rows = batch * oh
};

template <typename T, bool MEDIAN, bool STAGED>
__global__ void coarsen_rank_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t oi = static_cast<int64_t>(blockIdx.x) * nt + tid;
  if (oi >= a.ow) return;
  const T* __restrict__ src = static_cast<const T*>(a.src);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int taps = static_cast<int>(a.jd * a.id);
  for (int64_t row = blockIdx.y; row < a.n_rows; row += gridDim.y) {
    const int64_t b = row / a.oh;
    const int64_t oj = row - b * a.oh;
    const T* p = src + (b * a.h + oj * a.jd) * a.w + oi * a.id;
    if (STAGED) {
      int k = 0;
      for (int64_t r = 0; r < a.jd; ++r)
        for (int64_t q = 0; q < a.id; ++q) s[(k++) * nt + tid] = p[r * a.w + q];
    }
    auto tap = [&](int k) -> T {
      if (STAGED) return s[k * nt + tid];
      return p[(k / a.id) * a.w + (k % a.id)];
    };
    T result;
    if (!MEDIAN) {
      T best_v = tap(0);
      int best_c = -1;
      for (int t = 0; t < taps; ++t) {
        const T vt = tap(t);
        int c = 0;
        for (int k = 0; k < taps; ++k) c += tap(k) == vt;
        if (c > best_c || (c == best_c && vt < best_v)) {
          best_c = c;
          best_v = vt;
        }
      }
      result = best_v;
    } else {
      int n = 0;
      for (int k = 0; k < taps; ++k) n += !xrt::is_nan(tap(k));
      const int lo_r = (n - 1) / 2;
      const int hi_r = n / 2;
      T lo = tap(0);  // NaN when every tap is NaN
      T hi = lo;
      for (int t = 0; t < taps; ++t) {
        const T vt = tap(t);
        if (xrt::is_nan(vt)) continue;
        int rank = 0;
        for (int k = 0; k < taps; ++k) {
          const T vk = tap(k);
          rank += vk < vt || (vk == vt && k < t);  // false for NaN vk
        }
        if (rank == lo_r) lo = vt;
        if (rank == hi_r) hi = vt;
      }
      if (n % 2 == 1 || n == 0) {
        result = lo;
      } else if constexpr (std::is_floating_point<T>::value) {
        result = (lo + hi) * T(0.5);
      } else {
        result = xrt::round_from<T>((static_cast<double>(lo) + static_cast<double>(hi)) * 0.5);
      }
    }
    out[row * a.ow + oi] = result;
  }
}

template <typename T, bool MEDIAN, bool STAGED>
cudaError_t launch(const Args& a, int threads, cudaStream_t s) {
  const size_t smem = STAGED ? static_cast<size_t>(a.jd * a.id) * threads * sizeof(T) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(coarsen_rank_kernel<T, MEDIAN, STAGED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>((a.ow + threads - 1) / threads),
                  static_cast<unsigned>(a.n_rows < 65535 ? a.n_rows : 65535));
  coarsen_rank_kernel<T, MEDIAN, STAGED><<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// median: 0 for the mode, 1 for the median; threads: the block size when
// the windows are staged in shared memory (32, 64 or 128), 0 to read the
// taps from device memory; returns cudaGetLastError().
extern "C" int xrt_coarsen_rank(
    const void* src, void* out, int64_t batch, int64_t h, int64_t w,
    int64_t j_div, int64_t i_div, int median, int code, int threads,
    void* stream) {
  if (batch < 1 || j_div < 1 || i_div < 1 || h < j_div || w < i_div ||
      h % j_div || w % i_div || j_div * i_div > (int64_t{1} << 30) ||
      (threads != 0 && threads != 32 && threads != 64 && threads != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{src, out, h, w, h / j_div, w / i_div, j_div, i_div, batch * (h / j_div)};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(xrt::with_data_type(code, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    if (threads == 0) {
      return median ? launch<T, true, false>(a, 128, s) : launch<T, false, false>(a, 128, s);
    }
    return median ? launch<T, true, true>(a, threads, s) : launch<T, false, true>(a, threads, s);
  }));
}
