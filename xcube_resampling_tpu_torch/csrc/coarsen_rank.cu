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
//   The ranks key on the tap index, so -0.0 and +0.0 (equal, but not the
//   same bits) and ties come out as the definitions say; a sorting network
//   that does not carry the index would not.
//
// Replaces the XLA device path of xcube_resampling_tpu/ops/coarsen_ops.py:
// _mode_jax (:95-148; pairwise counts up to 64 taps, sort and run length
// above: both give the result defined above, so the kernel counts pairs
// for every window size and needs no sort) and jnp.nanmedian in
// coarsen_jax (:66-69).
//
// Bound on the H100: device memory (the work must read every input once
// and write every output once).  Design, up to kMaxRegTaps taps: a thread
// owns one output and holds its window in registers (the register kernel
// below), each pair of taps compared once and counted for both.  Above, a
// thread stages its window in shared memory, tap k at k * threads + thread
// (no bank conflicts, no barrier: a thread reads only its own column), and
// counts every pair from there; where even 32 windows do not fit the
// wrapper's budget, it reads its taps from device memory (through L1)
// instead.
#include <climits>

#include "kernel_types.h"

namespace {

using xrt::is_nan;
using xrt::round_from;

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
      for (int k = 0; k < taps; ++k) n += !is_nan(tap(k));
      const int lo_r = (n - 1) / 2;
      const int hi_r = n / 2;
      T lo = tap(0);  // NaN when every tap is NaN
      T hi = lo;
      for (int t = 0; t < taps; ++t) {
        const T vt = tap(t);
        if (is_nan(vt)) continue;
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
      } else if constexpr (xrt::is_float_v<T>) {
        result = (lo + hi) * T(0.5);
      } else {
        // rint first: bool's conversion is != 0
        result = round_from<T>(rint((xrt::to_f64(lo) + xrt::to_f64(hi)) * 0.5));
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

// -- the register kernel --------------------------------------------------
//
// Templated on the compute type C (float, double, or int32 for every
// integer data type, whose values it widens on load: equality and order do
// not change) and on a tap capacity CAP of 16 or 32.  Its loops are
// unrolled in full, so every tap has a register of its own (no local
// memory).  Taps past the window's own (taps < CAP) are padded so that the
// pair loop needs no test: the mode pads with tap 0, whose values' counts
// it then takes back, the median with a value that ranks after every tap
// (NaN, or INT32_MAX, which ties break after any int32 tap).  Each pair of
// taps is compared once and counted for both, the counts or ranks packed
// four to a 32-bit register (one byte each: at most 32).  The window rows
// are read with 16-byte loads where i_div and the row pitch allow.  The
// kernel asks for one block an SM at least (__launch_bounds__): with that
// bound ptxas gives the unrolled windows the registers they need and
// spills none (without it, some 32-tap kernels spilled 8 bytes).

constexpr int kRegThreads = 128;
constexpr int kMaxRegTaps = 32;  // windows up to this many taps live in registers

// Byte k % 4 of packed[k / 4]: the count or rank of tap k.  Called from
// loops unrolled in full, so k and the shift are constants.
template <int N>
__device__ __forceinline__ void bump(uint32_t (&packed)[N], int k, bool on) {
  packed[k / 4] += static_cast<uint32_t>(on) << (8 * (k % 4));
}

template <int N>
__device__ __forceinline__ int byte_of(const uint32_t (&packed)[N], int k) {
  return static_cast<int>((packed[k / 4] >> (8 * (k % 4))) & 0xffu);
}

// The lanes of one 16-byte load.
template <typename T>
struct alignas(16) Lanes {
  T v[16 / sizeof(T)];
};

// The first *taps* taps of the window at rp (rows of id taps, w apart) into
// v, widened to C.
template <typename T, typename C, int CAP>
__device__ __forceinline__ void load_window(C (&v)[CAP], const T* rp, int64_t w, int id,
                                            int taps, bool vec) {
  constexpr int kLanes = 16 / sizeof(T);
  int q = 0;
  if (vec) {  // id % kLanes == 0: a load never straddles two window rows
#pragma unroll
    for (int k = 0; k < CAP; k += kLanes) {
      if (k < taps) {
        const Lanes<T> l = *reinterpret_cast<const Lanes<T>*>(rp + q);
#pragma unroll
        for (int u = 0; u < kLanes; ++u) v[k + u] = static_cast<C>(l.v[u]);
        q += kLanes;
        if (q == id) {
          q = 0;
          rp += w;
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < CAP; ++k) {
      if (k < taps) {
        v[k] = static_cast<C>(rp[q]);
        if (++q == id) {
          q = 0;
          rp += w;
        }
      }
    }
  }
}

// out[i] = x in the data type of *code* whose compute type is C (x lies
// in its range).
template <typename C>
__device__ __forceinline__ void store(void* out, int64_t i, int code, C x) {
  if constexpr (std::is_floating_point<C>::value) {
    static_cast<C*>(out)[i] = x;
  } else {
    switch (code) {
      case xrt::kI8: static_cast<int8_t*>(out)[i] = static_cast<int8_t>(x); break;
      case xrt::kI16: static_cast<int16_t*>(out)[i] = static_cast<int16_t>(x); break;
      case xrt::kU8: static_cast<uint8_t*>(out)[i] = static_cast<uint8_t>(x); break;
      case xrt::kU16: static_cast<uint16_t*>(out)[i] = static_cast<uint16_t>(x); break;
      default: static_cast<int32_t*>(out)[i] = x;
    }
  }
}

template <typename C, bool MEDIAN, int CAP>
__global__ void __launch_bounds__(kRegThreads, 1) coarsen_rank_regs_kernel(const Args a, int code,
                                                                         bool vec) {
  const int64_t oi = static_cast<int64_t>(blockIdx.x) * kRegThreads + threadIdx.x;
  if (oi >= a.ow) return;
  const int taps = static_cast<int>(a.jd * a.id);
  const int id = static_cast<int>(a.id);
  for (int64_t row = blockIdx.y; row < a.n_rows; row += gridDim.y) {
    const int64_t b = row / a.oh;
    const int64_t oj = row - b * a.oh;
    const int64_t first = (b * a.h + oj * a.jd) * a.w + oi * a.id;
    C v[CAP];
    if constexpr (std::is_floating_point<C>::value) {
      load_window<C, C, CAP>(v, static_cast<const C*>(a.src) + first, a.w, id, taps, vec);
    } else {
      switch (code) {
        case xrt::kI8:
          load_window<int8_t, C, CAP>(v, static_cast<const int8_t*>(a.src) + first, a.w, id,
                                      taps, vec);
          break;
        case xrt::kI16:
          load_window<int16_t, C, CAP>(v, static_cast<const int16_t*>(a.src) + first, a.w, id,
                                       taps, vec);
          break;
        case xrt::kU8:
          load_window<uint8_t, C, CAP>(v, static_cast<const uint8_t*>(a.src) + first, a.w, id,
                                       taps, vec);
          break;
        case xrt::kU16:
          load_window<uint16_t, C, CAP>(v, static_cast<const uint16_t*>(a.src) + first, a.w,
                                        id, taps, vec);
          break;
        default:
          load_window<int32_t, C, CAP>(v, static_cast<const int32_t*>(a.src) + first, a.w, id,
                                       taps, vec);
      }
    }
    uint32_t packed[CAP / 4];
#pragma unroll
    for (int k = 0; k < CAP / 4; ++k) packed[k] = 0u;
    if constexpr (!MEDIAN) {
      // count[t] = #{k : tap k == tap t} (0 for NaN): each pair once, for
      // both taps; the pads are copies of tap 0
      const C pad = v[0];
#pragma unroll
      for (int k = 1; k < CAP; ++k) {
        if (k >= taps) v[k] = pad;
      }
#pragma unroll
      for (int t = 0; t < CAP; ++t) bump(packed, t, v[t] == v[t]);
#pragma unroll
      for (int t = 0; t < CAP; ++t) {
#pragma unroll
        for (int k = t + 1; k < CAP; ++k) {
          const bool eq = v[t] == v[k];
          bump(packed, t, eq);
          bump(packed, k, eq);
        }
      }
      // walking the taps in order: a higher count, or an equal count with a
      // smaller value, replaces the best
      const int pads = CAP - taps;
      C best_v = v[0];
      int best_c = -1;
#pragma unroll
      for (int t = 0; t < CAP; ++t) {
        if (t < taps) {
          const int c = byte_of(packed, t) - (v[t] == pad ? pads : 0);
          if (c > best_c || (c == best_c && v[t] < best_v)) {
            best_c = c;
            best_v = v[t];
          }
        }
      }
      store<C>(a.out, row * a.ow + oi, code, best_v);
    } else {
      // rank[t]: the valid taps before t in (value, index) order; the pads
      // rank after every tap.  Of a pair t < k, t comes first when tap t <=
      // tap k, k first when tap k < tap t, neither when one of them is NaN.
      int n = 0;
      C pad;
      if constexpr (std::is_floating_point<C>::value) {
        pad = C(NAN);
      } else {
        pad = C(INT_MAX);
      }
#pragma unroll
      for (int k = 0; k < CAP; ++k) {
        if (k < taps) {
          n += !is_nan(v[k]);
        } else {
          v[k] = pad;
        }
      }
      const int lo_r = (n - 1) / 2;
      const int hi_r = n / 2;
      C lo = v[0];  // NaN when every tap is NaN
      C hi = lo;
#pragma unroll
      for (int t = 0; t < CAP; ++t) {
#pragma unroll
        for (int k = t + 1; k < CAP; ++k) {
          bump(packed, k, v[t] <= v[k]);
          bump(packed, t, v[k] < v[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < CAP; ++t) {
        if (t < taps && !is_nan(v[t])) {
          const int r = byte_of(packed, t);
          if (r == lo_r) lo = v[t];
          if (r == hi_r) hi = v[t];
        }
      }
      C result = lo;
      if (n % 2 == 0 && n > 0) {
        if constexpr (std::is_floating_point<C>::value) {
          result = (lo + hi) * C(0.5);
        } else {
          // rint of the integer mean is within every integer type's range
          result = round_from<int32_t>((static_cast<double>(lo) + static_cast<double>(hi)) * 0.5);
        }
      }
      store<C>(a.out, row * a.ow + oi, code, result);
    }
  }
}

template <typename C, bool MEDIAN, int CAP>
cudaError_t launch_cap(const Args& a, int code, bool vec, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.ow + kRegThreads - 1) / kRegThreads),
                  static_cast<unsigned>(a.n_rows < 65535 ? a.n_rows : 65535));
  coarsen_rank_regs_kernel<C, MEDIAN, CAP><<<grid, kRegThreads, 0, s>>>(a, code, vec);
  return cudaGetLastError();
}

// The register kernel of compute type C for the window's taps.
template <typename C>
cudaError_t launch_regs(const Args& a, int median, int code, int64_t itemsize,
                        cudaStream_t s) {
  const bool vec = (a.id * itemsize) % 16 == 0 && (a.w * itemsize) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.src) % 16 == 0;
  if (a.jd * a.id <= 16) {
    return median ? launch_cap<C, true, 16>(a, code, vec, s)
                  : launch_cap<C, false, 16>(a, code, vec, s);
  }
  return median ? launch_cap<C, true, kMaxRegTaps>(a, code, vec, s)
                : launch_cap<C, false, kMaxRegTaps>(a, code, vec, s);
}

}  // namespace

// median: 0 for the mode, 1 for the median; windows of up to kMaxRegTaps
// taps are held in registers; above, threads: the block size when the
// windows are staged in shared memory (32, 64 or 128), 0 to read the taps
// from device memory; returns cudaGetLastError().
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
    // the register kernels take float32, float64 and the integers up to 32
    // bits but uint32; the other data types stage their windows (threads)
    constexpr bool kRegs = std::is_floating_point<T>::value ||
                           (std::is_integral<T>::value && sizeof(T) <= 4 &&
                            !std::is_same<T, uint32_t>::value && !std::is_same<T, bool>::value);
    if (!kRegs && threads == 0 && a.jd * a.id <= kMaxRegTaps) {
      return cudaErrorInvalidValue;
    }
    if (kRegs && a.jd * a.id <= kMaxRegTaps) {
      // integers compare as int32, floats as themselves
      using C = typename std::conditional<std::is_floating_point<T>::value, T, int32_t>::type;
      return launch_regs<C>(a, median, code, sizeof(T), s);
    }
    if (threads == 0) {
      return median ? launch<T, true, false>(a, 128, s) : launch<T, false, false>(a, 128, s);
    }
    return median ? launch<T, true, true>(a, threads, s) : launch<T, false, true>(a, threads, s);
  }));
}
