// Tap weights, field interpolation and staging helpers shared by the SRW
// and fused-reproject kernels.
//
// Rounding follows the JAX package's jitted XLA code as its compiler emits
// it: every ``a + b * c`` that XLA contracts into a fused multiply-add (the
// tap sums and the lerps) is an explicit fmaf here, and the library is
// built with -fmad=false so that nothing else is contracted.  The port's
// plain PyTorch versions round the same way (their fma emulates the single
// rounding in float64), so a kernel agrees with its plain version bit for
// bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace xrt {

enum Method : int { kBilinear = 0, kNearest = 1, kTriangular = 2 };

// a + t * (b - a) with one rounding of the product-sum, as XLA emits it
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return fmaf(t, b - a, a);
}

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// -- asynchronous global -> shared copies (sm_80+: cp.async) ---------------

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// one float32 or float64 value
__device__ __forceinline__ void cp_async_word(float* smem, const float* gmem) {
  cp_async4(smem, gmem);
}

__device__ __forceinline__ void cp_async_word(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a * b + c rounded once in V (float32 or float64): the tap sums' step,
// float32 weights widened for float64 values as jnp promotes the product
template <typename V>
__device__ __forceinline__ V fused_v(float a, V b, V c) {
  if constexpr (sizeof(V) == 8) {
    return fma(static_cast<double>(a), b, c);
  } else {
    return fmaf(a, b, c);
  }
}

// The tap sums of one output at position p: d_n taps of the staged
// window, the first at sp (tap index b0), the next `stride` values on, in
// the value type V (float32; float64 for float64 sources, whose float32
// weights widen before the product).
// The weight of tap k is the hat max(0, 1 - |p - k|) for bilinear and
// triangular, and for nearest 1 where rint(p) == k (rintf rounds half to
// even like jnp.round and torch.round, never roundf).  Triangular adds the
// (1, -1) mixed-difference taps of its correction in acc_d: +1 at
// floor(p), -1 at floor(p) + 1.  The sums run from acc = acc_d = +0 in tap
// order, one fused multiply-add a tap, as XLA contracts them.
//
// Only taps floor(p) and floor(p) + 1 (rint(p) for nearest) can carry a
// nonzero weight, and a zero-weight tap with a finite value leaves the sum
// as it is (x + 0 * s == x, and +0 stays +0).  So where every value of the
// staged window is finite (*finite*, checked once per window), those one
// or two fused multiply-adds give the full sum bit for bit.  Otherwise
// every tap is summed, so that 0 * NaN reaches the output as in the XLA
// path.
template <int M, typename V = float>
__device__ __forceinline__ void tap_sums(const V* sp, int stride, float p,
                                         int b0, int d_n, bool finite,
                                         V& acc, V& acc_d) {
  const float fp = floorf(p);
  if (finite) {
    if (M == kNearest) {
      const int t = static_cast<int>(rintf(p)) - b0;
      acc = t >= 0 && t < d_n ? fused_v(1.0f, sp[t * stride], V(0)) : V(0);
      return;
    }
    const int t = static_cast<int>(fp) - b0;
    V a = V(0);
    V ad = V(0);
    if (t >= 0 && t < d_n) {
      const V s = sp[t * stride];
      a = fused_v(fmaxf(0.0f, 1.0f - fabsf(p - fp)), s, a);
      if (M == kTriangular) ad = fused_v(1.0f, s, ad);
    }
    if (t + 1 >= 0 && t + 1 < d_n) {
      const V s = sp[(t + 1) * stride];
      a = fused_v(fmaxf(0.0f, 1.0f - fabsf(p - (fp + 1.0f))), s, a);
      if (M == kTriangular) ad = fused_v(-1.0f, s, ad);
    }
    acc = a;
    acc_d = ad;
    return;
  }
  const float rp = rintf(p);
  float k = static_cast<float>(b0);  // k += 1.0f is exact below 2^24
  for (int d = 0; d < d_n; ++d) {
    const V s = sp[d * stride];
    const float w = M == kNearest ? (rp == k ? 1.0f : 0.0f)
                                  : fmaxf(0.0f, 1.0f - fabsf(p - k));
    acc = fused_v(w, s, acc);
    if (M == kTriangular) {
      const float dw = (fp == k ? 1.0f : 0.0f) - (fp + 1.0f == k ? 1.0f : 0.0f);
      acc_d = fused_v(dw, s, acc_d);
    }
    k += 1.0f;
  }
}

// NF coarse (ncj, nci) fields of one geometry, sampled every 1 / inv
// target pixels.
template <int NF>
struct CoarseFields {
  const float* f[NF];
  int ncj, nci;
  float inv;
};

// Bilinear interpolation of coarse fields g at V columns col + S c (c < V;
// consecutive by default) and at rows that a thread visits in increasing
// order: the JAX
// package's reproject_ops._interp_field, its lerps contracted as XLA does.
// Each column's cell and fraction are taken once, and the row lerps of
// every field and column are kept while the rows stay in one coarse cell,
// with one cell test a row (in K3, a test per field and column was 1.5x
// slower).  The same operations on the same values as _interp_field: the
// cell test only decides when the row lerps are recomputed.  g is passed
// to every call, not kept, so that a kernel's parameters stay in its
// constant bank.
template <int NF, int V, int S = 1>
class FieldCols {
 public:
  __device__ FieldCols(const CoarseFields<NF>& g, float col) {
#pragma unroll
    for (int c = 0; c < V; ++c) {
      // col + S c is exact: columns stay below 2^24
      const float ci = (c == 0 ? col : col + static_cast<float>(c * S)) * g.inv;
      const float i0f = floorf(ci);
      fi_[c] = ci - i0f;
      i0_[c] = static_cast<int>(clamp_index(static_cast<int>(i0f), g.nci - 1));
    }
  }

  // v[k][c]: field k at *row* and column col + S c
  __device__ __forceinline__ void at(const CoarseFields<NF>& g, float row,
                                     float (&v)[NF][V]) {
    const float cj = row * g.inv;
    const float j0f = floorf(cj);
    const float fj = cj - j0f;
    const int j0 = static_cast<int>(clamp_index(static_cast<int>(j0f), g.ncj - 1));
    if (j0 != j_) {
      j_ = j0;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        // one 32-bit offset for every field
        const int e = j0 * g.nci + i0_[c];
#pragma unroll
        for (int k = 0; k < NF; ++k) {
          const float* r0 = g.f[k] + e;
          a0_[k][c] = lerp(r0[0], r0[1], fi_[c]);
          a1_[k][c] = lerp(r0[g.nci], r0[g.nci + 1], fi_[c]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NF; ++k) {
#pragma unroll
      for (int c = 0; c < V; ++c) v[k][c] = lerp(a0_[k][c], a1_[k][c], fj);
    }
  }

 private:
  int i0_[V], j_ = -1;
  float fi_[V], a0_[NF][V], a1_[NF][V];
};

// One field at one column (K1, K2).
class FieldColumn {
 public:
  __device__ FieldColumn(const float* f, int64_t ncj, int64_t nci, float col,
                         float inv)
      : g_{{f}, static_cast<int>(ncj), static_cast<int>(nci), inv}, c_(g_, col) {}

  __device__ float at(float row) {
    float v[1][1];
    c_.at(g_, row, v);
    return v[0][0];
  }

 private:
  CoarseFields<1> g_;
  FieldCols<1, 1> c_;
};

// True on every thread of the block when any of the rows x width values of
// the staged window s (row stride sw) is not finite.  A block barrier.
template <typename V>
__device__ __forceinline__ bool window_has_nonfinite(const V* s, int sw,
                                                    int rows, int width) {
  int bad = 0;
  for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
    const int r = e / width;
    bad |= !isfinite(s[r * sw + (e - r * width)]);
  }
  return __syncthreads_or(bad) != 0;
}

// Launch helper: allow *bytes* of dynamic shared memory for *kernel*
// (needed above 48 KB).
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace xrt
