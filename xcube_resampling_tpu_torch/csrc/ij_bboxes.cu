// K10: the tile plan's bbox scan, the pixel bboxes of a swath's coordinate
// images that fall inside the tiles of a regular target.
//
// Replaces the XLA kernel of xcube_resampling_tpu/ops/bbox_ops.py:
// compute_ij_bboxes_jax (:16-58), and computes what the JAX package's host
// scan computes (gridmapping/bboxes.py:compute_ij_bboxes, called by
// GridMapping.ij_bboxes_from_xy_bboxes): for every tile k, the least and
// the greatest column i and row j of the swath pixels with
//   x_lo[k] <= x <= x_hi[k]  and  y_lo[k] <= y <= y_hi[k]
// in float64, the bounds grown by the border on the host exactly as the
// host scan grows them; the stops exclusive, grown by ij_border and clipped
// to the image; a row of -1 where no pixel counts.  NaN coordinates never
// count (every comparison with NaN is false).
//
// The tiles are those of a regular grid: each tile's x bounds are its
// column's and its y bounds its row's.  The wrapper hands the kernel the
// columns' and the rows' bounds, each sorted so that both the low and the
// high bounds ascend (it refuses tiles that are no such lattice), packed
// with their orders in one buffer.  A pixel finds its candidate columns by
// two binary searches: the columns whose low bound is at most x end at
// upper_bound(x_lo, x), those whose high bound is at least x start at
// lower_bound(x_hi, x); every column in between passes both float64
// comparisons, and no other does.  The same for rows.  So a pixel visits
// only the tiles that take it, however wide the border.
//
// Bound on the H100: device memory.  The work must read the two float64
// coordinate images once, 16 bytes a pixel, at 3.35 TB/s (R3's 4865 x 4091
// swath: 318 MB, 0.095 ms); the lattice and the (n, 4) boxes are small.
// At R1 (1189 x 1890) the 36 MB swath was just uploaded and may still sit
// in the 50 MB L2, so the kernel can read it faster than the HBM bound
// there; R3 is the honest test of the bound.  What each choice does about
// it:
//
// * One device operation a call: no memset, no upload, no finishing
//   launch.  Each block merges its tiles into a global table of int32
//   (min i, min j, max i, max j) with atomics, fences, and takes a ticket;
//   the block that takes the last ticket turns the table into the int64
//   boxes, restores the table to its initial values and resets the
//   ticket.  A cooperative launch (init, grid sync, scan, grid sync,
//   write) would need no persistent table, but pays two grid-wide
//   barriers a call, each a round trip through device memory by every
//   block, and must fit its whole grid on the card at once; the
//   last-block reduction ends with one atomic a block, and its finish
//   costs under 1 us at R1.  Its price is the table (16 bytes a tile and
//   the ticket), which persists across calls: the wrapper allocates and
//   initialises it once per device, stream and tile count (the calls of
//   one stream run in order, so none sees another's table half merged).
//   Min and max do not depend on the order of the atomics: the result is
//   deterministic.
// * The grid is one wave (the SMs times the blocks an SM holds at the
//   kernel's registers and shared memory), so no block runs a second
//   round while others idle.  The flat range of h * w pixels is split
//   evenly over the grid's warps, not by rows; a warp walks its range 64
//   pixels a step, lane l on pixels 2l and 2l + 1 of the step, and every
//   lane carries its (i, j) along by the step instead of dividing.
// * Loads: each warp streams its range through kStages slots of shared
//   memory with cp.async, 16-byte copies (two pixels of x, two of y) a
//   lane, kStages - 1 steps ahead of the step it scans, so its copies stay
//   in flight while it searches, and no register holds them.  Each lane
//   reads back only what it copied: no barrier.  The alignment comes from
//   the pointers: where x lies 8 bytes off a 16-byte boundary, its first
//   pixel is peeled (it and an odd last pixel take a scalar path); y is
//   copied 16 bytes at a time where its pairs then align too, else 8 (R3:
//   swath[1] starts 8 bytes off, as h * w is odd).  The copies go through
//   L1 (.ca): 1-5% faster than L2 only (.cg) at R1 and R3.
// * The sub-lattice's bounds are staged in shared memory once a block,
//   beside the block's table, with each bound's float64 neighbour (below a
//   low bound, above a high one), which the wrapper packs; the searches
//   read them there.
// * Fast path: a warp keeps one running set of tiles T (the tiles of a
//   pixel: a range of columns by a range of rows, the same in every lane)
//   as one closed float64 interval an axis, and each lane a running box in
//   T.  A pixel inside both intervals lies in exactly the tiles of T: it
//   updates the lane's box in registers, with four comparisons, no search
//   and no atomic.  Tiles are 512-1024 pixels and the grown border a few,
//   so almost every pixel takes this path.  The others search; T follows
//   the last lane whose pixel lies in some tile, the lanes whose pixels
//   lie in exactly T join their boxes, and the rest reduce their boxes
//   across the warp by set of tiles (__match_any_sync, __reduce_*), one
//   lane merging them into the block's table; the warp's boxes in the old
//   T are reduced and merged once.
// * Registers: 54, no spill (ptxas), so four blocks of 256 threads fit an
//   SM; the cap (kMinBlocks) leaves them at most 64.
// * A lattice whose sub-lattice would outgrow kMaxTiles tiles (a 16 KB
//   table) is cut into sub-lattices, scanned one after the other inside
//   the same launch, each a full pass over the swath: correct, not fast.
//   No rectify cell of the main path has more than 30 tiles.
//
// Measured on an H100 SXM (80 GB HBM3, 700 W) with tools/tune_ij_bboxes.py:
// R1 0.0284 ms and R3 0.1201 ms of device time (1.26x the bound; two
// torch.sum reads of the same bytes take 0.1169); the loads alone take
// 0.0104 and 0.1090 ms, so at R1 the per-pixel logic holds most of the
// rest: each warp walks only about 8 steps there, and its first step and
// its tile crossings and row wraps (a third of its steps) search.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;      // a warp's copies in flight: kStages - 1 steps ahead
constexpr int kMinBlocks = 4;   // __launch_bounds__'s blocks an SM: at most 64 registers
constexpr int kNone = 0x7FFFFFFF;
constexpr int kMaxTiles = 1024; // a sub-lattice's tiles: a 16 KB table in shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kNoKey = ~0ULL;
constexpr int kStep = 64;       // pixels a warp covers a step: two a lane
constexpr int kStageDoubles = 2 * kStep;  // a stage: 64 x, then 64 y

struct Args {
  const double* x;  // (h, w) swath x
  const double* y;  // (h, w) swath y
  int w;
  int64_t p0;       // the first paired pixel: 1 where x lies 8 bytes off 16
  int64_t pairs;    // pixel pairs (p0 + 2q, p0 + 2q + 1), x 16-byte aligned
  int64_t tail;     // the odd last pixel, or -1
  int di, dj;       // kStep pixels on: di columns and dj rows
  const double* lat;  // the columns' lo, hi, below, above (nc each), the rows' (nr each)
  const int* perm;    // col_of[nc], row_of[nr]: sorted position -> lattice index
  int nc, nr, c_step, r_step;
  int* table;       // (nc * nr, 4) min i, min j, max i, max j, then the ticket
  int64_t* out;     // (nc * nr, 4) i0, j0, i1, j1
  int64_t h;
  int border;
};

// one sub-lattice in shared memory: its columns' and rows' bounds (lo, hi,
// below, above: cc and rc each) and its table
struct Sub {
  const double* col;
  const double* row;
  int* table;  // (cc * rc, 4), tile r * cc + c
  int cc, rc;
};

// the warp's running set of tiles (the same in every lane, packed as
// tiles_of packs it): the closed x and y intervals of the pixels whose
// tiles are exactly these; and this lane's box in them
struct Running {
  unsigned long long key;
  double xa, xb, ya, yb;
  int i0, j0, i1, j1;
};

__device__ __forceinline__ void cp_async16(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the first position in a[0, n) with a[p] >= v (lo = true) or a[p] > v
__device__ __forceinline__ int bound_search(const double* a, int n, double v, bool lo) {
  int first = 0;
  while (n > 0) {
    const int half = n >> 1;
    const double m = a[first + half];
    if (lo ? (m < v) : (m <= v)) {
      first += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return first;
}

__device__ __forceinline__ void merge(int* s, int t, int i0, int j0, int i1, int j1) {
  atomicMin(s + 4 * t, i0);
  atomicMin(s + 4 * t + 1, j0);
  atomicMax(s + 4 * t + 2, i1);
  atomicMax(s + 4 * t + 3, j1);
}

// the tiles of the sub-lattice that take (x, y), packed as c0, c1, r0, r1
// (11 bits each: cc, rc <= kMaxTiles), or kNoKey
__device__ __forceinline__ unsigned long long tiles_of(const Sub& s, double x, double y) {
  if (isnan(x) || isnan(y)) return kNoKey;
  const unsigned long long r0 = bound_search(s.row + s.rc, s.rc, y, true);
  const unsigned long long r1 = bound_search(s.row, s.rc, y, false);
  if (r0 >= r1) return kNoKey;
  const unsigned long long c0 = bound_search(s.col + s.cc, s.cc, x, true);
  const unsigned long long c1 = bound_search(s.col, s.cc, x, false);
  if (c0 >= c1) return kNoKey;
  return c0 | (c1 << 11) | (r0 << 22) | (r1 << 33);
}

__device__ __forceinline__ void merge_key(const Sub& s, unsigned long long key, int i0, int j0,
                                          int i1, int j1) {
  const int c0 = key & 0x7FF, c1 = (key >> 11) & 0x7FF;
  const int r0 = (key >> 22) & 0x7FF, r1 = (key >> 33) & 0x7FF;
  for (int r = r0; r < r1; ++r) {
    for (int c = c0; c < c1; ++c) merge(s.table, r * s.cc + c, i0, j0, i1, j1);
  }
}

// The closed interval of the values v whose columns (or rows) of the n of
// the sub-lattice are exactly [k0, k1), from the axis's lo, hi, below and
// above (n each): lo[k1 - 1] <= v <= hi[k0] (the bounds ascend), v >
// hi[k0 - 1], i.e. v >= above[k0 - 1] (the next float64), and v < lo[k1],
// i.e. v <= below[k1].  A NaN neighbour (an infinite bound's) lets no value
// in.
__device__ __forceinline__ void exactly(const double* v, int n, int k0, int k1, double& a,
                                        double& b) {
  a = v[k1 - 1];
  b = v[n + k0];
  if (k0 > 0) {
    const double e = v[3 * n + k0 - 1];
    a = isnan(e) ? e : fmax(a, e);
  }
  if (k1 < n) {
    const double e = v[2 * n + k1];
    b = isnan(e) ? e : fmin(b, e);
  }
}

// the warp's boxes in its running tiles, reduced and merged by lane 0;
// warp-collective
__device__ __forceinline__ void flush(const Sub& s, Running& r, int lane) {
  const int i0 = __reduce_min_sync(kFull, r.i0), j0 = __reduce_min_sync(kFull, r.j0);
  const int i1 = __reduce_max_sync(kFull, r.i1), j1 = __reduce_max_sync(kFull, r.j1);
  if (lane == 0 && i1 >= 0) merge_key(s, r.key, i0, j0, i1, j1);
  r.i0 = r.j0 = kNone;
  r.i1 = r.j1 = -1;
}

// one pixel a lane (x NaN where the lane has none); warp-collective
__device__ __forceinline__ void visit(const Sub& s, Running& r, double x, double y, int i,
                                      int j, int lane) {
  if (x >= r.xa && x <= r.xb && y >= r.ya && y <= r.yb) {
    r.i0 = min(r.i0, i);
    r.j0 = min(r.j0, j);
    r.i1 = max(r.i1, i);
    r.j1 = max(r.j1, j);
    x = NAN;  // done: no search
  }
  unsigned long long key = tiles_of(s, x, y);
  const unsigned some = __ballot_sync(kFull, key != kNoKey);
  if (some == 0) return;
  // the running tiles follow the last lane whose pixel lies in some; the
  // pixels in exactly those join the lanes' boxes
  const unsigned long long next = __shfl_sync(kFull, key, 31 - __clz(some));
  if (next != r.key) {
    if (r.key != kNoKey) flush(s, r, lane);
    r.key = next;
    exactly(s.col, s.cc, next & 0x7FF, (next >> 11) & 0x7FF, r.xa, r.xb);
    exactly(s.row, s.rc, (next >> 22) & 0x7FF, (next >> 33) & 0x7FF, r.ya, r.yb);
  }
  if (key == next) {
    r.i0 = min(r.i0, i);
    r.j0 = min(r.j0, j);
    r.i1 = max(r.i1, i);
    r.j1 = max(r.j1, j);
    key = kNoKey;
  }
  // the others: the lanes of one set of tiles reduce their pixels, one of
  // them merges
  const unsigned rest = __ballot_sync(kFull, key != kNoKey);
  if (key != kNoKey) {
    const unsigned grp = __match_any_sync(rest, key);
    const int i0 = __reduce_min_sync(grp, i), j0 = __reduce_min_sync(grp, j);
    const int i1 = __reduce_max_sync(grp, i), j1 = __reduce_max_sync(grp, j);
    if (lane == __ffs(grp) - 1) merge_key(s, key, i0, j0, i1, j1);
  }
}

// the copies of the warp's step *step* (pairs q_lo + 32 step + lane) into
// its stage slot, one commit group a step, also where the lane has none
template <bool kYPairs>
__device__ __forceinline__ void fetch(const Args& a, double* stage, int64_t q_lo, int n_q,
                                      int step, int lane) {
  const int q = 32 * step + lane;
  if (q < n_q) {
    const int64_t p = a.p0 + 2 * (q_lo + q);
    double* slot = stage + (step % kStages) * kStageDoubles + 2 * lane;
    cp_async16(slot, a.x + p);
    if (kYPairs) {
      cp_async16(slot + kStep, a.y + p);
    } else {
      cp_async8(slot + kStep, a.y + p);
      cp_async8(slot + kStep + 1, a.y + p + 1);
    }
  }
  cp_async_commit();
}

template <bool kYPairs>
__global__ void __launch_bounds__(kThreads, kMinBlocks) scan_kernel(const Args a) {
  // each warp's kStages stage slots, then the sub-lattice's bounds (4 c_step
  // + 4 r_step doubles), then its table (c_step * r_step * 4 int32)
  extern __shared__ __align__(16) double smem[];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t q_lo = a.pairs * warp / warps;
  const int n_q = static_cast<int>(a.pairs * (warp + 1) / warps - q_lo);
  const int steps = (n_q + 31) / 32;
  double* stage = smem + (threadIdx.x >> 5) * kStages * kStageDoubles;
  double* bounds = smem + kWarps * kStages * kStageDoubles;
  // this lane's first pixel
  const int64_t p_first = a.p0 + 2 * (q_lo + lane);
  const int j_first = static_cast<int>(p_first / a.w);
  const int i_first = static_cast<int>(p_first - static_cast<int64_t>(j_first) * a.w);

  for (int rb = 0; rb < a.nr; rb += a.r_step) {
    for (int cb = 0; cb < a.nc; cb += a.c_step) {
      // start the warp's copies; they need no barrier, each lane reads
      // back only what it copied
      for (int k = 0; k < kStages - 1; ++k) fetch<kYPairs>(a, stage, q_lo, n_q, k, lane);
      Sub s;
      s.cc = min(a.c_step, a.nc - cb);
      s.rc = min(a.r_step, a.nr - rb);
      s.col = bounds;
      s.row = bounds + 4 * s.cc;
      s.table = reinterpret_cast<int*>(bounds + 4 * (a.c_step + a.r_step));
      for (int t = threadIdx.x; t < 4 * s.cc; t += kThreads) {
        bounds[t] = a.lat[(t / s.cc) * a.nc + cb + t % s.cc];
      }
      for (int t = threadIdx.x; t < 4 * s.rc; t += kThreads) {
        bounds[4 * s.cc + t] = a.lat[4 * a.nc + (t / s.rc) * a.nr + rb + t % s.rc];
      }
      const int n_sub = s.cc * s.rc;
      for (int t = threadIdx.x; t < n_sub; t += kThreads) {
        reinterpret_cast<int4*>(s.table)[t] = make_int4(kNone, kNone, -1, -1);
      }
      __syncthreads();

      // the pixels outside the pairs: the peeled first and the odd last
      if (blockIdx.x == 0 && threadIdx.x < 2) {
        const int64_t p = threadIdx.x == 0 ? (a.p0 ? 0 : -1) : a.tail;
        if (p >= 0) {
          const unsigned long long key = tiles_of(s, a.x[p], a.y[p]);
          const int i = static_cast<int>(p % a.w), j = static_cast<int>(p / a.w);
          if (key != kNoKey) merge_key(s, key, i, j, i, j);
        }
      }

      Running r;
      r.key = kNoKey;
      r.xa = r.xb = r.ya = r.yb = NAN;
      r.i0 = r.j0 = kNone;
      r.i1 = r.j1 = -1;
      int i = i_first, j = j_first;
      // every lane of the warp runs the same steps: the warp-collective
      // visits see all 32 lanes
      for (int step = 0; step < steps; ++step) {
        fetch<kYPairs>(a, stage, q_lo, n_q, step + kStages - 1, lane);
        cp_async_wait<kStages - 1>();
        double2 xv = make_double2(NAN, NAN), yv = xv;
        if (32 * step + lane < n_q) {
          const double* slot = stage + (step % kStages) * kStageDoubles + 2 * lane;
          xv = *reinterpret_cast<const double2*>(slot);
          yv = *reinterpret_cast<const double2*>(slot + kStep);
        }
        visit(s, r, xv.x, yv.x, i, j, lane);
        const bool wraps = i + 1 == a.w;
        visit(s, r, xv.y, yv.y, wraps ? 0 : i + 1, wraps ? j + 1 : j, lane);
        i += a.di;
        j += a.dj;
        if (i >= a.w) {
          i -= a.w;
          ++j;
        }
      }
      cp_async_wait<0>();
      if (r.key != kNoKey) flush(s, r, lane);
      __syncthreads();

      // the block's tiles into the global table
      for (int t = threadIdx.x; t < n_sub; t += kThreads) {
        const int4 v = reinterpret_cast<const int4*>(s.table)[t];
        if (v.z < 0) continue;
        const int row = a.perm[a.nc + rb + t / s.cc];
        const int k = row * a.nc + a.perm[cb + t % s.cc];
        merge(a.table, k, v.x, v.y, v.z, v.w);
      }
      __syncthreads();
    }
  }

  // the last block to finish writes the boxes and restores the table
  const int n = a.nc * a.nr;
  unsigned* ticket = reinterpret_cast<unsigned*>(a.table + 4 * n);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    int4* cell = reinterpret_cast<int4*>(a.table) + k;
    const int4 v = __ldcg(cell);
    __stcg(cell, make_int4(kNone, kNone, -1, -1));
    int64_t* o = a.out + 4 * static_cast<int64_t>(k);
    if (v.z < 0) {
      o[0] = o[1] = o[2] = o[3] = -1;
      continue;
    }
    const int64_t i0 = v.x - a.border, j0 = v.y - a.border;
    const int64_t i1 = v.z + 1 + a.border, j1 = v.w + 1 + a.border;
    o[0] = i0 < 0 ? 0 : i0;
    o[1] = j0 < 0 ? 0 : j0;
    o[2] = i1 > a.w ? a.w : i1;
    o[3] = j1 > a.h ? a.h : j1;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// one wave of *kernel* at *smem* bytes of dynamic shared memory on the
// current device (the shared memory allowed first), remembered for the
// last device, kernel and size asked
int wave(const void* kernel, size_t smem, int* blocks) {
  thread_local int last_dev = -1, last_blocks = 0;
  thread_local const void* last_kernel = nullptr;
  thread_local size_t last_smem = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev != last_dev || kernel != last_kernel || smem != last_smem) {
    int sms = 0, per_sm = 0;
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess) {
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
    last_dev = dev;
    last_kernel = kernel;
    last_smem = smem;
    last_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = last_blocks;
  return 0;
}

}  // namespace

// x, y (h, w) float64, each 8-byte aligned; lattice: float64 col_lo[nc],
// col_hi[nc] (each sorted ascending), col_below[nc] (each lo's float64
// below, NaN for -inf), col_above[nc] (each hi's above, NaN for +inf), the
// same four for the rows (nr each), then int32 col_of[nc], row_of[nr]
// (sorted position -> lattice column or row);
// table (nc * nr + 1, 4) int32, rows (0x7FFFFFFF, 0x7FFFFFFF, -1, -1) and
// a last row of 0, as the kernel leaves it; out (nc * nr, 4) int64,
// row-major over the lattice's tiles (row, then column).  Queues one
// launch on *stream* and writes to *queued* the device operations it
// queued.
extern "C" int xrt_ij_bboxes(const double* x, const double* y, int64_t h, int64_t w,
                             const void* lattice, int64_t nc, int64_t nr, int64_t border,
                             int* table, int64_t* out, int* queued, void* stream) {
  *queued = 0;
  if (h < 1 || w < 1 || h >= kNone || w >= kNone || h * w >= (1LL << 40) || nc < 1 ||
      nr < 1 || nc * nr >= (1LL << 30) || border < 0 || border >= kNone ||
      (reinterpret_cast<uintptr_t>(x) & 7) || (reinterpret_cast<uintptr_t>(y) & 7)) {
    return 1;  // cudaErrorInvalidValue
  }
  const int64_t n_px = h * w;
  const int64_t x_off = (reinterpret_cast<uintptr_t>(x) >> 3) & 1;
  const bool y_pairs = ((reinterpret_cast<uintptr_t>(y) >> 3) & 1) == x_off;
  const int64_t p0 = x_off < n_px ? x_off : n_px;
  const int64_t pairs = (n_px - p0) / 2;
  const int c_step = static_cast<int>(nc < kMaxTiles ? nc : kMaxTiles);
  const int r_step = static_cast<int>(nr < kMaxTiles / c_step ? nr : kMaxTiles / c_step);
  const auto* lat = static_cast<const double*>(lattice);
  Args a{x, y, static_cast<int>(w), p0, pairs, (n_px - p0) % 2 ? n_px - 1 : -1,
         static_cast<int>(kStep % w), static_cast<int>(kStep / w), lat,
         reinterpret_cast<const int*>(lat + 4 * (nc + nr)), static_cast<int>(nc),
         static_cast<int>(nr), c_step, r_step, table, out, h, static_cast<int>(border)};
  const size_t smem = sizeof(double) * (kWarps * kStages * kStageDoubles) +
                      sizeof(double) * 4 * (c_step + r_step) + sizeof(int4) * c_step * r_step;
  const void* kernel = y_pairs ? reinterpret_cast<const void*>(&scan_kernel<true>)
                               : reinterpret_cast<const void*>(&scan_kernel<false>);
  int blocks = 0;
  const int rc = wave(kernel, smem, &blocks);
  if (rc) return rc;
  // no warp without a step of pairs to walk (a warp's range is about
  // pairs / warps); at least one block, which also takes the scalar
  // pixels and the finish
  const int64_t need = (pairs + kThreads - 1) / kThreads;
  if (need < blocks) blocks = static_cast<int>(need > 0 ? need : 1);
  const auto s = static_cast<cudaStream_t>(stream);
  if (y_pairs) {
    scan_kernel<true><<<blocks, kThreads, smem, s>>>(a);
  } else {
    scan_kernel<false><<<blocks, kThreads, smem, s>>>(a);
  }
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) *queued = 1;
  return static_cast<int>(launched);
}
