// K16: the exact region mosaic, one launch over every piece.
//
// Replaces the XLA programs of xcube_resampling_tpu/ops/esw.py:
// make_esw_region_fn (:1128-1922): the ESW group bodies (make_group_body,
// :1734-1795, each piece the ESW kernel of _get_impls, :616-876), the
// gather group bodies and single pieces (:1797-1858, with
// reproject_ops.py's make_gather_piece_fn :184-262 and
// make_gather_piece_kernel_dyn :265-325), which the JAX package runs as a
// dozen jitted bucket programs, each writing its pieces into the canvas.
// The TPU needs those programs because its gathers serialise and its
// compiles are long; here one launch covers every piece.
//
// The piece table (ops/esw_mosaic.py: pack_pieces) gives each piece its
// kind, target origin (r0, c0) and size (h, w), source window (j_off,
// i_off, wh, ww), sample count S and the offsets of its coarse fields
// (ix_c, iy_c, and iystar_c for an ESW piece) in one packed float32
// buffer.  A piece is cut into tiles of kTileRows x kTileCols target
// pixels; tile_start, the prefix sum of the pieces' tile counts, maps each
// block to its piece (a binary search) and its tile.  Every pixel of a
// tile is computed as follows, and written into the canvas at
// (r0 + r, c0 + c) with the canvas's row stride:
//   * an ESW piece runs K13's per-pixel function (esw_pixel.h, shared with
//     K13 and its band form): positions from the piece's fields in global
//     source indices, the window offsets taken off after floor/rint, the
//     anchors from its window-relative iystar_c, rows clipped to the
//     window; the whole source is read in place through the window's
//     origin, with the source's row stride (no crop copy);
//   * a gather piece runs K3's taps (gather_taps.h) in global source
//     indices on the whole source: the JAX package takes the window offset
//     off the integer taps after floor/rint and reads its window, which
//     holds every tap of a valid pixel (the planner asserts it), so the
//     same values are read.
// Rounding as in K13 and K3: fused multiply-adds where XLA contracts, the
// library built with -fmad=false.
//
// Bound on the H100: device memory, as K3's and K13's: it must write
// every pixel of its pieces once and read the source pixels their taps
// reach; the coarse fields are small (0.8 MB at BASELINE #3) and stay in
// L1 and L2.
// Design: a block is K13's staged block (kWarpCols threads across, kLanes
// down, a thread kVec consecutive columns of the tile's rows kLanes apart;
// at most 80 registers so that 12 blocks fit an SM, 96 and 10 for
// nearest); the kind is the block's, so no warp diverges on it.  An ESW
// piece's tile stages its anchors as K13's does (esw_pixel.h's
// staged_tile: the span bounded from the piece's ix_c, the anchors of
// every (tile row, span column) once into shared memory, stage_limit
// columns; a wider span runs the per-pixel body, as every ESW tile does
// when the C entry is asked for no stage).  A gather piece's tile runs
// K3's taps.  Offsets inside a plane are 32-bit and unsigned (the wrapper
// refuses planes of 2^31 elements or more), band offsets 64-bit.
#include "esw_pixel.h"

namespace {

using xrt::esw::kStageCols;
using xrt::esw::kTileRows;
using xrt::esw::kVec;

constexpr int kWarpCols = 32;  // threads across a tile
constexpr int kLanes = 2;      // threads down a tile
// blocks an SM: at most 80 registers; nearest's staged kernel spills 4 B
// there, so 10 (96) for nearest
constexpr int kMinBlocks = 12;
constexpr int kMinBlocksNearest = 10;
constexpr int kTileCols = kVec * kWarpCols;

// the piece table's columns and the kinds of piece (ops/esw_mosaic.py)
enum Col : int {
  kKind, kR0, kC0, kH, kW, kJOff, kIOff, kWh, kWw, kSamples, kNcj, kNci, kNcc, kOffIx,
  kOffIy, kOffYs, kCols
};
enum Kind : int { kEsw = 0, kGather = 1 };

struct MosaicArgs {
  const float* src;        // (batch, src_h, src_w): the whole source
  const int* table;        // (n, kCols)
  const int* tile_start;   // (n + 1)
  const float* fields;     // the packed coarse fields
  float* out;              // (batch, out_h, out_w): the canvas
  int n;
  int64_t batch;
  int src_h, src_w, out_h, out_w;
  float inv;  // 1 / step
  float fill;
  xrt::TapBounds tb;  // the whole source's bounds and clamp limits
  bool vec4;          // out_w % 4 == 0 and out 16-byte aligned
};

// The piece of tile t: the last p with tile_start[p] <= t.
__device__ __forceinline__ int piece_of(const MosaicArgs& m, int t) {
  int lo = 0;
  int hi = m.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(m.tile_start + mid) <= t) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// An ESW piece's arguments for K13's per-pixel function, its output at out.
__device__ __forceinline__ xrt::esw::Args esw_args(const MosaicArgs& m, const int* e, int method,
                                                   const xrt::CoarseFields<2>& field, float* out,
                                                   bool vec4) {
  const int j_off = __ldg(e + kJOff);
  const int i_off = __ldg(e + kIOff);
  const int wh = __ldg(e + kWh);
  const int s = __ldg(e + kSamples);
  xrt::esw::Args a{};
  a.src = m.src + static_cast<int64_t>(j_off) * m.src_w + i_off;
  a.iystar = m.fields + __ldg(e + kOffYs);
  a.out = out;
  a.field = field;
  a.ncc = __ldg(e + kNcc);
  a.batch = m.batch;
  a.src_h = wh;
  a.src_w = __ldg(e + kWw);
  a.pitch = m.src_w;
  a.src_plane = static_cast<int64_t>(m.src_h) * m.src_w;
  a.x_hi = m.tb.x_hi;
  a.y_hi = m.tb.y_hi;
  a.x_max = m.tb.x_max;
  a.y_max = m.tb.y_max;
  a.half = 0.5f * static_cast<float>(s - 2);
  a.s_max = static_cast<float>(method == xrt::kNearest ? s - 1 : s - 2);
  a.j_off = static_cast<float>(j_off);
  a.i_off = i_off;
  a.clip_h = wh;
  a.row_off = 0;
  a.out_h = __ldg(e + kH);
  a.out_w = __ldg(e + kW);
  a.out_pitch = m.out_w;
  a.out_plane = static_cast<int64_t>(m.out_h) * m.out_w;
  a.fill = m.fill;
  a.vec4 = vec4;
  a.row0 = 0;
  return a;
}

// A gather piece's rows [j0, j1) at kVec columns from i (n inside it):
// K3's pixel on the whole source.
template <int M>
__device__ __forceinline__ void gather_rows(const MosaicArgs& m,
                                            const xrt::CoarseFields<2>& field, float* out,
                                            bool vec4, int j0, int j1, int i, int n) {
  const int64_t src_plane = static_cast<int64_t>(m.src_h) * m.src_w;
  const int64_t out_plane = static_cast<int64_t>(m.out_h) * m.out_w;
  xrt::FieldCols<2, kVec> cols(field, static_cast<float>(i));
  for (int j = j0 + static_cast<int>(threadIdx.y); j < j1; j += kLanes) {
    float f[2][kVec];  // ix, iy
    cols.at(field, static_cast<float>(j), f);
    xrt::Taps t[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) t[c] = xrt::taps<M>(f[0][c], f[1][c], m.tb);
    for (int64_t b = 0; b < m.batch; ++b) {
      const float* p = m.src + b * src_plane;
      float v[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) v[c] = t[c].ok ? xrt::gather<M>(p, t[c]) : m.fill;
      float* o = out + b * out_plane + static_cast<int64_t>(j) * m.out_w + i;
      if (vec4 && n == kVec) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          if (c < n) o[c] = v[c];
        }
      }
    }
  }
}

// One block: one tile of one piece.  An ESW piece's tile stages its
// anchors in shared memory unless *staged* is 0 (esw_pixel.h's
// staged_tile).
template <int M>
__global__ void __launch_bounds__(kWarpCols * kLanes,
                                  M == xrt::kNearest ? kMinBlocksNearest : kMinBlocks)
    esw_mosaic_kernel(const MosaicArgs m, int staged) {
  __shared__ float stage[kTileRows * kStageCols];
  const int t = static_cast<int>(blockIdx.x);
  const int p = piece_of(m, t);
  const int* e = m.table + static_cast<int64_t>(p) * kCols;
  const int h = __ldg(e + kH);
  const int w = __ldg(e + kW);
  const int tiles_x = (w + kTileCols - 1) / kTileCols;
  const int local = t - __ldg(m.tile_start + p);
  const int tr = local / tiles_x;
  const int i = ((local - tr * tiles_x) * kWarpCols + static_cast<int>(threadIdx.x)) * kVec;
  const int n = w - i < kVec ? w - i : kVec;  // <= 0 past the piece's right edge
  const int j0 = tr * kTileRows;
  const int j1 = min(j0 + kTileRows, h);
  const xrt::CoarseFields<2> field{
      {m.fields + __ldg(e + kOffIx), m.fields + __ldg(e + kOffIy)},
      __ldg(e + kNcj), __ldg(e + kNci), m.inv};
  const int c0 = __ldg(e + kC0);
  float* out = m.out + static_cast<int64_t>(__ldg(e + kR0)) * m.out_w + c0;
  const bool vec4 = m.vec4 && c0 % kVec == 0;
  if (__ldg(e + kKind) == kGather) {
    if (i < w) gather_rows<M>(m, field, out, vec4, j0, j1, i, n);
    return;
  }
  const xrt::esw::Args a = esw_args(m, e, M, field, out, vec4);
  xrt::FieldCols<2, kVec> cols(a.field, static_cast<float>(i));
  const int i_last = min((local - tr * tiles_x + 1) * kTileCols, w) - 1;
  xrt::esw::staged_tile<M, kLanes, xrt::esw::Clip::kPlane>(a, cols, j0, j1, i, n, i_last,
                                                           stage, staged != 0, false);
}

}  // namespace

// K16: src is the whole source (batch, src_h, src_w); out the canvas
// (batch, out_h, out_w), which holds the fill where no piece lies; table
// (n_pieces, 16) and tile_start (n_pieces + 1) int32 and fields float32 as
// ops/esw_mosaic.py packs them, n_tiles = tile_start[n_pieces] blocks of
// tile_rows x tile_cols pixels (refused unless they are the kernel's);
// staged 1: each ESW tile stages its anchors where its span fits the
// stage; 0: every ESW tile runs the per-pixel body (the same bits).
extern "C" int xrt_esw_mosaic_f32(const float* src, const int* table, const int* tile_start,
                                  const float* fields, float* out, int64_t n_pieces,
                                  int64_t n_tiles, int64_t batch, int64_t src_h, int64_t src_w,
                                  int64_t out_h, int64_t out_w, int step, int method, float fill,
                                  int tile_rows, int tile_cols, int staged, void* stream) {
  constexpr int64_t kMaxPlane = (int64_t{1} << 31) - 1;
  if (src_h * src_w > kMaxPlane || out_h * out_w > kMaxPlane || n_pieces < 1 ||
      n_pieces > kMaxPlane || n_tiles < 1 || n_tiles > kMaxPlane || batch < 1 || step < 1 ||
      src_h < 1 || src_w < 1 || tile_rows != kTileRows || tile_cols != kTileCols || staged < 0 ||
      staged > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MosaicArgs m{};
  m.src = src;
  m.table = table;
  m.tile_start = tile_start;
  m.fields = fields;
  m.out = out;
  m.n = static_cast<int>(n_pieces);
  m.batch = batch;
  m.src_h = static_cast<int>(src_h);
  m.src_w = static_cast<int>(src_w);
  m.out_h = static_cast<int>(out_h);
  m.out_w = static_cast<int>(out_w);
  m.inv = static_cast<float>(1.0 / step);
  m.fill = fill;
  m.tb = xrt::tap_bounds(src_h, src_w);
  m.vec4 = out_w % kVec == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_tiles));
  const dim3 block(kWarpCols, kLanes);
  switch (method) {
    case xrt::kBilinear:
      esw_mosaic_kernel<xrt::kBilinear><<<grid, block, 0, s>>>(m, staged);
      break;
    case xrt::kNearest:
      esw_mosaic_kernel<xrt::kNearest><<<grid, block, 0, s>>>(m, staged);
      break;
    case xrt::kTriangular:
      esw_mosaic_kernel<xrt::kTriangular><<<grid, block, 0, s>>>(m, staged);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
