// Group-by aggregation: per-group sum / max / min of (n, C) float32 values
// by int32 group id (paper expressions 4 and 8, the model-UDF group-by).
//
// Replaces the Pallas TPU kernel repro/kernels/segment_agg.py:segment_agg,
// which forms a (G, BLOCK) one-hot matrix per tile and multiplies it on the
// MXU. On Hopper the one-hot product would spend G x more work than the
// data needs; the kernels instead stream the values once and reduce each
// into its cell (gid * C + column), in two kernels on the caller's stream:
//  - segment_agg_partial_kernel: a grid sized by the occupancy calculator
//    (every block resident at once). For C = 1 over 16-byte-aligned
//    operands with no tile list (the main path) the grid strides over the
//    rows in 16-byte groups, each thread with kFlat groups of gids and of
//    values in flight; otherwise it strides over the `tile`-row tiles, or
//    over a list of tile ids (static ids, or a -1-padded list whose pad
//    entries are skipped), full 2048-row tiles with 16-byte loads, ragged
//    ones (the last one, one cut by n_valid, another tile size, unaligned
//    operands) with 4-byte loads. Where 256 copies of the (G, C) cells fit
//    in shared memory (G * C <= 227), every lane of the block owns a
//    private copy, laid out cell-major with the lane minor so that the 32
//    lanes of a warp always hit 32 banks: an update is a plain load, add
//    (or max / min) and store, with no atomics and no conflicts. Otherwise,
//    up to 7,264 cells, each warp owns one copy, updated with shared
//    atomics. At the end the block folds its copies in a fixed order (no
//    shuffles) and writes its partial (G, C) to scratch the wrapper
//    allocates.
//  - segment_agg_merge_kernel: folds the partials cell by cell in block
//    order and writes every output cell, the identity (0 / -inf / +inf) in
//    an empty group. No global atomics and no fill launch.
// Past 7,264 cells the output is filled with the identity and the rows
// update it with global atomics instead (max / min through
// order-preserving integer atomics).
// Rows i >= min(n, n_valid) and group ids outside [0, G) are ignored.
//
// Precision: plain float32, no TF32. With lane-private copies every add
// happens in an order fixed by the data and the grid, so sums repeat bit
// for bit from run to run; sums of integer-valued data are exact while
// every partial stays below 2^24 (the planner's f32-exactness gate proves
// that), and sums of general data agree with any other order to float32
// rounding. Max and min are exact for every non-NaN value.
//
// Bound on the H100: bytes (values and gids read once; at the e4 shape,
// 5M rows, C = 1: 40 MB, 11.9 us at 3.35 TB/s); one reduction per value.
#include "common.cuh"

#include <math.h>

namespace {

enum { kSum = 0, kMax = 1, kMin = 2 };
enum { kLane = 0, kWarp = 1, kGlobal = 2 };  // where the cells live
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;                     // rows of a vector-read tile
constexpr int kQuads = kTile / 4 / kThreads;    // 16-byte loads per thread per tile
constexpr int kFlat = 8;                        // 16-byte groups in flight per thread
constexpr int kMaxSmem = 227 * 1024;            // opt-in shared memory per block
constexpr int kMergeWarps = 32;
// Resident blocks per SM the partial kernel can reach (2,048 threads over
// its 256-thread blocks): the scratch holds this many partials per SM, and
// the occupancy calculator picks the grid below it.
constexpr int kMaxBlocksPerSm = 2048 / kThreads;

template <int OP> __device__ __forceinline__ float identity() {
  return OP == kSum ? 0.f : (OP == kMax ? -INFINITY : INFINITY);
}

template <int OP> __device__ __forceinline__ float combine(float a, float b) {
  return OP == kSum ? a + b : (OP == kMax ? fmaxf(a, b) : fminf(a, b));
}

// Order-preserving float max/min through integer atomics: non-negative
// floats order like their int bits, negative floats in reverse of their
// unsigned bits. Exact for every non-NaN value, +-inf included.
template <int OP> __device__ __forceinline__ void atomic_combine(float* a, float v) {
  if (OP == kSum) {
    atomicAdd(a, v);
  } else if (OP == kMax) {
    if (!signbit(v)) atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
    else atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
  } else {
    if (!signbit(v)) atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
    else atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
  }
}

// acc: the lane's own copy (cell stride 32), the warp's copy, or the output.
template <int OP, int MODE>
__device__ __forceinline__ void update(float* acc, int g, int G, int C, int c,
                                       float v) {
  if (g < 0 || g >= G) return;
  const int cell = g * C + c;
  if (MODE == kLane) acc[cell * 32] = combine<OP>(acc[cell * 32], v);
  else atomic_combine<OP>(acc + cell, v);
}

template <int OP, int MODE>
__device__ __forceinline__ void update4(float* acc, int4 g, float4 v, int G) {
  update<OP, MODE>(acc, g.x, G, 1, 0, v.x);
  update<OP, MODE>(acc, g.y, G, 1, 0, v.y);
  update<OP, MODE>(acc, g.z, G, 1, 0, v.z);
  update<OP, MODE>(acc, g.w, G, 1, 0, v.w);
}

// Rows [base, end) with 4-byte loads.
template <int OP, int MODE>
__device__ __forceinline__ void ragged_tile(float* acc, const float* values,
                                            const int32_t* gids, int64_t base,
                                            int64_t end, int G, int C) {
  for (int64_t r = base + threadIdx.x; r < end; r += kThreads) {
    const int g = gids[r];
    for (int c = 0; c < C; ++c) update<OP, MODE>(acc, g, G, C, c, values[r * C + c]);
  }
}

// A full kTile-row tile, C > 1: its kTile * C values are read as float4s of
// the flat row-major block; value e is row e / C, column e % C, and its gid
// comes through the read-only cache.
template <int OP, int MODE>
__device__ __forceinline__ void full_tile_cn(float* acc, const float* values,
                                             const int32_t* gids, int64_t base,
                                             int G, int C) {
  const float4* v4 = reinterpret_cast<const float4*>(values + base * C);
  for (int f0 = 0; f0 < kQuads * C * kThreads; f0 += kQuads * kThreads) {
    float4 v[kQuads];
#pragma unroll
    for (int u = 0; u < kQuads; ++u) v[u] = __ldg(v4 + f0 + u * kThreads + threadIdx.x);
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int f = f0 + u * kThreads + threadIdx.x;
      const float vals[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * f + j, r = e / C;
        update<OP, MODE>(acc, __ldg(gids + base + r), G, C, e - r * C, vals[j]);
      }
    }
  }
}

// The rows tile `j` of the pass covers: [base, end), empty for a pad id.
__device__ __forceinline__ void tile_rows(const int32_t* tile_ids, int j,
                                          int tile, int64_t stop,
                                          int64_t& base, int64_t& end) {
  const int64_t t = tile_ids ? static_cast<int64_t>(tile_ids[j]) : j;
  base = t * tile;
  end = t < 0 ? base : imin(base + tile, stop);
}

// A tile of the pass: its rows [base, end) and, for a full C = 1 tile, its
// gids and values in registers.
struct Tile {
  int64_t base, end;
  bool full;
  int4 g[kQuads];
  float4 v[kQuads];
};

// Tile j of the pass: a full C = 1 tile's gids and values are read with
// 16-byte loads.
template <bool C1>
__device__ __forceinline__ void load_tile(Tile& t, const float* values,
                                          const int32_t* gids,
                                          const int32_t* tile_ids, int j,
                                          int tile, int64_t stop,
                                          bool vec_tiles) {
  tile_rows(tile_ids, j, tile, stop, t.base, t.end);
  t.full = vec_tiles && t.end - t.base == kTile;
  if (C1 && t.full) {
    const int4* g4 = reinterpret_cast<const int4*>(gids + t.base);
    const float4* v4 = reinterpret_cast<const float4*>(values + t.base);
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      t.g[u] = __ldg(g4 + u * kThreads + threadIdx.x);
      t.v[u] = __ldg(v4 + u * kThreads + threadIdx.x);
    }
  }
}

template <int OP, int MODE, bool C1>
__device__ __forceinline__ void reduce_tile(float* acc, const Tile& t,
                                            const float* values,
                                            const int32_t* gids, int G, int C) {
  if (t.full) {
    if (C1) {
#pragma unroll
      for (int u = 0; u < kQuads; ++u) update4<OP, MODE>(acc, t.g[u], t.v[u], G);
    } else {
      full_tile_cn<OP, MODE>(acc, values, gids, t.base, G, C);
    }
  } else if (t.end > t.base) {
    ragged_tile<OP, MODE>(acc, values, gids, t.base, t.end, G, C);
  }
}

// The rows [0, stop) of 16-byte-aligned C = 1 operands, spread over the
// whole grid: thread i takes 16-byte groups i, i + grid * kThreads, ...,
// kFlat of them (gids and values) in flight at once; block 0 takes the
// last stop % 4 rows.
template <int OP, int MODE>
__device__ __forceinline__ void flat_rows(float* acc, const float* values,
                                          const int32_t* gids, int64_t stop,
                                          int G) {
  const int4* g4 = reinterpret_cast<const int4*>(gids);
  const float4* v4 = reinterpret_cast<const float4*>(values);
  const int64_t quads = stop / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; q + (kFlat - 1) * stride < quads; q += kFlat * stride) {
    int4 g[kFlat];
    float4 v[kFlat];
#pragma unroll
    for (int u = 0; u < kFlat; ++u) {
      g[u] = __ldg(g4 + q + u * stride);
      v[u] = __ldg(v4 + q + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kFlat; ++u) update4<OP, MODE>(acc, g[u], v[u], G);
  }
  for (; q < quads; q += stride) update4<OP, MODE>(acc, __ldg(g4 + q), __ldg(v4 + q), G);
  if (blockIdx.x == 0 && threadIdx.x < stop - 4 * quads) {
    const int64_t r = 4 * quads + threadIdx.x;
    update<OP, MODE>(acc, gids[r], G, 1, 0, values[r]);
  }
}

// MODE kLane / kWarp: dst is the (gridDim.x, G * C) partials; kGlobal: dst
// is the output, already filled with the identity.
template <int OP, int MODE, bool C1>
__global__ void __launch_bounds__(kThreads)
segment_agg_partial_kernel(const float* __restrict__ values, int C,
                           const int32_t* __restrict__ gids, int64_t n,
                           int64_t n_valid, int G,
                           const int32_t* __restrict__ tile_ids, int n_tiles,
                           int tile, int vec, float* __restrict__ dst) {
  extern __shared__ float hist[];
  const int cells = G * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* acc = dst;
  if (MODE != kGlobal) {
    const int copies = MODE == kLane ? kThreads : kWarps;
    for (int i = threadIdx.x; i < copies * cells; i += kThreads)
      hist[i] = identity<OP>();
    __syncthreads();
    acc = MODE == kLane ? hist + warp * cells * 32 + lane : hist + warp * cells;
  }
  const int64_t stop = imin(n, n_valid);
  if (C1 && vec && !tile_ids) {
    flat_rows<OP, MODE>(acc, values, gids, stop, G);
  } else {
    for (int j = blockIdx.x; j < n_tiles; j += gridDim.x) {
      Tile t;
      load_tile<C1>(t, values, gids, tile_ids, j, tile, stop, vec && tile == kTile);
      reduce_tile<OP, MODE, C1>(acc, t, values, gids, G, C);
    }
  }
  if (MODE == kGlobal) return;
  __syncthreads();
  float* part = dst + static_cast<int64_t>(blockIdx.x) * cells;
  if (MODE == kWarp) {
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      float a = hist[i];
      for (int w = 1; w < kWarps; ++w) a = combine<OP>(a, hist[w * cells + i]);
      part[i] = a;
    }
    return;
  }
  // kLane, with no shuffles: each lane folds the kWarps warps' copies of
  // its cells into warp 0's (lanes apart: no bank conflicts), then thread i
  // folds cell i's 32 lanes, from lane i mod 32 on, so that the 32 threads
  // of a warp read 32 banks.
  for (int i = warp; i < cells; i += kWarps) {
    float a = hist[i * 32 + lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a = combine<OP>(a, hist[(w * cells + i) * 32 + lane]);
    hist[i * 32 + lane] = a;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    float a = identity<OP>();
#pragma unroll 8
    for (int k = 0; k < 32; ++k) a = combine<OP>(a, hist[i * 32 + ((k + i) & 31)]);
    part[i] = a;
  }
}

// out[cell] = the fold of partials[0..P)[cell] in block order. A block
// takes 32 cells; warp w folds partials w, w + 32, ...; warp 0 folds the
// 32 warps' results in order.
template <int OP>
__global__ void __launch_bounds__(kMergeWarps * 32)
segment_agg_merge_kernel(const float* __restrict__ partials, int P, int cells,
                         float* __restrict__ out) {
  __shared__ float red[kMergeWarps][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int cell = blockIdx.x * 32 + lane;
  float a = identity<OP>();
  if (cell < cells)
    for (int p = w; p < P; p += kMergeWarps)
      a = combine<OP>(a, partials[static_cast<int64_t>(p) * cells + cell]);
  red[w][lane] = a;
  __syncthreads();
  if (w == 0 && cell < cells) {
    for (int i = 1; i < kMergeWarps; ++i) a = combine<OP>(a, red[i][lane]);
    out[cell] = a;
  }
}

template <int OP>
__global__ void fill_kernel(float* __restrict__ out, int64_t cells) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < cells) out[i] = identity<OP>();
}

// The largest grid launch() takes: the scratch the wrapper allocates holds
// this many (G, C) partials where the cells live in shared memory.
int max_grid_of(int n_tiles, int sms) {
  const int resident = kMaxBlocksPerSm * sms;
  return n_tiles < resident ? n_tiles : resident;
}

template <int OP, int MODE, bool C1>
int launch(const float* values, int C, const int32_t* gids, int64_t n,
           int64_t n_valid, int G, const int32_t* tile_ids, int n_tiles,
           int tile, int sms, float* scratch, float* out,
           cudaStream_t stream) {
  const int64_t cells = static_cast<int64_t>(G) * C;
  const int copies = MODE == kLane ? kThreads : (MODE == kWarp ? kWarps : 0);
  const int smem = static_cast<int>(copies * cells * sizeof(float));
  auto kernel = segment_agg_partial_kernel<OP, MODE, C1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int cap = max_grid_of(n_tiles, sms);  // the partials' scratch
  const int grid = per_sm * sms < cap ? per_sm * sms : cap;
  const int vec = ((reinterpret_cast<uintptr_t>(values) |
                    reinterpret_cast<uintptr_t>(gids)) & 15) == 0;
  if (MODE == kGlobal) {
    fill_kernel<OP><<<static_cast<unsigned>((cells + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(out, cells);
  }
  if (grid > 0) {
    kernel<<<grid, kThreads, smem, stream>>>(values, C, gids, n, n_valid, G,
                                             tile_ids, n_tiles, tile, vec,
                                             MODE == kGlobal ? out : scratch);
  }
  if (MODE != kGlobal) {
    segment_agg_merge_kernel<OP><<<static_cast<unsigned>((cells + 31) / 32),
                                   kMergeWarps * 32, 0, stream>>>(
        scratch, grid, static_cast<int>(cells), out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int OP, int MODE>
int dispatch_c(const float* values, int C, const int32_t* gids, int64_t n,
               int64_t n_valid, int G, const int32_t* tile_ids, int n_tiles,
               int tile, int sms, float* scratch, float* out,
               cudaStream_t stream) {
  if (C == 1)
    return launch<OP, MODE, true>(values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, sms, scratch, out, stream);
  return launch<OP, MODE, false>(values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, sms, scratch, out, stream);
}

// Where the cells of (G, C) live: a private copy per lane, a copy per warp
// (both in shared memory, with partials and a merge), or the output
// (global atomics).
int mode_of(int G, int C) {
  const int64_t bytes = static_cast<int64_t>(G) * C * sizeof(float);
  if (bytes * kThreads <= kMaxSmem) return kLane;
  if (bytes * kWarps <= kMaxSmem) return kWarp;
  return kGlobal;
}

template <int OP>
int dispatch(const float* values, int C, const int32_t* gids, int64_t n,
             int64_t n_valid, int G, const int32_t* tile_ids, int n_tiles,
             int tile, int sms, float* scratch, float* out,
             cudaStream_t stream) {
  const int mode = mode_of(G, C);
  if (mode == kLane)
    return dispatch_c<OP, kLane>(values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, sms, scratch, out, stream);
  if (mode == kWarp)
    return dispatch_c<OP, kWarp>(values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, sms, scratch, out, stream);
  return dispatch_c<OP, kGlobal>(values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, sms, scratch, out, stream);
}

}  // namespace

// The float32 scratch sa_segment_agg needs for its block partials: 0 when
// the cells live in the output (G * C past a copy per warp).
extern "C" int64_t sa_scratch_floats(int G, int C, int n_tiles, int sms) {
  if (mode_of(G, C) == kGlobal) return 0;
  return static_cast<int64_t>(max_grid_of(n_tiles, sms)) * G * C;
}

// values: (n, C) float32 row-major; gids: (n,) int32; tile_ids: NULL, or
// n_tiles tile ids (units of `tile` rows), entries < 0 skipped; sms: the
// card's SM count; scratch: sa_scratch_floats(G, C, n_tiles, sms) floats;
// out: (G, C) float32, every cell written. op: 0 sum, 1 max, 2 min.
extern "C" int sa_segment_agg(const float* values, int C, const int32_t* gids,
                              int64_t n, int64_t n_valid, int G, int op,
                              const int32_t* tile_ids, int n_tiles, int tile,
                              int sms, float* scratch, float* out,
                              cudaStream_t stream) {
  if (op == kSum)
    return dispatch<kSum>(values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, sms, scratch, out, stream);
  if (op == kMax)
    return dispatch<kMax>(values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, sms, scratch, out, stream);
  return dispatch<kMin>(values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, sms, scratch, out, stream);
}
