// Group-by aggregation: per-group sum / max / min of (n, C) float32 values
// by int32 group id (paper expressions 4 and 8).
//
// Replaces the Pallas TPU kernel repro/kernels/segment_agg.py:segment_agg,
// which forms a (G, BLOCK) one-hot matrix per tile and multiplies it on the
// MXU. On Hopper the one-hot product would spend G x more work than the
// data needs, so each row instead adds (or max/min-es) its C values straight
// into privatised per-block accumulators in shared memory when G*C floats
// fit in 48 KB, and into the global output otherwise. The grid strides over
// the tiles (or over the listed tile ids, for zone-map block skipping), so a
// block flushes its accumulators to the output once, with one global atomic
// per touched (group, column) cell. Rows i >= min(n, n_valid) and group ids
// outside [0, G) are ignored; the caller pre-fills the output with the
// identity (0 / -inf / +inf), which empty groups keep.
//
// Precision: plain float32 adds, no TF32 anywhere. The order of the adds
// differs from run to run, so sums of integer-valued data are exact while
// every partial stays below 2^24 (the planner's f32-exactness gate proves
// that), and sums of general data agree to float32 rounding.
//
// Bound on the H100: bytes (values and ids read once); the adds are one per
// value.
#include "common.cuh"

#include <math.h>

enum { kSum = 0, kMax = 1, kMin = 2 };

// Order-preserving float max/min through integer atomics: non-negative
// floats order like their int bits, negative floats in reverse of their
// unsigned bits. Exact for every non-NaN value, +-inf included.
__device__ __forceinline__ void atomic_max_f(float* a, float v) {
  if (!signbit(v)) atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_min_f(float* a, float v) {
  if (!signbit(v)) atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

template <int OP>
__device__ __forceinline__ void accumulate(float* a, float v) {
  if (OP == kSum) atomicAdd(a, v);
  else if (OP == kMax) atomic_max_f(a, v);
  else atomic_min_f(a, v);
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
segment_agg_kernel(const float* __restrict__ values, int C,
                   const int32_t* __restrict__ gids, int64_t n,
                   int64_t n_valid, int G, const int32_t* __restrict__ tile_ids,
                   int n_tiles, int tile, int use_smem,
                   float* __restrict__ out) {
  extern __shared__ float acc[];  // (G, C) when use_smem
  const float ident = OP == kSum ? 0.f : (OP == kMax ? -INFINITY : INFINITY);
  const int cells = G * C;
  if (use_smem) {
    for (int i = threadIdx.x; i < cells; i += kThreads) acc[i] = ident;
    __syncthreads();
  }
  float* dst = use_smem ? acc : out;
  const int64_t stop = imin(n, n_valid);
  for (int j = blockIdx.x; j < n_tiles; j += gridDim.x) {
    const int64_t t = tile_ids ? static_cast<int64_t>(tile_ids[j]) : j;
    const int64_t base = t * tile;
    const int64_t end = imin(base + tile, stop);
    for (int64_t i = base + threadIdx.x; i < end; i += kThreads) {
      const int g = gids[i];
      if (g < 0 || g >= G) continue;
      const float* row = values + i * C;
      for (int c = 0; c < C; ++c) accumulate<OP>(dst + g * C + c, row[c]);
    }
  }
  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const float v = acc[i];
      if (v != ident) accumulate<OP>(out + i, v);
    }
  }
}

// values: (n, C) float32 row-major; gids: (n,) int32; tile_ids: NULL or
// n_tiles tile ids (units of `tile` rows); out: (G, C) float32 pre-filled
// with the identity of `op` (0 sum, 1 max, 2 min).
extern "C" int sa_segment_agg(const float* values, int C, const int32_t* gids,
                              int64_t n, int64_t n_valid, int G, int op,
                              const int32_t* tile_ids, int n_tiles, int tile,
                              int grid, float* out, cudaStream_t stream) {
  if (n_tiles > 0 && grid > 0) {
    const size_t smem = static_cast<size_t>(G) * C * sizeof(float);
    const int use_smem = smem <= 48 * 1024;
    const size_t dyn = use_smem ? smem : 0;
    if (op == kSum) {
      segment_agg_kernel<kSum><<<grid, kThreads, dyn, stream>>>(
          values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, use_smem, out);
    } else if (op == kMax) {
      segment_agg_kernel<kMax><<<grid, kThreads, dyn, stream>>>(
          values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, use_smem, out);
    } else {
      segment_agg_kernel<kMin><<<grid, kThreads, dyn, stream>>>(
          values, C, gids, n, n_valid, G, tile_ids, n_tiles, tile, use_smem, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
