// Masked per-block top-k (paper expression 9: ORDER BY ... DESC LIMIT k).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_mask.py:block_topk. One
// CUDA block per `tile`-row block stages the block's masked scores in shared
// memory (dead rows, rows past n_valid and the ragged tail enter as -inf),
// then runs k rounds. Round r picks the successor of round r-1's pick in the
// total order (value descending, index ascending): each thread scans its
// strided share of the tile, a warp shuffle and one shared-memory step reduce
// to the block's pick. No score is overwritten, so ties go to the lower
// index and the k indices of a block are always distinct — the order of a
// stable descending sort. (The Pallas kernel masks each pick out with -inf,
// so once a block runs out of live rows it repeats the index base + 0; the
// finite candidates agree.)
//
// Bound on the H100: bytes (4 B of score + 1 B of mask per row, read once);
// the k rounds re-read shared memory, not device memory.
#include "common.cuh"

#include <climits>
#include <math.h>

// true when (v, i) comes before (bv, bi) in the order (value desc, index asc)
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(kFullMask, bv, o);
    const int oi = __shfl_down_sync(kFullMask, bi, o);
    if (before(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
}

__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const float* __restrict__ scores,
                  const uint8_t* __restrict__ mask, int64_t n, int64_t n_valid,
                  int k, int tile, float* __restrict__ out_v,
                  int32_t* __restrict__ out_i) {
  extern __shared__ float s[];  // tile scores
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ float prev_v;
  __shared__ int prev_i;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int j = threadIdx.x; j < tile; j += kThreads) {
    const int64_t i = base + j;
    const bool live = i < n && i < n_valid && mask[i];
    s[j] = live ? scores[i] : -INFINITY;
  }
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    const float pv = prev_v;  // written by thread 0 of the previous round
    const int pi = prev_i;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < tile; j += kThreads) {
      const float v = s[j];
      if (r > 0 && !before(pv, pi, v, j)) continue;  // not after the last pick
      if (before(v, j, bv, bi)) { bv = v; bi = j; }
    }
    warp_best(bv, bi);
    if (lane == 0) { red_v[wid] = bv; red_i[wid] = bi; }
    __syncthreads();
    if (wid == 0) {
      bv = lane < kThreads / 32 ? red_v[lane] : -INFINITY;
      bi = lane < kThreads / 32 ? red_i[lane] : INT_MAX;
      warp_best(bv, bi);
      if (lane == 0) {
        out_v[static_cast<int64_t>(blockIdx.x) * k + r] = bv;
        out_i[static_cast<int64_t>(blockIdx.x) * k + r] =
            static_cast<int32_t>(base + bi);
        prev_v = bv;
        prev_i = bi;
      }
    }
    __syncthreads();
  }
}

// scores: (n,) float32; mask: (n,) bool as uint8; out_v / out_i: (nb, k)
// with nb = ceil(n / tile); requires k <= tile.
extern "C" int tk_block_topk(const float* scores, const uint8_t* mask,
                             int64_t n, int64_t n_valid, int k, int tile,
                             int nb, float* out_v, int32_t* out_i,
                             cudaStream_t stream) {
  if (nb > 0) {
    const size_t smem = static_cast<size_t>(tile) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(block_topk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    block_topk_kernel<<<nb, kThreads, smem, stream>>>(
        scores, mask, n, n_valid, k, tile, out_v, out_i);
  }
  return static_cast<int>(cudaGetLastError());
}
