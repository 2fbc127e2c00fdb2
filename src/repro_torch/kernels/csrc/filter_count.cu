// Fused multi-predicate filter + count (paper expressions 3 and 11).
//
// Replaces the Pallas TPU kernel repro/kernels/filter_count.py:filter_count.
// Counts rows i < min(n, n_valid) with lo_k <= cols[k, i] <= hi_k for every
// k. One CUDA block per `tile`-row tile (the zone-map block); with a
// block-id list the grid is the list and each block reads its tile's id, so
// skipped tiles are never read. A list may be -1-padded at the end (the
// per-shard form: one grid length for every shard's list); a block whose id
// is negative returns at once, adding nothing. Bounds arrive as a device
// operand: new literals never rebuild anything. Each thread counts its
// rows, the block reduces, and one int32 atomicAdd per block lands the
// partial count — the result is exact.
//
// Bound on the H100: bytes (k int32 columns read once, 4 B/row each); the
// compare work is two integer ops per element.
#include "common.cuh"

__global__ void __launch_bounds__(kThreads)
filter_count_kernel(const int32_t* __restrict__ cols, int k, int64_t n,
                    const int32_t* __restrict__ bounds, int64_t n_valid,
                    const int32_t* __restrict__ block_ids, int tile,
                    int32_t* __restrict__ out) {
  extern __shared__ int32_t sb[];  // (k, 2) bounds
  const int64_t t = block_ids ? static_cast<int64_t>(block_ids[blockIdx.x])
                              : static_cast<int64_t>(blockIdx.x);
  if (t < 0) return;  // a pad id; uniform across the block
  for (int i = threadIdx.x; i < 2 * k; i += kThreads) sb[i] = bounds[i];
  __syncthreads();
  const int64_t base = t * tile;
  const int64_t end = imin(base + tile, imin(n, n_valid));
  int32_t cnt = 0;
  for (int64_t i = base + threadIdx.x; i < end; i += kThreads) {
    int ok = 1;
    for (int kk = 0; kk < k; ++kk) {
      const int32_t v = cols[kk * n + i];
      ok &= (v >= sb[2 * kk]) & (v <= sb[2 * kk + 1]);
    }
    cnt += ok;
  }
  cnt = block_sum(cnt);
  if (threadIdx.x == 0 && cnt) atomicAdd(out, cnt);
}

// cols: (k, n) int32 row-major; bounds: (k, 2) int32; block_ids: NULL or
// n_blocks tile ids, entries < 0 skipped; out: one int32, zeroed by the caller.
extern "C" int fc_filter_count(const int32_t* cols, int k, int64_t n,
                               const int32_t* bounds, int64_t n_valid,
                               const int32_t* block_ids, int n_blocks,
                               int tile, int32_t* out, cudaStream_t stream) {
  if (n_blocks > 0) {
    filter_count_kernel<<<n_blocks, kThreads, 2 * k * sizeof(int32_t),
                          stream>>>(cols, k, n, bounds, n_valid, block_ids,
                                    tile, out);
  }
  return static_cast<int>(cudaGetLastError());
}
