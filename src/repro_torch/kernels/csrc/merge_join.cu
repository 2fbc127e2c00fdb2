// Sorted equi-join cardinality (paper expression 12).
//
// Replaces the Pallas TPU kernel repro/kernels/merge_join.py:merge_join_count,
// which walks a 2-D grid of (left block x right block) pairs and skips the
// pairs whose key ranges miss — at 5M rows that grid has ~24M pairs. Here the
// work follows the merge path instead: one CUDA block per `tile` left keys
// binary-searches the right array once for the tile's key range
// [l_lo, l_hi], and each thread then finds its key's run of equal right keys
// inside that window with two more binary searches. The count is exact for
// any number of duplicates on either side: sum over i < nl of
// |{j < nr : r_j == l_i}|, summed in int32 (one atomicAdd per block).
//
// Inputs follow the reference contract: both arrays sorted ascending, valid
// prefixes of length nl / nr (device scalars, so no host sync), INT32_MAX
// padding after.
//
// Bound on the H100: bytes (each key read once); a thread's searches touch
// O(log window) further keys, mostly in L2.
#include "common.cuh"

__device__ __forceinline__ int64_t lower_bound(const int32_t* a, int64_t lo,
                                               int64_t hi, int32_t x) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int64_t upper_bound(const int32_t* a, int64_t lo,
                                               int64_t hi, int32_t x) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
merge_join_kernel(const int32_t* __restrict__ l, int64_t l_len,
                  const int32_t* __restrict__ r, int64_t r_len,
                  const int32_t* __restrict__ nl_p,
                  const int32_t* __restrict__ nr_p, int tile,
                  int32_t* __restrict__ out) {
  __shared__ int64_t win_lo, win_hi;
  const int64_t nl = imin(static_cast<int64_t>(*nl_p), l_len);
  const int64_t nr = imin(static_cast<int64_t>(*nr_p), r_len);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  if (base >= nl) return;  // uniform across the block
  const int64_t end = imin(base + tile, nl);
  if (threadIdx.x == 0) {
    win_lo = lower_bound(r, 0, nr, l[base]);
    win_hi = upper_bound(r, win_lo, nr, l[end - 1]);
  }
  __syncthreads();
  const int64_t wlo = win_lo, whi = win_hi;
  int32_t cnt = 0;
  for (int64_t i = base + threadIdx.x; i < end; i += kThreads) {
    const int32_t x = l[i];
    const int64_t a = lower_bound(r, wlo, whi, x);
    cnt += static_cast<int32_t>(upper_bound(r, a, whi, x) - a);
  }
  cnt = block_sum(cnt);
  if (threadIdx.x == 0 && cnt) atomicAdd(out, cnt);
}

// l: (l_len,) and r: (r_len,) int32 sorted ascending; nl_p / nr_p: device
// int32 scalars; out: one int32, zeroed by the caller.
extern "C" int mj_merge_join_count(const int32_t* l, int64_t l_len,
                                   const int32_t* r, int64_t r_len,
                                   const int32_t* nl_p, const int32_t* nr_p,
                                   int tile, int32_t* out,
                                   cudaStream_t stream) {
  const int64_t nb = (l_len + tile - 1) / tile;
  if (nb > 0) {
    merge_join_kernel<<<static_cast<unsigned>(nb), kThreads, 0, stream>>>(
        l, l_len, r, r_len, nl_p, nr_p, tile, out);
  }
  return static_cast<int>(cudaGetLastError());
}
