// Fused multi-predicate filter + count (paper expressions 3 and 11).
//
// Replaces the Pallas TPU kernel repro/kernels/filter_count.py:filter_count.
// Counts rows i < min(n, n_valid) with lo_k <= col_k[i] <= hi_k for every
// k. The TPU kernel needed the k columns stacked into one (k, n) array for
// its BlockSpec; here the kernel reads up to kMaxCols columns through their
// own base pointers (a by-value struct), so the caller stacks nothing. Past
// kMaxCols it reads one (k, n) matrix with a row stride. Bounds arrive as a
// device operand: new literals never rebuild anything.
//
// One persistent grid, sized by the occupancy calculator (every block
// resident at once, no second wave):
//  - with no tile list, the grid strides over the rows in 16-byte groups
//    (int4) of every column, kGroups groups per column in flight per
//    thread, all loads issued before the compares; rows past the last whole
//    group and columns whose bases are not all 16-byte aligned (a (k, n)
//    matrix with n % 4 != 0 puts each row at another phase) take 4-byte
//    loads, kScalar in flight per thread;
//  - with a tile list, the grid strides over the list's entries, each one
//    `tile`-row tile (at 4096 rows, 1,024 int4 a column: 4 per thread); a
//    -1 pad entry is skipped with no host sync, and the next entry's id is
//    loaded before the current tile's rows.
// Each thread counts in registers; a warp sums by shuffles and adds its
// count to the output with one atomicAdd. The sum is of integers, so it is
// exact in any order.
//
// Bound on the H100: bytes (k int32 columns read once, 4 B/row each); the
// compare work is two integer ops per element.
#include "common.cuh"

namespace {

constexpr int kMaxCols = 16;  // columns passed by pointer
constexpr int kGroups = 4;    // int4 groups per column in flight per thread
constexpr int kScalar = 16;   // 4-byte loads per column in flight per thread

struct Cols {
  const int32_t* p[kMaxCols];
};

// Column kk: its own pointer (K > 0), or row kk of one (k, n) matrix with
// row stride ld (K == 0, any k).
template <int K>
__device__ __forceinline__ const int32_t* col(const Cols& c, int kk, int64_t ld) {
  return K > 0 ? c.p[kk] : c.p[0] + kk * ld;
}

__device__ __forceinline__ unsigned in_range(int v, int lo, int hi) {
  return static_cast<unsigned>((v >= lo) & (v <= hi));
}

// One bit per row of the 4 rows of v inside [lo, hi].
__device__ __forceinline__ unsigned in_range4(int4 v, int lo, int hi) {
  return in_range(v.x, lo, hi) | (in_range(v.y, lo, hi) << 1) |
         (in_range(v.z, lo, hi) << 2) | (in_range(v.w, lo, hi) << 3);
}

// Rows of the int4 groups [q0, q1) that pass every column's bounds; this
// thread takes groups q0 + first, + step, ...
template <int K>
__device__ __forceinline__ int count_groups(const Cols& c, int64_t ld, int k,
                                            const int* lo, const int* hi,
                                            int64_t q0, int64_t q1,
                                            int64_t first, int64_t step) {
  const int kn = K > 0 ? K : k;
  int cnt = 0;
  for (int64_t q = q0 + first; q < q1; q += kGroups * step) {
    unsigned ok[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) ok[g] = q + g * step < q1 ? 0xfu : 0u;
#pragma unroll
    for (int kk = 0; kk < kn; ++kk) {
      const int4* p = reinterpret_cast<const int4*>(col<K>(c, kk, ld));
      int4 v[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        if (q + g * step < q1) v[g] = __ldcs(p + q + g * step);
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        if (q + g * step < q1) ok[g] &= in_range4(v[g], lo[kk], hi[kk]);
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) cnt += __popc(ok[g]);
  }
  return cnt;
}

// The same over the rows [r0, r1) with 4-byte loads.
template <int K>
__device__ __forceinline__ int count_rows(const Cols& c, int64_t ld, int k,
                                          const int* lo, const int* hi,
                                          int64_t r0, int64_t r1,
                                          int64_t first, int64_t step) {
  const int kn = K > 0 ? K : k;
  int cnt = 0;
  for (int64_t r = r0 + first; r < r1; r += kScalar * step) {
    unsigned ok = 0;
#pragma unroll
    for (int s = 0; s < kScalar; ++s) ok |= (r + s * step < r1 ? 1u : 0u) << s;
#pragma unroll
    for (int kk = 0; kk < kn; ++kk) {
      const int32_t* p = col<K>(c, kk, ld);
      int v[kScalar];
#pragma unroll
      for (int s = 0; s < kScalar; ++s)
        if (r + s * step < r1) v[s] = __ldcs(p + r + s * step);
      unsigned pass = 0;
#pragma unroll
      for (int s = 0; s < kScalar; ++s)
        if (r + s * step < r1) pass |= in_range(v[s], lo[kk], hi[kk]) << s;
      ok &= pass;
    }
    cnt += __popc(ok);
  }
  return cnt;
}

// Rows [r0, r1): whole int4 groups (vec, r0 % 4 == 0) then the last up to
// 3 rows with 4-byte loads, or every row with 4-byte loads. An empty span
// (a listed tile that starts at or past n_valid has r1 < r0) counts 0.
template <int K>
__device__ __forceinline__ int count_span(const Cols& c, int64_t ld, int k,
                                         const int* lo, const int* hi,
                                         int64_t r0, int64_t r1, bool vec,
                                         int64_t first, int64_t step) {
  if (r1 <= r0) return 0;
  if (!vec) return count_rows<K>(c, ld, k, lo, hi, r0, r1, first, step);
  const int64_t split = r1 & ~int64_t(3);
  return count_groups<K>(c, ld, k, lo, hi, r0 / 4, split / 4, first, step) +
         count_rows<K>(c, ld, k, lo, hi, split, r1, first, step);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
filter_count_kernel(Cols cols, int k, int64_t ld, int64_t n,
                    const int32_t* __restrict__ bounds, int64_t n_valid,
                    const int32_t* __restrict__ tile_ids, int n_tiles,
                    int tile, int vec, int32_t* __restrict__ out) {
  // bounds: in registers for K > 0 (indices fixed once unrolled), else in
  // shared memory
  extern __shared__ int sb[];
  int lo_r[K > 0 ? K : 1], hi_r[K > 0 ? K : 1];
  const int *lo, *hi;
  if constexpr (K > 0) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      lo_r[kk] = __ldg(bounds + 2 * kk);
      hi_r[kk] = __ldg(bounds + 2 * kk + 1);
    }
    lo = lo_r;
    hi = hi_r;
  } else {
    for (int i = threadIdx.x; i < k; i += kThreads) {
      sb[i] = bounds[2 * i];
      sb[k + i] = bounds[2 * i + 1];
    }
    __syncthreads();
    lo = sb;
    hi = sb + k;
  }
  const int64_t end = imin(n, imax(n_valid, 0));
  int cnt = 0;
  if (tile_ids == nullptr) {
    const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
    cnt = count_span<K>(cols, ld, k, lo, hi, 0, end, vec,
                        static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x,
                        step);
  } else {
    int next = blockIdx.x < n_tiles ? tile_ids[blockIdx.x] : -1;
    for (int e = blockIdx.x; e < n_tiles; e += gridDim.x) {
      const int64_t t = next;  // a pad id (< 0) visits nothing
      if (e + gridDim.x < n_tiles) next = tile_ids[e + gridDim.x];
      if (t < 0) continue;
      const int64_t base = t * tile;
      cnt += count_span<K>(cols, ld, k, lo, hi, base, imin(base + tile, end),
                           vec, threadIdx.x, kThreads);
    }
  }
  cnt = warp_sum(cnt);
  if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(out, cnt);
}

template <int K>
int launch(const Cols& cols, int k, int64_t ld, int64_t n,
           const int32_t* bounds, int64_t n_valid, const int32_t* tile_ids,
           int n_tiles, int tile, int sms, int32_t* out, cudaStream_t stream) {
  auto kernel = filter_count_kernel<K>;
  const int smem = K > 0 ? 0 : static_cast<int>(2 * k * sizeof(int));
  static int cached = 0;  // blocks per SM, for K > 0 (no shared memory)
  int per_sm = K > 0 ? cached : 0;
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (K > 0) cached = per_sm;
  }
  // 16-byte loads need every column base at a 16-byte boundary and every
  // tile to start on a whole group
  bool vec = tile_ids == nullptr || tile % 4 == 0;
  if (K > 0) {
    for (int kk = 0; kk < K; ++kk)
      vec = vec && (reinterpret_cast<uintptr_t>(cols.p[kk]) & 15) == 0;
  } else {
    vec = vec && (reinterpret_cast<uintptr_t>(cols.p[0]) & 15) == 0 && ld % 4 == 0;
  }
  int64_t units;  // blocks the work can use
  if (tile_ids != nullptr) {
    units = n_tiles;
  } else {
    const int64_t rows = n < n_valid ? n : n_valid;
    const int64_t per_block = static_cast<int64_t>(kThreads) * (vec ? 4 * kGroups : kScalar);
    units = rows > 0 ? (rows + per_block - 1) / per_block : 1;
  }
  const int64_t full = static_cast<int64_t>(per_sm) * sms;
  const int grid = static_cast<int>(units < full ? units : full);
  if (grid > 0) {
    kernel<<<grid, kThreads, smem, stream>>>(cols, k, ld, n, bounds, n_valid,
                                             tile_ids, n_tiles, tile, vec, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch(const Cols& cols, int k, int64_t ld, int64_t n,
             const int32_t* bounds, int64_t n_valid, const int32_t* tile_ids,
             int n_tiles, int tile, int sms, int32_t* out, cudaStream_t stream) {
  if constexpr (K <= kMaxCols) {
    if (k == K)
      return launch<K>(cols, k, ld, n, bounds, n_valid, tile_ids, n_tiles, tile, sms, out, stream);
    return dispatch<K + 1>(cols, k, ld, n, bounds, n_valid, tile_ids, n_tiles, tile, sms, out, stream);
  } else {
    return launch<0>(cols, k, ld, n, bounds, n_valid, tile_ids, n_tiles, tile, sms, out, stream);
  }
}

}  // namespace

// cols: k column pointers (ld == 0, k <= 16), or one pointer to a (k, n)
// row-major matrix with row stride ld; each column (n,) int32. bounds:
// (k, 2) int32 [lo, hi]. tile_ids: NULL (every row), or n_tiles tile ids in
// units of `tile` rows, entries < 0 skipped. sms: the card's SM count. out:
// one int32, zeroed by the caller.
extern "C" int fc_filter_count(const int32_t* const* cols, int k, int64_t ld,
                               int64_t n, const int32_t* bounds,
                               int64_t n_valid, const int32_t* tile_ids,
                               int n_tiles, int tile, int sms, int32_t* out,
                               cudaStream_t stream) {
  Cols c{};
  if (ld == 0) {
    if (k > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
    for (int kk = 0; kk < k; ++kk) c.p[kk] = cols[kk];
  } else if (k <= kMaxCols) {
    for (int kk = 0; kk < k; ++kk) c.p[kk] = cols[0] + kk * ld;
  } else {
    c.p[0] = cols[0];
  }
  return dispatch<1>(c, k, ld, n, bounds, n_valid, tile_ids, n_tiles, tile,
                     sms, out, stream);
}
