// Sorted equi-join cardinality (paper expression 12).
//
// Replaces the Pallas TPU kernel repro/kernels/merge_join.py:merge_join_count,
// which walks a 2-D grid of (left block x right block) pairs and skips the
// pairs whose key ranges miss — at 5M rows that grid has ~24M pairs. Here
// the left keys are cut into tiles of kTile keys, and two kernels run on the
// caller's stream:
//  - merge_join_window_kernel (the partition pass): two warps per left tile
//    find the tile's right window [lower(l_first), upper(l_last)) over the
//    valid right prefix, each by a 32-way search (every step, the 32 lanes
//    test 31 pivots and a ballot keeps one of 32 slices: 5 dependent loads
//    at 5M keys where a binary search takes 23), into int64 scratch the
//    wrapper allocates.
//  - merge_join_kernel: one block per left tile. Each thread loads its
//    kKeys consecutive left keys with two 16-byte loads; the block stages
//    its right window in shared memory with 16-byte loads when it fits in
//    kWinCap keys, one padding word per 32 so that neighbouring threads,
//    each near its own stretch of 8 keys, read distinct banks. Each thread
//    then walks its keys in order. The first key's run of equal right keys
//    is found by an exponential search (steps of 1, 2, 4, ... then binary)
//    from the key's place in the tile scaled to the window (exact for
//    unique keys); each later key's by up to kLinear linear steps from
//    where the last run ended, then the same search; a key equal to the
//    one before it reuses that run. Unique keys cost about three shared
//    loads each, a run of d keys O(log d). A window past kWinCap (duplicate-heavy keys,
//    or a tile whose key range spans a dense right run) is walked the same
//    way in device memory: exact for any number of duplicates.
// Counts accumulate in int64 per thread and per block; each block adds the
// low 32 bits of its count to the int32 result, so the result is the exact
// sum modulo 2^32, as the plain version's int32 sum gives it.
//
// Inputs follow the reference contract: both arrays sorted ascending, valid
// prefixes of length nl / nr (device scalars, so no host sync), INT32_MAX
// padding after. Only positions below nl / nr count (ref.py masks by
// position), so a prefix may cut a run of equal keys.
//
// Bound on the H100: bytes (each key read once: 40 MB at two 5M-key arrays,
// 11.9 us at 3.35 TB/s).
#include "common.cuh"

namespace {

constexpr int kKeys = 8;                    // left keys per thread
constexpr int kTile = kKeys * kThreads;     // left keys per block
constexpr int kWinCap = 6144;               // right keys staged in shared memory
constexpr int kLinear = 4;                  // linear steps before a search

// Skewed shared-memory index: one padding word per 32. Thread t walks near
// window position kKeys * t, so without the skew the 32 lanes of a warp
// would meet in 32 / kKeys banks; with it, unique keys meet in 32.
__device__ __forceinline__ int skew(int p) { return p + (p >> 5); }

// The staged window, read through the skew.
struct Staged {
  const int32_t* s;
  __device__ __forceinline__ int32_t operator[](int p) const { return s[skew(p)]; }
};

// First position p in [0, n) with r[p] > x (UPPER) or r[p] >= x, else n.
// Called by a whole warp; every lane returns the answer.
template <bool UPPER>
__device__ int64_t warp_search(const int32_t* __restrict__ r, int64_t n,
                               int32_t x) {
  const int lane = threadIdx.x & 31;
  int64_t a = 0, b = n;  // the answer lies in [a, b]
  while (b - a > 31) {
    // lanes 0..30 test pivots k = 1..31 of 32 slices; lane 31 stands for b
    const int64_t p = a + (b - a) * (lane + 1) / 32;
    const bool hit = lane == 31 || (UPPER ? r[p] > x : r[p] >= x);
    const int c = __ffs(__ballot_sync(kFullMask, hit)) - 1;
    const int64_t na = c > 0 ? a + (b - a) * c / 32 + 1 : a;
    b = c < 31 ? a + (b - a) * (c + 1) / 32 : b;
    a = na;
  }
  const int64_t p = a + lane;  // at most 31 candidates left
  const bool hit = p >= b || (UPPER ? r[p] > x : r[p] >= x);
  return a + __ffs(__ballot_sync(kFullMask, hit)) - 1;
}

// First position p in [lo, hi) with R[p] > x (UPPER) or R[p] >= x, else
// hi, searched from the guess g in [lo, hi]: steps of 1, 2, 4, ... from g
// toward the answer, then a binary search inside the last step. A guess
// d positions off costs about 2 log2(d) probes; a right guess, one or two.
template <bool UPPER, typename I, typename Keys>
__device__ __forceinline__ I search(const Keys& R, I lo, I hi, I g, int32_t x) {
  I a = lo, b = hi;  // the answer lies in [a, b]
  if (g < hi) {
    if (UPPER ? R[g] > x : R[g] >= x) {
      b = g;
      for (I s = 1; g - s >= lo; s <<= 1) {
        const I p = g - s;
        if (!(UPPER ? R[p] > x : R[p] >= x)) {
          a = p + 1;
          break;
        }
        b = p;
      }
    } else {
      a = g + 1;
      for (I s = 1; g + s < hi; s <<= 1) {
        const I p = g + s;
        if (UPPER ? R[p] > x : R[p] >= x) {
          b = p;
          break;
        }
        a = p + 1;
      }
    }
  }
  while (a < b) {
    const I m = a + ((b - a) >> 1);
    if (UPPER ? R[m] > x : R[m] >= x) b = m; else a = m + 1;
  }
  return a;
}

// From j, the first position in [j, hi) whose key is not below x (UPPER:
// not equal to x, where R[j..] >= x): a few linear steps, which is all a
// run of unique keys needs, then the exponential search.
template <bool UPPER, typename I, typename Keys>
__device__ __forceinline__ I advance(const Keys& R, I j, I hi, int32_t x) {
#pragma unroll 1
  for (int s = 0; s < kLinear; ++s, ++j)
    if (j >= hi || (UPPER ? R[j] != x : R[j] >= x)) return j;
  return search<UPPER>(R, j, hi, j, x);
}

// The join count of a thread's first n (<= kKeys) sorted keys against the
// sorted R[lo, hi): the first key's run is searched from the guess g, each
// later key's by advancing from where the last run ended; a key equal to
// the one before it reuses that run. The loop is unrolled, so every key
// stays in its register. Counted in I (a staged window's count fits int).
template <typename I, typename Keys>
__device__ __forceinline__ int64_t walk(const Keys& R, I lo, I hi, I g,
                                        const int32_t (&key)[kKeys], int n) {
  I cnt = 0, run = 0, j = lo;
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    if (k >= n) break;
    const int32_t x = key[k];
    if (k > 0 && x == key[k - 1]) {
      cnt += run;
      continue;
    }
    const I p = k == 0 ? search<false>(R, lo, hi, g, x) : advance<false>(R, j, hi, x);
    j = advance<true>(R, p, hi, x);
    run = j - p;
    cnt += run;
  }
  return cnt;
}

__global__ void __launch_bounds__(kThreads)
merge_join_window_kernel(const int32_t* __restrict__ l, int64_t l_len,
                         const int32_t* __restrict__ r, int64_t r_len,
                         const int32_t* __restrict__ nl_p,
                         const int32_t* __restrict__ nr_p, int64_t n_tiles,
                         int64_t* __restrict__ win) {
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t tile = w >> 1;
  const bool upper = w & 1;
  if (tile >= n_tiles) return;  // uniform across the warp
  const int64_t nl = imin(imax(*nl_p, 0), l_len);
  const int64_t nr = imin(imax(*nr_p, 0), r_len);
  const int64_t base = tile * kTile;
  int64_t pos = 0;
  if (base < nl) {
    pos = upper ? warp_search<true>(r, nr, l[imin(base + kTile, nl) - 1])
                : warp_search<false>(r, nr, l[base]);
  }
  if ((threadIdx.x & 31) == 0) win[2 * tile + upper] = pos;
}

__global__ void __launch_bounds__(kThreads)
merge_join_kernel(const int32_t* __restrict__ l, int64_t l_len,
                  const int32_t* __restrict__ r, const int32_t* __restrict__ nl_p,
                  const int64_t* __restrict__ win, int vec,
                  int32_t* __restrict__ out) {
  __shared__ int32_t rs[kWinCap + kWinCap / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t first = base + kKeys * threadIdx.x;
  // three independent loads: the left prefix, the window, this thread's keys
  const int64_t nl = imin(imax(*nl_p, 0), l_len);
  const int64_t wlo = win[2 * blockIdx.x], whi = win[2 * blockIdx.x + 1];
  int32_t key[kKeys];
  if (vec && first + kKeys <= l_len) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(l + first));
    const int4 b = __ldg(reinterpret_cast<const int4*>(l + first) + 1);
    key[0] = a.x; key[1] = a.y; key[2] = a.z; key[3] = a.w;
    key[4] = b.x; key[5] = b.y; key[6] = b.z; key[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kKeys; ++k) key[k] = first + k < l_len ? l[first + k] : 0;
  }
  if (base >= nl) return;  // uniform across the block
  const int64_t end = imin(base + kTile, nl);
  const int n_mine = static_cast<int>(imax(imin(end - first, kKeys), 0));
  // the first key's guess: its place in the tile, scaled to the window
  const int64_t g = wlo + (first - base) * (whi - wlo) / (end - base);
  const int64_t a0 = wlo & ~int64_t{3};  // 16-byte aligned start
  const int64_t n4 = (whi - a0 + 3) / 4;
  int64_t cnt;
  if (4 * n4 <= kWinCap) {  // uniform across the block
    for (int64_t q = threadIdx.x; q < n4; q += kThreads) {
      const int64_t p = a0 + 4 * q;
      const int o = skew(static_cast<int>(4 * q));  // 4q .. 4q + 3 share a skew
      if (vec && p + 4 <= whi) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(r + p));
        rs[o] = v.x; rs[o + 1] = v.y; rs[o + 2] = v.z; rs[o + 3] = v.w;
      } else {
        for (int j = 0; j < 4; ++j)
          if (p + j < whi) rs[o + j] = r[p + j];
      }
    }
    __syncthreads();
    cnt = walk(Staged{rs}, static_cast<int>(wlo - a0), static_cast<int>(whi - a0),
               static_cast<int>(imin(g, whi) - a0), key, n_mine);
  } else {
    cnt = walk(r, wlo, whi, imin(g, whi), key, n_mine);
  }
  cnt = block_sum(cnt);
  if (threadIdx.x == 0 && cnt)
    atomicAdd(reinterpret_cast<unsigned*>(out), static_cast<unsigned>(cnt));
}

}  // namespace

// Left keys per tile: the wrapper sizes the window scratch by it.
extern "C" int mj_tile() { return kTile; }

// l: (l_len,) and r: (r_len,) int32 sorted ascending; nl_p / nr_p: device
// int32 scalars; win: 2 * ceil(l_len / mj_tile()) int64 scratch; out: one
// int32, zeroed by the caller.
extern "C" int mj_merge_join_count(const int32_t* l, int64_t l_len,
                                   const int32_t* r, int64_t r_len,
                                   const int32_t* nl_p, const int32_t* nr_p,
                                   int64_t* win, int32_t* out,
                                   cudaStream_t stream) {
  const int64_t n_tiles = (l_len + kTile - 1) / kTile;
  if (n_tiles > 0) {
    const int vec = ((reinterpret_cast<uintptr_t>(l) |
                      reinterpret_cast<uintptr_t>(r)) & 15) == 0;
    const int64_t tiles_per_block = kThreads / 64;  // two warps per tile
    merge_join_window_kernel<<<static_cast<unsigned>(
        (n_tiles + tiles_per_block - 1) / tiles_per_block), kThreads, 0, stream>>>(
        l, l_len, r, r_len, nl_p, nr_p, n_tiles, win);
    merge_join_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(
        l, l_len, r, nl_p, win, vec, out);
  }
  return static_cast<int>(cudaGetLastError());
}
