// Masked per-block top-k and its merge (paper expression 9: ORDER BY ...
// DESC LIMIT k).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_mask.py:block_topk (k
// rounds of max + mask-out over a staged block) and the merge that follows
// it (topk_merge's jax.lax.top_k over the nb x k candidates). Every list is
// in the order (value descending, index ascending): ties go to the lower
// index, the order of a stable descending sort. Dead rows, rows past
// n_valid and the ragged tail enter as -inf with their own indices, so a
// tile with fewer than k live rows gives the next distinct indices. (The
// Pallas kernel masks each pick out with -inf, so once a block runs out of
// live rows it repeats the index base + 0; the finite candidates agree.)
//
// k <= kTopkMax (16):
//  - block_topk_kernel: one block of kTileWarps warps per `tile`-row tile;
//    each warp keeps the best k rows of its share so far in registers
//    across its lanes, lane j the j-th (a warp queue), and a gate. At 4096
//    rows a lane loads its 32 rows as 8 float4 score loads and 8 four-byte
//    mask loads (4 bools each), all in flight at once, and takes its own
//    best row; a bitonic sort of the lanes' best rows by shuffle starts the
//    list with the best k of them, and the gate closes on the k-th (k
//    lanes hold a row at or before it, so no row after it is in the top
//    k). Then the lanes offer their other rows, 8 at a time: compares with
//    the gate and one ballot. While any lane holds a row before the gate,
//    the warp takes the best such row (one argmax by shuffle, or a
//    broadcast when one lane holds them all), inserts it (a ballot gives
//    its place, a shuffle shifts the rows behind it), and the gate closes
//    on the new entry k-1. Rows enter best
//    first, so however the scores lie (ascending with the row, as a
//    clustered key gives, or shuffled) few rows reach the list. The
//    warps' lists meet in shared memory (one __syncthreads); warp 0 sorts
//    them across its lanes where they fit one a lane (k <= 8), else offers
//    the others' entries as rows. Ragged tiles, tiles cut by n, other tile
//    sizes and operands off 16 (scores) or 4 (mask) bytes take 4-byte
//    score and 1-byte mask loads (rows 32w + l + 128i of warp w, lane l)
//    and start from an empty list.
// k > kTopkMax:
//  - block_topk_rounds_kernel: one 256-thread block per tile stages its
//    masked scores in shared memory and runs k rounds of a (value desc,
//    index asc) successor search over them.
// The merge, any k:
//  - topk_merge_kernel: one block of kMergeThreads; each thread owns some
//    blocks' sorted candidate lists and a read position in each (in
//    scratch); k rounds of a block-wide argmax over the threads' best
//    heads, the winner's list advancing by one: the k best by (value desc,
//    global index asc). Global indices grow with the block and, in a
//    block, with the position, so that is the order of a stable sort of
//    the block-major candidate list: the result is bit for bit the same.
//
// Bound on the H100: bytes (4 B of score + 1 B of mask per row, read
// once); block_topk_kernel does a handful of integer and float compares
// per row.
#include "common.cuh"

#include <climits>
#include <math.h>

namespace {

constexpr int kTopkMax = 16;     // block_topk_kernel's largest k
constexpr int kTileWarps = 4;    // warps sharing one tile in block_topk_kernel
constexpr int kTile = 4096;      // the tile of the 16-byte path (the zone block)
constexpr int kLoads = kTile / 4 / 32 / kTileWarps;  // float4s a lane loads (8)
constexpr int kMergeThreads = 512;
constexpr int kMergeWarps = kMergeThreads / 32;

// true when (v, i) comes before (bv, bi) in the order (value desc, index asc)
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// (bv, bi) := the best of the 32 lanes' (bv, bi), in every lane.
__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, bv, o);
    const int oi = __shfl_xor_sync(kFullMask, bi, o);
    if (before(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
}

// A bitonic sort over the warp of one (value, index) a lane, by xor
// shuffles: the j-th best ends in lane j.
__device__ __forceinline__ void warp_sort(float& v, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, v, stride);
      const int oi = __shfl_xor_sync(kFullMask, i, stride);
      // the lower lane of a pair keeps the better row where the segment
      // runs best first (the whole warp at size 32)
      const bool better = ((lane & stride) == 0) == ((lane & size) == 0);
      if (better ? before(ov, oi, v, i) : before(v, i, ov, oi)) { v = ov; i = oi; }
    }
}

__device__ __forceinline__ float live_or_neg(float s, unsigned m, int64_t row,
                                             int64_t n_valid) {
  return (m & 0xffu) && row < n_valid ? s : -INFINITY;
}

// The best k rows of a warp's tile so far, lane j holding the j-th (j < k;
// the lanes past k hold what shifts out), and the gate: entry k - 1.
struct WarpTopK {
  float wv = -INFINITY, gv = -INFINITY;
  int wi = INT_MAX, gi = INT_MAX;

  // Start from the lanes' own best rows (lv, li): sorted across the warp,
  // the list takes the first k and the gate closes on the k-th.
  __device__ __forceinline__ void seed(float lv, int li, int k, int lane) {
    warp_sort(lv, li, lane);
    wv = lv;
    wi = li;
    gv = __shfl_sync(kFullMask, lv, k - 1);
    gi = __shfl_sync(kFullMask, li, k - 1);
  }

  // Offer each lane's rows x[e] (global index row(e)) whose bit is set in
  // `rows`: one ballot when none comes before the gate.
  template <int E, typename Row>
  __device__ __forceinline__ void offer(const float (&x)[E], Row row,
                                        unsigned rows, int k, int lane) {
    unsigned pend = 0;
#pragma unroll
    for (int e = 0; e < E; ++e)
      pend |= static_cast<unsigned>(before(x[e], row(e), gv, gi)) << e;
    pend &= rows;
    for (unsigned who; (who = __ballot_sync(kFullMask, pend != 0)) != 0;) {
      float bv = -INFINITY;  // this lane's best candidate
      int bi = INT_MAX;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (((pend >> e) & 1u) && before(x[e], row(e), bv, bi)) { bv = x[e]; bi = row(e); }
      if (who & (who - 1)) {
        warp_best(bv, bi);  // the best candidate of the warp, in every lane
      } else {              // one lane holds candidates: its best
        bv = __shfl_sync(kFullMask, bv, __ffs(who) - 1);
        bi = __shfl_sync(kFullMask, bi, __ffs(who) - 1);
      }
      const int pos = __popc(__ballot_sync(kFullMask, lane < k && before(wv, wi, bv, bi)));
      const float uv = __shfl_up_sync(kFullMask, wv, 1);
      const int ui = __shfl_up_sync(kFullMask, wi, 1);
      if (lane == pos) { wv = bv; wi = bi; }
      else if (lane > pos) { wv = uv; wi = ui; }
      const float nv = __shfl_sync(kFullMask, wv, k - 1);
      const int ni = __shfl_sync(kFullMask, wi, k - 1);
      if (before(nv, ni, gv, gi)) { gv = nv; gi = ni; }  // the gate only closes in
#pragma unroll
      for (int e = 0; e < E; ++e)  // the row taken, and rows the gate now keeps out
        if (row(e) == bi || !before(x[e], row(e), gv, gi)) pend &= ~(1u << e);
    }
  }
};

__global__ void __launch_bounds__(kTileWarps * 32)
block_topk_kernel(const float* __restrict__ scores,
                  const uint8_t* __restrict__ mask, int64_t n, int64_t n_valid,
                  int k, int tile, int vec, float* __restrict__ out_v,
                  int32_t* __restrict__ out_i) {
  __shared__ float part_v[kTileWarps][kTopkMax];
  __shared__ int part_i[kTileWarps][kTopkMax];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const int64_t base = t * tile;
  WarpTopK top;
  if (vec && tile == kTile && base + kTile <= n) {
    // a whole 4096-row tile: warp w's lane l loads float4 q = 32 (kLoads w
    // + j) + l (rows 4q .. 4q + 3) and its mask word, j = 0 .. kLoads - 1,
    // all in flight at once, and offers them 2 float4s (8 rows) at a time
    const int q0 = 32 * kLoads * w + lane;
    const float4* s4 = reinterpret_cast<const float4*>(scores + base) + q0;
    const unsigned* m4 = reinterpret_cast<const unsigned*>(mask + base) + q0;
    float4 s[kLoads];
    unsigned m[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) { s[j] = __ldcs(s4 + 32 * j); m[j] = __ldcs(m4 + 32 * j); }
    float bv[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    int bi[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};  // the best of each lane of a float4
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int r = static_cast<int>(base) + 4 * (q0 + 32 * j);
      const float x[4] = {live_or_neg(s[j].x, m[j], r, n_valid),
                          live_or_neg(s[j].y, m[j] >> 8, r + 1, n_valid),
                          live_or_neg(s[j].z, m[j] >> 16, r + 2, n_valid),
                          live_or_neg(s[j].w, m[j] >> 24, r + 3, n_valid)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (before(x[e], r + e, bv[e], bi[e])) { bv[e] = x[e]; bi[e] = r + e; }
    }
    float lv = bv[0];  // this lane's best row
    int li = bi[0];
#pragma unroll
    for (int e = 1; e < 4; ++e)
      if (before(bv[e], bi[e], lv, li)) { lv = bv[e]; li = bi[e]; }
    top.seed(lv, li, k, lane);
    // this lane's best row is in the list unless it comes after the gate
    const int taken = before(top.gv, top.gi, lv, li) ? INT_MAX : li;
#pragma unroll
    for (int j0 = 0; j0 < kLoads; j0 += 2) {
      // row of x[4u + e]: base + 4 (q0 + 32 (j0 + u)) + e
      const int row0 = static_cast<int>(base) + 4 * (q0 + 32 * j0);
      float x[8];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = row0 + 128 * u;
        x[4 * u] = live_or_neg(s[j0 + u].x, m[j0 + u], r, n_valid);
        x[4 * u + 1] = live_or_neg(s[j0 + u].y, m[j0 + u] >> 8, r + 1, n_valid);
        x[4 * u + 2] = live_or_neg(s[j0 + u].z, m[j0 + u] >> 16, r + 2, n_valid);
        x[4 * u + 3] = live_or_neg(s[j0 + u].w, m[j0 + u] >> 24, r + 3, n_valid);
      }
      auto row = [row0](int e) { return row0 + 128 * (e >> 2) + (e & 3); };
      unsigned rows = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) rows |= static_cast<unsigned>(row(e) != taken) << e;
      top.offer(x, row, rows, k, lane);
    }
  } else {
    // any tile: warp w's lane l reads rows 32w + l + 32 kTileWarps i with
    // 4-byte and 1-byte loads, 8 a batch
    constexpr int kStride = 32 * kTileWarps;
    for (int j0 = 32 * w + lane; j0 < tile + 32 * w + lane; j0 += kStride * 8) {
      float x[8];
      unsigned rows = 0;  // the rows still inside the tile
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + kStride * u;
        const int64_t r = base + j;
        x[u] = -INFINITY;
        if (j < tile && r < n && r < n_valid && mask[r]) x[u] = scores[r];
        rows |= static_cast<unsigned>(j < tile) << u;
      }
      const int row0 = static_cast<int>(base) + j0;
      top.offer(x, [row0](int e) { return row0 + kStride * e; }, rows, k, lane);
    }
  }
  // the warps' lists meet in shared memory; warp 0 takes the best k: one
  // sort of all of them where they fit a lane each, else it offers the
  // others' entries as rows
  if (lane < k) { part_v[w][lane] = top.wv; part_i[w][lane] = top.wi; }
  __syncthreads();
  if (w > 0) return;
  if (kTileWarps * k <= 32) {
    const bool held = lane < kTileWarps * k;
    float v = held ? part_v[lane / k][lane % k] : -INFINITY;
    int i = held ? part_i[lane / k][lane % k] : INT_MAX;
    warp_sort(v, i, lane);
    if (lane < k) { out_v[t * k + lane] = v; out_i[t * k + lane] = i; }
    return;
  }
  float x[kTileWarps - 1];
  int idx[kTileWarps - 1];
#pragma unroll
  for (int v = 1; v < kTileWarps; ++v) {
    x[v - 1] = lane < k ? part_v[v][lane] : -INFINITY;
    idx[v - 1] = lane < k ? part_i[v][lane] : INT_MAX;
  }
  top.offer(x, [&idx](int e) { return idx[e]; }, lane < k ? ~0u : 0u, k, lane);
  if (lane < k) { out_v[t * k + lane] = top.wv; out_i[t * k + lane] = top.wi; }
}

__global__ void __launch_bounds__(kThreads)
block_topk_rounds_kernel(const float* __restrict__ scores,
                         const uint8_t* __restrict__ mask, int64_t n,
                         int64_t n_valid, int k, int tile,
                         float* __restrict__ out_v, int32_t* __restrict__ out_i) {
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

// The best head of this thread's lists (blocks b = threadIdx.x, +
// kMergeThreads, ...), as (value, global index, block).
__device__ __forceinline__ void best_head(const float* vals, const int32_t* idx,
                                          const int* heads, int nb, int k,
                                          float& bv, int& bi, int& bb) {
  bv = -INFINITY;
  bi = INT_MAX;
  bb = -1;
  for (int b = threadIdx.x; b < nb; b += kMergeThreads) {
    const int h = heads[b];
    if (h >= k) continue;
    const int64_t c = static_cast<int64_t>(b) * k + h;
    if (before(vals[c], idx[c], bv, bi)) { bv = vals[c]; bi = idx[c]; bb = b; }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* __restrict__ vals,
                  const int32_t* __restrict__ idx, int nb, int k,
                  int* __restrict__ heads, float* __restrict__ out_v,
                  int32_t* __restrict__ out_i) {
  __shared__ float red_v[kMergeWarps];
  __shared__ int red_i[kMergeWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // a thread alone reads and writes its own blocks' heads
  for (int b = threadIdx.x; b < nb; b += kMergeThreads) heads[b] = 0;
  float mv;
  int mi, mb;
  best_head(vals, idx, heads, nb, k, mv, mi, mb);
  for (int r = 0; r < k; ++r) {
    float bv = mv;
    int bi = mi;
    warp_best(bv, bi);
    if (lane == 0) { red_v[w] = bv; red_i[w] = bi; }
    __syncthreads();
    bv = lane < kMergeWarps ? red_v[lane] : -INFINITY;
    bi = lane < kMergeWarps ? red_i[lane] : INT_MAX;
    warp_best(bv, bi);  // every warp: the block's best
    if (threadIdx.x == 0) { out_v[r] = bv; out_i[r] = bi; }
    if (mb >= 0 && mi == bi) {
      heads[mb] += 1;
      best_head(vals, idx, heads, nb, k, mv, mi, mb);
    }
    __syncthreads();  // red_v / red_i are rewritten next round
  }
}

int launch_block(const float* scores, const uint8_t* mask, int64_t n,
                 int64_t n_valid, int k, int tile, int nb, float* out_v,
                 int32_t* out_i, cudaStream_t stream) {
  const int vec = (reinterpret_cast<uintptr_t>(scores) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  block_topk_kernel<<<nb, kTileWarps * 32, 0, stream>>>(
      scores, mask, n, n_valid, k, tile, vec, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scores: (n,) float32; mask: (n,) bool as uint8; out_v / out_i: (nb, k)
// with nb = ceil(n / tile); requires 1 <= k <= tile.
extern "C" int tk_block_topk(const float* scores, const uint8_t* mask,
                             int64_t n, int64_t n_valid, int k, int tile,
                             int nb, float* out_v, int32_t* out_i,
                             cudaStream_t stream) {
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= kTopkMax)
    return launch_block(scores, mask, n, n_valid, k, tile, nb, out_v, out_i, stream);
  const size_t smem = static_cast<size_t>(tile) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(block_topk_rounds_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  block_topk_rounds_kernel<<<nb, kThreads, smem, stream>>>(
      scores, mask, n, n_valid, k, tile, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

// vals / idx: (nb, k) candidates, each block's list in (value desc, index
// asc) order; heads: nb int32 of scratch; out_v / out_i: (k,), the k best
// by (value desc, global index asc). nb >= 1.
extern "C" int tk_topk_merge(const float* vals, const int32_t* idx, int nb,
                             int k, int* heads, float* out_v, int32_t* out_i,
                             cudaStream_t stream) {
  topk_merge_kernel<<<1, kMergeThreads, 0, stream>>>(vals, idx, nb, k, heads, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}
