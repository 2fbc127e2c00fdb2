// Flash-decode: one-token GQA attention of q (B,H,D) against a KV cache
// k, v (B,KV,S,D), masking cache positions >= lengths[b]; out (B,H,D) in
// the input's dtype, contiguous. bf16 or float32. q, k and v are read
// through the element strides of their leading dimensions (the last has
// stride 1; every other stride and base is 16-byte aligned), so the
// decode path hands over the (B,KV,S,D) transposed view of its layer's
// (B,S,KV,D) cache and nothing is copied.
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py:flash_decode, whose grid (B, KV, S/BK)
// streams cache blocks sequentially with one online-softmax state per
// (kv head x its G q heads).
//
// Here the cache walk is split, flash-decoding style, in two kernels on
// the caller's stream:
//  - flash_decode_split_kernel: one block per (b, kv head, split of `split`
//    slots, group of up to 8 q heads), so B*KV*splits blocks fill the SMs
//    however small B*KV is. Each row of the cache is read by D*size/16
//    lanes with one 16-byte load each (8 lanes for a 64-dim bf16 row, so
//    one warp load covers 4 neighbouring rows), the dot product reduced
//    with shuffles; every lane group takes U rows per step (8 for one q
//    head per kv head, fewer for more), so 2U 16-byte streaming loads per
//    lane are in flight. Each lane group keeps its own (m, l,
//    acc) in float32 registers; the groups merge by shuffles, the 4 warps
//    in shared memory, and the block writes its partial (m, l, acc) to
//    float32 scratch the wrapper allocates.
//  - flash_decode_merge_kernel: one warp per (b, h) rescales the partials
//    by exp(m_s - max m) and writes out = sum acc / sum l.
// The walk stops at the length: a split reads only slots below
// min(lengths[b], S), and a split wholly past it exits at once and is not
// read by the merge (it adds nothing). Skipping is exact: masked slots
// score -1e30, whose exp is exactly 0 once any real score exists. A length
// of 0 (or less) masks every slot alike, so the reference gives the
// uniform mean of V over all S slots: the walk then covers all S, every
// score -1e30, every p 1. A lane group with no rows keeps m = -inf and
// l = 0; each merge rescales against a finite reference, so no NaN.
// q is scaled by 1/sqrt(D) on the float32 score, as ref.py:134-147. float32
// inputs take the same design (4 floats per 16-byte load).
//
// Bound on the H100: bytes — the cache slots below each length are read
// once (at B=32, KV=8, S=4096, D=64 in bf16 with every length = S: 268 MB,
// 80 us at 3.35 TB/s); the operations are 4*H*D per slot read, one FMA per
// cache byte. The partials are B*H*splits*(D+2) floats, written and read
// once (1 MB at that shape, 8 splits). Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700 W: 0.094 ms for both kernels at that shape
// (1.17x the bound).
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kDecThreads = 128;  // 4 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxG = 8;          // q heads per block
constexpr float kMasked = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of a row as float32: 8 bf16 or 4 float values.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void cvt(const uint4& x, float* o) {
    o[0] = __uint_as_float(x.x); o[1] = __uint_as_float(x.y);
    o[2] = __uint_as_float(x.z); o[3] = __uint_as_float(x.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void cvt(const uint4& x, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// The cache is read once: streaming loads (evict first).
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// Slots a row of lengths walks: below the length, or all S for length <= 0.
__device__ __forceinline__ int walk_end(int len, int S) {
  return len > 0 ? min(len, S) : S;
}

// Merge (mo, lo, ao) into (m, l, a); either side may be empty (m = -inf).
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&a)[N],
                                            float mo, float lo, const float (&ao)[N]) {
  const float mx = fmaxf(m, mo);
  const float ref = mx == -INFINITY ? 0.f : mx;
  const float f = __expf(m - ref), fo = __expf(mo - ref);
  l = l * f + lo * fo;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * f + ao[e] * fo;
  m = mx;
}

// Element strides of q's (B, H) and of k's and v's (B, KV, S) dimensions.
struct DecStrides {
  int64_t qb, qh, kb, kh, ks, vb, vh, vs;
};

template <typename T, int D, int GM, int U>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int32_t* __restrict__ lengths,
                          float* __restrict__ part_acc, float* __restrict__ part_ml,
                          int H, int KV, int S, int split, int n_split, float scale,
                          DecStrides st) {
  constexpr int VN = Vec<T>::N;     // elements per 16-byte load
  constexpr int LPR = D / VN;       // lanes per cache row
  constexpr int RPW = 32 / LPR;     // rows per warp load
  constexpr int STEP = kDecWarps * RPW * U;  // rows per block step
  __shared__ float Ms[kDecWarps][GM], Ls[kDecWarps][GM];
  __shared__ float As[kDecWarps][GM][D];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPR, sub = lane - grp * LPR;
  const int b = blockIdx.x / KV, kvh = blockIdx.x - b * KV;
  const int sp = blockIdx.y;
  const int G = H / KV;
  const int g0 = blockIdx.z * GM;
  const int ng = min(GM, G - g0);
  const int len = lengths[b];
  const int s0 = sp * split;
  const int s1 = min(s0 + split, walk_end(len, S));
  if (s0 >= s1) return;  // wholly past the length: the merge skips it
  const bool live = len > 0;  // else every slot scores -1e30

  const int64_t qh0 = static_cast<int64_t>(b) * H + kvh * G + g0;  // scratch row
  const T* qb = q + b * st.qb + static_cast<int64_t>(kvh * G + g0) * st.qh + sub * VN;
  float qv[GM][VN];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < ng) {
      Vec<T>::cvt(*reinterpret_cast<const uint4*>(qb + g * st.qh), qv[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) qv[g][e] = 0.f;
    }
  }
  float m[GM], l[GM], acc[GM][VN];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[g][e] = 0.f;
  }

  const T* kb = k + b * st.kb + kvh * st.kh + sub * VN;
  const T* vb = v + b * st.vb + kvh * st.vh + sub * VN;
  for (int base = s0; base < s1; base += STEP) {
    uint4 kr[U], vr[U];  // raw rows: 2U 16-byte loads in flight per lane
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + (u * kDecWarps + warp) * RPW + grp;
      ok[u] = pos < s1;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        kr[u] = load16(kb + pos * st.ks);
        vr[u] = load16(vb + pos * st.vs);
      }
    }
    float kx[U][VN], vx[U][VN];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Vec<T>::cvt(kr[u], kx[u]);
      Vec<T>::cvt(vr[u], vx[u]);
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float s[U];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VN; ++e) dot = fmaf(qv[g][e], kx[u][e], dot);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(kFullMask, dot, o);
        s[u] = !ok[u] ? -INFINITY : (live ? dot * scale : kMasked);
        mx = fmaxf(mx, s[u]);
      }
      const float ref = mx == -INFINITY ? 0.f : mx;
      const float alpha = __expf(m[g] - ref);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = __expf(s[u] - ref);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[g][e] = fmaf(p, vx[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // the warp's lane groups (lanes differing by LPR, 2 LPR, ...) merge
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      float ao[VN];
#pragma unroll
      for (int e = 0; e < VN; ++e) ao[e] = __shfl_xor_sync(kFullMask, acc[g][e], o);
      const float mo = __shfl_xor_sync(kFullMask, m[g], o);
      const float lo = __shfl_xor_sync(kFullMask, l[g], o);
      merge_state(m[g], l[g], acc[g], mo, lo, ao);
    }
    if (grp == 0) {
      if (sub == 0) {
        Ms[warp][g] = m[g];
        Ls[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) As[warp][g][sub * VN + e] = acc[g][e];
    }
  }
  __syncthreads();
  // the four warps merge; warp 0 read slot s0, so mx is finite
  for (int i = threadIdx.x; i < ng * D; i += kDecThreads) {
    const int g = i / D, d = i - g * D;
    float mx = Ms[0][g];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) mx = fmaxf(mx, Ms[w][g]);
    float lt = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = __expf(Ms[w][g] - mx);
      lt = fmaf(Ls[w][g], f, lt);
      a = fmaf(As[w][g][d], f, a);
    }
    const int64_t slot = (qh0 + g) * n_split + sp;
    part_acc[slot * D + d] = a;
    if (d == 0) {
      part_ml[2 * slot] = mx;
      part_ml[2 * slot + 1] = lt;
    }
  }
}

// One warp per (b, h): out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M)
// over the splits that lie below the length.
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_merge_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int32_t* __restrict__ lengths, T* __restrict__ out,
                          int BH, int H, int S, int D, int split, int n_split) {
  const int w = blockIdx.x * kDecWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= BH) return;
  const int n_used = (walk_end(lengths[w / H], S) + split - 1) / split;
  const float* ml = part_ml + static_cast<int64_t>(w) * n_split * 2;
  const float* pa = part_acc + static_cast<int64_t>(w) * n_split * D;
  float mx = -INFINITY;
  for (int s = 0; s < n_used; ++s) mx = fmaxf(mx, ml[2 * s]);
  float lt = 0.f;
  for (int s = 0; s < n_used; ++s) lt = fmaf(ml[2 * s + 1], expf(ml[2 * s] - mx), lt);
  const float inv = 1.f / fmaxf(lt, 1e-30f);
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
    for (int s = 0; s < n_used; ++s) a = fmaf(pa[s * D + d], expf(ml[2 * s] - mx), a);
    out[static_cast<int64_t>(w) * D + d] = from_f<T>(a * inv);
  }
}

template <typename T, int D, int GM>
int launch_decode(const void* q, const void* k, const void* v,
                  const int32_t* lengths, void* out, float* part_acc,
                  float* part_ml, int B, int H, int KV, int S, int split,
                  float scale, const DecStrides& st, cudaStream_t stream) {
  constexpr int U = GM == 1 ? 8 : GM == 2 ? 4 : 2;  // rows per lane group per step
  const int G = H / KV;
  const int n_split = (S + split - 1) / split;
  const dim3 grid(B * KV, n_split, (G + GM - 1) / GM);
  flash_decode_split_kernel<T, D, GM, U><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_ml, H, KV, S, split,
      n_split, scale, st);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int BH = B * H;
  flash_decode_merge_kernel<T><<<(BH + kDecWarps - 1) / kDecWarps, kDecThreads, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<T*>(out), BH, H, S, D, split, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(const void* q, const void* k, const void* v,
               const int32_t* lengths, void* out, float* pa, float* pm, int B,
               int H, int KV, int S, int split, float scale, const DecStrides& st,
               cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1) return launch_decode<T, D, 1>(q, k, v, lengths, out, pa, pm, B, H, KV, S, split, scale, st, stream);
  if (G <= 2) return launch_decode<T, D, 2>(q, k, v, lengths, out, pa, pm, B, H, KV, S, split, scale, st, stream);
  if (G <= 4) return launch_decode<T, D, 4>(q, k, v, lengths, out, pa, pm, B, H, KV, S, split, scale, st, stream);
  return launch_decode<T, D, kMaxG>(q, k, v, lengths, out, pa, pm, B, H, KV, S, split, scale, st, stream);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int32_t* lengths, void* out, float* pa, float* pm, int B,
               int H, int KV, int S, int split, float scale, const DecStrides& st,
               cudaStream_t stream) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(q, k, v, lengths, out, pa, pm, B, H, KV, S, split, scale, st, stream);
    case 32: return dispatch_g<T, 32>(q, k, v, lengths, out, pa, pm, B, H, KV, S, split, scale, st, stream);
    case 64: return dispatch_g<T, 64>(q, k, v, lengths, out, pa, pm, B, H, KV, S, split, scale, st, stream);
    case 128: return dispatch_g<T, 128>(q, k, v, lengths, out, pa, pm, B, H, KV, S, split, scale, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. D in {16, 32, 64, 128}; H % KV == 0;
// S >= 1; lengths (B,) int32; split >= 1 slots per split, at most 65535
// splits; part_acc (B*H*splits*D) and part_ml (B*H*splits*2) float32
// scratch; out (B,H,D) contiguous. strides: 8 element strides, q's (B, H),
// then k's and v's (B, KV, S) (each last dimension has stride 1; every
// stride a multiple of 16 bytes and every base 16-byte aligned). Returns
// cudaGetLastError() after the two launches.
extern "C" int fd_flash_decode(const void* q, const void* k, const void* v,
                               const int32_t* lengths, void* out,
                               float* part_acc, float* part_ml, int dtype,
                               int B, int H, int KV, int S, int D, int split,
                               const int64_t* strides, float scale,
                               cudaStream_t stream) {
  if (B * H == 0) return static_cast<int>(cudaGetLastError());
  const DecStrides st{strides[0], strides[1], strides[2], strides[3],
                      strides[4], strides[5], strides[6], strides[7]};
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, lengths, out, part_acc, part_ml, B, H, KV, S, split, scale, st, stream);
  return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, out, part_acc, part_ml, B, H, KV, S, split, scale, st, stream);
}
