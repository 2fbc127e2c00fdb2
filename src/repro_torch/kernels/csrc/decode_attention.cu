// Flash-decode: one-token GQA attention of q (B,H,D) against a KV cache
// k, v (B,KV,S,D), masking cache positions >= lengths[b]; out (B,H,D) in
// the input's dtype. bf16 or float32, all contiguous.
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py:flash_decode, whose grid (B, KV, S/BK)
// streams cache blocks sequentially with one online-softmax state per
// (kv head x its G q heads). Here one thread block owns one (b, kv head) and
// up to 8 of its q heads (more heads take more blocks along grid.y). Its 4
// warps split the cache: warp w walks tiles w, w+4, ... of 32 positions,
// lane j scoring position j of the tile against every q head (reading the
// key row straight from device memory, 16 bytes at a time), then adding
// P.V with lane j owning head dims j, j+32, ... Each warp keeps its own
// (m, l, acc) in registers; the four states are merged once at the end in
// shared memory. Q.K^T and P.V are this kernel's own float32 FMAs.
//
// Arithmetic as the reference (kernels/ref.py:134-147 and the Pallas
// body): q scaled by 1/sqrt(D) in float32, positions >= lengths[b] score
// -1e30, every cache block is walked. A length of 0 therefore masks every
// slot with the same -1e30 and the output is the uniform mean of V over all
// S slots, as the reference gives. Slots past S in the last tile score
// -inf and get probability exactly 0.
//
// Bound on the H100: bytes — the cache is read once (at B=32, KV=8,
// S=4096, D=64 in bf16: 268 MB, 80 us at 3.35 TB/s); the operations are
// 4*B*H*S*D, one FMA per cache byte. What this simple design leaves for a
// later PR: bounding the walk by lengths[b] (the reads past the length are
// wasted bytes), splitting S across blocks when B*KV is below the 132 SMs,
// and wider loads of V.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kDecThreads = 128;  // 4 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kTile = 32;         // cache positions per warp step (one per lane)
constexpr int kMaxG = 8;          // q heads per block
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// 16 bytes of a row as float32: 8 bf16 or 4 float values.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int D, int GM>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int32_t* __restrict__ lengths,
                    T* __restrict__ out, int H, int KV, int S, float scale) {
  constexpr int ND = (D + 31) / 32;
  constexpr int VN = Vec<T>::N;
  __shared__ __align__(16) float Qs[GM * D];
  __shared__ float Ms[kDecWarps][GM], Ls[kDecWarps][GM];
  __shared__ float As[kDecWarps][GM][D];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int g0 = blockIdx.y * GM;          // first q head (within the group)
  const int ng = min(GM, G - g0);
  const int len = lengths[b];
  const int64_t qh0 = static_cast<int64_t>(b) * H + kvh * G + g0;
  const T* kb = k + (static_cast<int64_t>(b) * KV + kvh) * S * D;
  const T* vb = v + (static_cast<int64_t>(b) * KV + kvh) * S * D;

  for (int i = tid; i < GM * D; i += kDecThreads)
    Qs[i] = i / D < ng ? to_f(q[qh0 * D + i]) * scale : 0.f;
  __syncthreads();

  float m[GM], l[GM], acc[GM][ND];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[g][c] = 0.f;
  }

  const int n_tiles = (S + kTile - 1) / kTile;
  for (int t = warp; t < n_tiles; t += kDecWarps) {
    const int pos = t * kTile + lane;
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    if (pos < S) {
      const T* krow = kb + static_cast<int64_t>(pos) * D;
#pragma unroll
      for (int d = 0; d < D; d += VN) {
        float kv[VN];
        Vec<T>::load(krow + d, kv);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < VN; ++e) s[g] = fmaf(Qs[g * D + d + e], kv[e], s[g]);
      }
    }
    float p[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (pos >= S) s[g] = -INFINITY;       // past the cache: probability 0
      else if (pos >= len) s[g] = kMasked;
      const float m_new = fmaxf(m[g], warp_max_f(s[g]));
      p[g] = expf(s[g] - m_new);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] = l[g] * alpha + p[g];
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[g][c] *= alpha;
    }
    const int nj = min(kTile, S - t * kTile);
    for (int j = 0; j < nj; ++j) {
      const T* vrow = vb + (static_cast<int64_t>(t) * kTile + j) * D;
      float vv[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? to_f(vrow[d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float pj = __shfl_sync(kFullMask, p[g], j);
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[g][c] = fmaf(pj, vv[c], acc[g][c]);
      }
    }
  }

  // merge the four warps' states
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const float lt = warp_sum_f(l[g]);
    if (lane == 0) {
      Ms[warp][g] = m[g];
      Ls[warp][g] = lt;
    }
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < D) As[warp][g][d] = acc[g][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += kDecThreads) {
    const int g = i / D, d = i - g * D;
    float mx = Ms[0][g];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) mx = fmaxf(mx, Ms[w][g]);
    float lt = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = expf(Ms[w][g] - mx);
      lt = fmaf(Ls[w][g], f, lt);
      a = fmaf(As[w][g][d], f, a);
    }
    out[qh0 * D + i] = from_f<T>(a / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int D, int GM>
int launch_decode(const void* q, const void* k, const void* v,
                  const int32_t* lengths, void* out, int B, int H, int KV,
                  int S, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const dim3 grid(B * KV, (G + GM - 1) / GM);
  flash_decode_kernel<T, D, GM><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), H, KV, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(const void* q, const void* k, const void* v,
               const int32_t* lengths, void* out, int B, int H, int KV, int S,
               float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1) return launch_decode<T, D, 1>(q, k, v, lengths, out, B, H, KV, S, scale, stream);
  if (G <= 2) return launch_decode<T, D, 2>(q, k, v, lengths, out, B, H, KV, S, scale, stream);
  if (G <= 4) return launch_decode<T, D, 4>(q, k, v, lengths, out, B, H, KV, S, scale, stream);
  return launch_decode<T, D, kMaxG>(q, k, v, lengths, out, B, H, KV, S, scale, stream);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int32_t* lengths, void* out, int B, int H, int KV, int S,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(q, k, v, lengths, out, B, H, KV, S, scale, stream);
    case 32: return dispatch_g<T, 32>(q, k, v, lengths, out, B, H, KV, S, scale, stream);
    case 64: return dispatch_g<T, 64>(q, k, v, lengths, out, B, H, KV, S, scale, stream);
    case 128: return dispatch_g<T, 128>(q, k, v, lengths, out, B, H, KV, S, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. D in {16, 32, 64, 128}; H % KV == 0;
// S >= 1; lengths (B,) int32. Returns cudaGetLastError() after the launch.
extern "C" int fd_flash_decode(const void* q, const void* k, const void* v,
                               const int32_t* lengths, void* out, int dtype,
                               int B, int H, int KV, int S, int D, float scale,
                               cudaStream_t stream) {
  if (B * H == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, lengths, out, B, H, KV, S, scale, stream);
  return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, out, B, H, KV, S, scale, stream);
}
