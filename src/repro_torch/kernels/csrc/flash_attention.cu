// Causal / non-causal GQA flash-attention forward: out (B,H,Sq,D) in the
// input's dtype and lse (B,H,Sq) float32, for q (B,H,Sq,D) and k, v
// (B,KV,Skv,D), all contiguous, bf16 or float32.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py:flash_mha_fwd, whose grid walks KV
// blocks sequentially per (b, h, q block) with (m, l, acc) in VMEM scratch.
// Here one thread block owns one (b, h, 64-row q tile) and the KV walk is a
// loop inside it: K and V tiles of 32 keys are staged in shared memory as
// float32, and the online-softmax state stays in registers. Warp w owns q
// rows 16w..16w+15 of the tile; in Q.K^T lane j scores key j of the tile
// against the warp's 16 rows, and in P.V lane j owns head dims j, j+32, ...
// (the probabilities pass through shared memory). Q.K^T and P.V are this
// kernel's own float32 FMAs: no tensor cores, no library.
//
// Arithmetic as the reference (kernels/flash_attention.py:31-69): q scaled
// by 1/sqrt(D) in float32 before the dot, causal means qpos >= kpos with
// both positions from 0, masked scores are -1e30 (never -inf, so a fully
// masked tile gives no NaN), l is clamped at 1e-30, lse = m + log(l). KV
// tiles past the causal limit are never read. Unlike the Pallas body, which
// asserts Sq % bq == 0, a ragged last q tile and a ragged last KV tile are
// masked here: padding keys score -inf, so they get probability exactly 0.
//
// Bound on the H100 at the main path's shape (q, k, v 2048x8x128x64 bf16,
// causal, one call per layer and microbatch): q, k, v and out are 1.07 GB,
// 0.32 ms at 3.35 TB/s, against 2*2*B*H*Sq*Skv*D/2 = 34 GFLOP, 0.035 ms at
// the 989 TFLOP/s bf16 tensor-core rate — so by the bytes. This kernel
// does its products on the float32 FMA units (67 TFLOP/s peak, 0.51 ms for
// those operations), so the FMA rate, not the bytes, limits it. What it
// leaves for a later PR: mma/wgmma tiles over bf16 operands (float32 inputs
// stay on the FMA path), TMA and a double-buffered K/V ring, a strided read
// of the (B,S,H,D) projections in place of the caller's transpose copy.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kFlashThreads = 128;           // 4 warps
constexpr int kRowsPerWarp = 16;
constexpr int kBQ = 4 * kRowsPerWarp;        // q rows per block
constexpr int kBK = 32;                      // keys per KV tile (one per lane)
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

// Shared memory (float32): Q tile (kBQ, D), K tile (kBK, D+1) padded so
// lane j's row reads hit distinct banks, V tile (kBK, D), and per warp the
// probabilities (kRowsPerWarp, kBK).
template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D +
                          4 * kRowsPerWarp * kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int KV, int Sq, int Skv,
                 float scale, int causal) {
  constexpr int ND = (D + 31) / 32;  // head dims per lane in P.V
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * D;
  float* Vs = Ks + kBK * (D + 1);
  float* Ps = Vs + kBK * D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;              // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kBQ;
  const T* qb = q + (static_cast<int64_t>(bh) * Sq) * D;
  const T* kb = k + (static_cast<int64_t>(b) * KV + kvh) * Skv * D;
  const T* vb = v + (static_cast<int64_t>(b) * KV + kvh) * Skv * D;

  for (int i = tid; i < kBQ * D; i += kFlashThreads) {
    const int r = i / D;
    Qs[i] = q0 + r < Sq ? to_f(qb[static_cast<int64_t>(q0) * D + i]) * scale : 0.f;
  }

  const int r0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][ND];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[r][c] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  float* Pw = Ps + warp * kRowsPerWarp * kBK;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done (and Qs is in)
    for (int i = tid; i < kBK * D; i += kFlashThreads) {
      const int j = i / D, d = i - j * D;
      const bool in = k0 + j < Skv;
      const int64_t off = static_cast<int64_t>(k0) * D + i;
      Ks[j * (D + 1) + d] = in ? to_f(kb[off]) : 0.f;
      Vs[i] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float k0v = krow[d], k1v = krow[d + 1], k2v = krow[d + 2],
                  k3v = krow[d + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + r) * D + d);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + r0 + r;
      if (kpos >= Skv) s[r] = -INFINITY;            // padding: probability 0
      else if (causal && qpos < kpos) s[r] = kMasked;
      const float m_new = fmaxf(m[r], warp_max_f(s[r]));
      const float p = expf(s[r] - m_new);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[r][c] *= alpha;
      Pw[r * kBK + lane] = p;
    }
    __syncwarp();

    // acc += P . V over the tile's keys, lane owning dims lane + 32c
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][ND];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < D ? Vs[(j + jj) * D + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pw + r * kBK + j);
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          float a = acc[r][c];
          a = fmaf(p4.x, vv[0][c], a);
          a = fmaf(p4.y, vv[1][c], a);
          a = fmaf(p4.z, vv[2][c], a);
          a = fmaf(p4.w, vv[3][c], a);
          acc[r][c] = a;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + r0 + r;
    const float lt = fmaxf(warp_sum_f(l[r]), 1e-30f);
    if (qpos >= Sq) continue;
    T* orow = out + (static_cast<int64_t>(bh) * Sq + qpos) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_f<T>(acc[r][c] / lt);
    }
    if (lane == 0) lse[static_cast<int64_t>(bh) * Sq + qpos] = m[r] + logf(lt);
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int H, int KV, int Sq, int Skv,
                 float scale, int causal, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, KV, Sq, Skv,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int KV, int Sq, int Skv, float scale,
               int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_flash<T, 16>(q, k, v, out, lse, B, H, KV, Sq, Skv, scale, causal, stream);
    case 32: return launch_flash<T, 32>(q, k, v, out, lse, B, H, KV, Sq, Skv, scale, causal, stream);
    case 64: return launch_flash<T, 64>(q, k, v, out, lse, B, H, KV, Sq, Skv, scale, causal, stream);
    case 128: return launch_flash<T, 128>(q, k, v, out, lse, B, H, KV, Sq, Skv, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. D in {16, 32, 64, 128}; H % KV == 0;
// at most 65535 q tiles (Sq <= 4,194,240). Returns cudaGetLastError() after
// the launch.
extern "C" int fa_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, float* lse, int dtype, int B, int H,
                            int KV, int Sq, int Skv, int D, float scale,
                            int causal, cudaStream_t stream) {
  if (B * H == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, lse, B, H, KV, Sq, Skv, scale, causal, stream);
  return dispatch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, H, KV, Sq, Skv, scale, causal, stream);
}
