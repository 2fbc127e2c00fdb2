// Causal / non-causal GQA flash-attention backward (B7): dq (B,H,Sq,D),
// dk and dv (B,KV,Skv,D) in the inputs' dtypes from q, out, dO (B,H,Sq,D),
// k, v (B,KV,Skv,D) and the forward's lse (B,H,Sq) float32. Every operand
// is addressed through its (B, H, S) strides with a unit last stride, as
// the forward's (flash_attention.cu), so the model path's (B,S,H,D)
// projections and gradients are read and written in place.
//
// Replaces the reference's VJP of the flash forward, which is jnp and not
// Pallas: repro/kernels/ops.py:_flash_bwd_rule, the custom_vjp backward of
// B5 (repro/kernels/flash_attention.py:flash_mha_fwd). Arithmetic as
// there: the probabilities are recomputed from lse,
//   p = exp(s * scale - lse), s = q.k, masked (causal: qpos < kpos, both
//   from 0) to exactly 0,
//   delta = rowsum(dO * out), ds = p * (dO.v - delta),
//   dq = ds.K * scale, dk = ds^T.Q * scale, dv = p^T.dO,
// dk and dv summed over the G = H / KV q heads of their KV head. Nothing of
// size Sq x Skv is kept. Accumulation is float32 throughout.
//
// Three kernels, no atomics (every output element is written by one
// thread, so the result is the same bit for bit from run to run):
//   flash_bwd_delta_kernel   one warp per (b, h, q row): delta;
//   dq:   one block per (b, h, 64-row q tile), looping over the key tiles
//         the causal mask lets through;
//   dk/dv: one block per (b, kv head, 64-key tile), looping over the G
//         heads of the group and the q tiles at or past the tile's first
//         key (causal), dk and dv in float32 registers.
// bf16 (the model path): the products run on the tensor cores,
// mma.sync.m16n8k16 over bf16 fragments fed by ldmatrix from padded shared
// rows (mma_bf16.cuh, as the forward). 4 warps, each owning 16 rows (q rows
// in the dq kernel, keys in the dk/dv kernel). p and ds are rounded to
// bf16 pairs in registers and used directly as the A fragments of ds.K,
// p^T.dO and ds^T.Q, as the forward feeds P to P.V. The dk/dv kernel takes
// q tiles of 32 rows, which keeps its two 16 x D float32 accumulators and
// the scores in registers at D = 128. A tile is loaded, then used: no
// copy is in flight while a block computes.
// float32: one warp per q row (dq) or per key (dk/dv), lane = head dim,
// the dot products by warp shuffles; float32 is off the model path.
//
// Bound on the H100 at the training shape (B 4, H 16, KV 8, S 2,048, D 128,
// bf16, causal): 2.5 x the forward's 2 * 2 * B * H * S * S * D / 2 = 68.7
// GFLOP, i.e. 172 GFLOP (the five products q.k, dO.v, ds.K, ds^T.Q, p^T.dO
// over the causal half), 0.17 ms at the 989 TFLOP/s bf16 tensor-core rate,
// against q, out, dO, dq (33.5 MB each), k, v, dk, dv (16.8 MB each) and
// lse read or written once, 0.2 GB, 0.06 ms at 3.35 TB/s: so by the
// operations. Measured by chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700 W: 1.56 ms at that shape (dk/dv 0.97, dq 0.56,
// delta 0.03), 9x the bound and 3.1x the backward of PyTorch's SDPA. A
// block that waits for each tile keeps no load in flight while its
// tensor cores run; pipelined loads, wgmma with TMA and a fused single
// pass are left for a later change.
#include "common.cuh"
#include "mma_bf16.cuh"

#include <cuda_bf16.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kThreadsB = 128;  // 4 warps
constexpr int kTile = 64;       // q rows of a dq block, keys of a dk/dv block
constexpr int kQB = 32;         // q rows a bf16 dk/dv block takes at a time
constexpr int kRowWarps = 8;    // rows (warps) of a delta block

// Element strides of the (B, H, S) dimensions of every operand.
struct BwdStrides {
  int64_t q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s,
      do_b, do_h, do_s, dq_b, dq_h, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float allsum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// ---- delta = rowsum(dO * out), float32 -------------------------------------

template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dO,
                       float* __restrict__ delta, int H, int Sq, int D,
                       BwdStrides st, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t bh = row / Sq;
  const int i = static_cast<int>(row - bh * Sq);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh - static_cast<int64_t>(b) * H);
  const T* o = out + b * st.o_b + h * st.o_h + i * st.o_s;
  const T* d = dO + b * st.do_b + h * st.do_h + i * st.do_s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
  acc = allsum(acc);
  if (lane == 0) delta[row] = acc;
}

// ---- float32: one warp per row ---------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreadsB)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int KV, int Sq, int Skv,
                        BwdStrides st, float scale, int causal, int64_t rows) {
  constexpr int ND = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreadsB / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t bh = row / Sq;
  const int i = static_cast<int>(row - bh * Sq);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh - static_cast<int64_t>(b) * H);
  const int kvh = h / (H / KV);
  const float* qr = q + b * st.q_b + h * st.q_h + i * st.q_s;
  const float* dr = dO + b * st.do_b + h * st.do_h + i * st.do_s;
  const float* kb = k + b * st.k_b + kvh * st.k_h;
  const float* vb = v + b * st.v_b + kvh * st.v_h;
  float qv[ND], dv[ND], acc[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const int d = lane + 32 * c;
    qv[c] = d < D ? qr[d] : 0.f;
    dv[c] = d < D ? dr[d] : 0.f;
    acc[c] = 0.f;
  }
  const float l = lse[row], dl = delta[row];
  const int kv_end = causal ? min(Skv, i + 1) : Skv;
  for (int j = 0; j < kv_end; ++j) {
    const float* kr = kb + j * st.k_s;
    const float* vr = vb + j * st.v_s;
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        s = fmaf(qv[c], kr[d], s);
        dp = fmaf(dv[c], vr[d], dp);
      }
    }
    s = allsum(s);
    dp = allsum(dp);
    const float ds = expf(s * scale - l) * (dp - dl);
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < D) acc[c] = fmaf(ds, kr[d], acc[c]);
    }
  }
  float* out = dq + b * st.dq_b + h * st.dq_h + i * st.dq_s;
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const int d = lane + 32 * c;
    if (d < D) out[d] = acc[c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsB)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dO,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
                          int Sq, int Skv, BwdStrides st, float scale, int causal,
                          int64_t rows) {
  constexpr int ND = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreadsB / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t bk = row / Skv;
  const int j = static_cast<int>(row - bk * Skv);
  const int b = static_cast<int>(bk / KV), kvh = static_cast<int>(bk - static_cast<int64_t>(b) * KV);
  const int G = H / KV;
  const float* kr = k + b * st.k_b + kvh * st.k_h + j * st.k_s;
  const float* vr = v + b * st.v_b + kvh * st.v_h + j * st.v_s;
  float kv[ND], vv[ND], dka[ND], dva[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const int d = lane + 32 * c;
    kv[c] = d < D ? kr[d] : 0.f;
    vv[c] = d < D ? vr[d] : 0.f;
    dka[c] = dva[c] = 0.f;
  }
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qb = q + b * st.q_b + h * st.q_h;
    const float* db = dO + b * st.do_b + h * st.do_h;
    const float* lrow = lse + (static_cast<int64_t>(b) * H + h) * Sq;
    const float* drow = delta + (static_cast<int64_t>(b) * H + h) * Sq;
    for (int i = causal ? j : 0; i < Sq; ++i) {
      const float* qr = qb + i * st.q_s;
      const float* dr = db + i * st.do_s;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          s = fmaf(qr[d], kv[c], s);
          dp = fmaf(dr[d], vv[c], dp);
        }
      }
      s = allsum(s);
      dp = allsum(dp);
      const float p = expf(s * scale - lrow[i]);
      const float ds = p * (dp - drow[i]);
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          dva[c] = fmaf(p, dr[d], dva[c]);
          dka[c] = fmaf(ds, qr[d], dka[c]);
        }
      }
    }
  }
  float* dko = dk + b * st.dk_b + kvh * st.dk_h + j * st.dk_s;
  float* dvo = dv + b * st.dv_b + kvh * st.dv_h + j * st.dv_s;
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const int d = lane + 32 * c;
    if (d < D) {
      dko[d] = dka[c] * scale;
      dvo[d] = dva[c];
    }
  }
}

// ---- bf16: tensor-core kernels ---------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO, K, V tiles of kTile rows
  return sizeof(bf16) * 4 * kTile * (D + 8);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {  // K, V of kTile rows; Q, dO of kQB; lse, delta
  return sizeof(bf16) * (2 * kTile + 2 * kQB) * (D + 8) + sizeof(float) * 2 * kQB;
}

// Write a warp's 16 x D float32 accumulator (times mul) as bf16 rows
// row0 + r (r < 16) of g, staged through the warp's own 16 shared rows
// (stride D + 8) at sm; rows at or past n_rows are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul,
                                           bf16* sm, bf16* g, int64_t rs, int row0,
                                           int n_rows) {
  constexpr int kLd = D + 8, C = D / 8;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(sm + gr * kLd + n * 8 + 2 * t4) =
        __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(sm + (gr + 8) * kLd + n * 8 + 2 * t4) =
        __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = i / C, c = i - r * C;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(g + (row0 + r) * rs + c * 8) =
          *reinterpret_cast<const uint4*>(sm + r * kLd + c * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsB)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dO,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int KV, int Sq, int Skv, int n_qt,
                         BwdStrides st, float scale, int causal) {
  constexpr int kLd = D + 8;
  constexpr int KD = D / 16;     // 16-wide k chunks of the head dim
  constexpr int NS = kTile / 8;  // 8-key n blocks of the scores
  constexpr int NO = D / 8;      // 8-dim n blocks of dq
  extern __shared__ uint4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile * kLd;
  bf16* Ks = dOs + kTile * kLd;
  bf16* Vs = Ks + kTile * kLd;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // (b, h) outer; the heavier causal tiles of a (b, h) start first
  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (blockIdx.x - bh * n_qt);
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kTile;
  const bf16* kb = k + b * st.k_b + kvh * st.k_h;
  const bf16* vb = v + b * st.v_b + kvh * st.v_h;
  const int kv_end = causal ? min(Skv, q0 + kTile) : Skv;
  const int n_kt = (kv_end + kTile - 1) / kTile;

  load_tile<D, kTile, kThreadsB>(Qs, q + b * st.q_b + h * st.q_h, st.q_s, q0, Sq);
  load_tile<D, kTile, kThreadsB>(dOs, dO + b * st.do_b + h * st.do_h, st.do_s, q0, Sq);
  cp_async_commit();

  const int qrow = q0 + warp * 16 + g;  // this thread's rows: qrow, qrow + 8
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qrow + 8 * r;
    const int64_t at = static_cast<int64_t>(bh) * Sq + qpos;
    lr[r] = qpos < Sq ? lse[at] : 0.f;
    dr[r] = qpos < Sq ? delta[at] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTile;
    load_tile<D, kTile, kThreadsB>(Ks, kb, st.k_s, k0, kv_end);
    load_tile<D, kTile, kThreadsB>(Vs, vb, st.v_s, k0, kv_end);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T: ldmatrix of K / V rows gives the
    // col-major B fragments
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, smem_addr(Qs + (warp * 16 + (lane & 15)) * kLd + kc * 16 + (lane >> 4) * 8));
      ldmatrix_x4(da, smem_addr(dOs + (warp * 16 + (lane & 15)) * kLd + kc * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kc * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, smem_addr(Ks + off));
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        ldmatrix_x4(vf, smem_addr(Vs + off));
        mma_bf16(dp[2 * np], da, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
      }
    }

    // ds = p (dp - delta), p recomputed from lse; masked entries are 0
    uint32_t dsf[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
        const int qpos = qrow + (e >> 1) * 8;
        const bool ok = kpos < Skv && qpos < Sq && (!causal || qpos >= kpos);
        const float p = ok ? __expf(s[n][e] * scale - lr[e >> 1]) : 0.f;
        ds[e] = p * (dp[n][e] - dr[e >> 1]);
      }
      dsf[n][0] = pack_bf16(ds[0], ds[1]);
      dsf[n][1] = pack_bf16(ds[2], ds[3]);
    }

    // dq += dS.K: ldmatrix.trans of K rows gives the col-major B fragments
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      const uint32_t a[4] = {dsf[2 * kc][0], dsf[2 * kc][1], dsf[2 * kc + 1][0],
                             dsf[2 * kc + 1][1]};
#pragma unroll
      for (int dd = 0; dd < NO / 2; ++dd) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, smem_addr(Ks + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                        dd * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * dd], a, kf[0], kf[1]);
        mma_bf16(acc[2 * dd + 1], a, kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with this K and V tile
  }
  if (n_kt == 0) {  // no key tile: Q and dO were never waited for
    cp_async_wait<0>();
    __syncthreads();
  }
  // the warp's own 16 rows of the Q buffer (only this warp read them)
  store_rows<D>(acc, scale, Qs + warp * 16 * kLd, dq + b * st.dq_b + h * st.dq_h,
                st.dq_s, q0 + warp * 16, Sq);
}

template <int D>
__global__ void __launch_bounds__(kThreadsB)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dO,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV,
                           int Sq, int Skv, int n_kt, BwdStrides st, float scale,
                           int causal) {
  constexpr int kLd = D + 8;
  constexpr int KD = D / 16;    // 16-wide k chunks of the head dim
  constexpr int NS = kQB / 8;   // 8-row n blocks of a q tile
  constexpr int NO = D / 8;     // 8-dim n blocks of dk and dv
  extern __shared__ uint4 smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * kLd;
  bf16* Qs = Vs + kTile * kLd;
  bf16* dOs = Qs + kQB * kLd;
  float* Ls = reinterpret_cast<float*>(dOs + kQB * kLd);
  float* Ds = Ls + kQB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bk = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - bk * n_kt) * kTile;
  const int b = bk / KV, kvh = bk - b * KV;
  const int G = H / KV;
  load_tile<D, kTile, kThreadsB>(Ks, k + b * st.k_b + kvh * st.k_h, st.k_s, k0, Skv);
  load_tile<D, kTile, kThreadsB>(Vs, v + b * st.v_b + kvh * st.v_h, st.v_s, k0, Skv);
  cp_async_commit();
  cp_async_wait<0>();

  const int krow = k0 + warp * 16 + g;  // this thread's keys: krow, krow + 8
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // causal: q rows before the tile's first key see none of its keys
  const int qt0 = causal ? k0 / kQB : 0;
  const int n_qt = (Sq + kQB - 1) / kQB;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const bf16* qb = q + b * st.q_b + h * st.q_h;
    const bf16* db = dO + b * st.do_b + h * st.do_h;
    const int64_t lrow = (static_cast<int64_t>(b) * H + h) * Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kQB;
      __syncthreads();  // the last tile's readers are done (and K, V are in)
      load_tile<D, kQB, kThreadsB>(Qs, qb, st.q_s, q0, Sq);
      load_tile<D, kQB, kThreadsB>(dOs, db, st.do_s, q0, Sq);
      cp_async_commit();
      if (tid < kQB) {
        const bool in = q0 + tid < Sq;
        Ls[tid] = in ? lse[lrow + q0 + tid] : 0.f;
        Ds[tid] = in ? delta[lrow + q0 + tid] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K.Q^T and dP^T = V.dO^T: the block's keys are the A rows,
      // ldmatrix of Q / dO rows gives the col-major B fragments
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KD; ++kc) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, smem_addr(Ks + (warp * 16 + (lane & 15)) * kLd + kc * 16 + (lane >> 4) * 8));
        ldmatrix_x4(va, smem_addr(Vs + (warp * 16 + (lane & 15)) * kLd + kc * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kc * 16 +
                          ((lane >> 3) & 1) * 8;
          uint32_t qf[4], df[4];
          ldmatrix_x4(qf, smem_addr(Qs + off));
          mma_bf16(s[2 * np], ka, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
          ldmatrix_x4(df, smem_addr(dOs + off));
          mma_bf16(dp[2 * np], va, df[0], df[1]);
          mma_bf16(dp[2 * np + 1], va, df[2], df[3]);
        }
      }

      // p^T and ds^T, q along the columns; masked entries are 0
      uint32_t pf[NS][2], dsf[NS][2];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t4 + (e & 1);
          const int qpos = q0 + col;
          const int kpos = krow + (e >> 1) * 8;
          const bool ok = qpos < Sq && kpos < Skv && (!causal || qpos >= kpos);
          p[e] = ok ? __expf(s[n][e] * scale - Ls[col]) : 0.f;
          ds[e] = p[e] * (dp[n][e] - Ds[col]);
        }
        pf[n][0] = pack_bf16(p[0], p[1]);
        pf[n][1] = pack_bf16(p[2], p[3]);
        dsf[n][0] = pack_bf16(ds[0], ds[1]);
        dsf[n][1] = pack_bf16(ds[2], ds[3]);
      }

      // dv += P^T.dO and dk += dS^T.Q: ldmatrix.trans of dO / Q rows gives
      // the col-major B fragments
#pragma unroll
      for (int kc = 0; kc < kQB / 16; ++kc) {
        const uint32_t ap[4] = {pf[2 * kc][0], pf[2 * kc][1], pf[2 * kc + 1][0],
                                pf[2 * kc + 1][1]};
        const uint32_t as[4] = {dsf[2 * kc][0], dsf[2 * kc][1], dsf[2 * kc + 1][0],
                                dsf[2 * kc + 1][1]};
#pragma unroll
        for (int dd = 0; dd < NO / 2; ++dd) {
          const int off = (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + dd * 16 +
                          (lane >> 4) * 8;
          uint32_t of[4], qf[4];
          ldmatrix_x4_trans(of, smem_addr(dOs + off));
          mma_bf16(dva[2 * dd], ap, of[0], of[1]);
          mma_bf16(dva[2 * dd + 1], ap, of[2], of[3]);
          ldmatrix_x4_trans(qf, smem_addr(Qs + off));
          mma_bf16(dka[2 * dd], as, qf[0], qf[1]);
          mma_bf16(dka[2 * dd + 1], as, qf[2], qf[3]);
        }
      }
    }
  }
  __syncthreads();  // K and V arrived for every warp, also with no q tile
  // each warp's own 16 rows of the K and V buffers (only it read them)
  store_rows<D>(dka, scale, Ks + warp * 16 * kLd, dk + b * st.dk_b + kvh * st.dk_h,
                st.dk_s, k0 + warp * 16, Skv);
  store_rows<D>(dva, 1.f, Vs + warp * 16 * kLd, dv + b * st.dv_b + kvh * st.dv_h,
                st.dv_s, k0 + warp * 16, Skv);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

unsigned blocks_of(int64_t rows, int per_block) {
  return static_cast<unsigned>((rows + per_block - 1) / per_block);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* delta, void* dq, void* dk, void* dv,
               int B, int H, int KV, int Sq, int Skv, const BwdStrides& st,
               float scale, int causal, cudaStream_t stream) {
  const int64_t q_rows = static_cast<int64_t>(B) * H * Sq;
  const int64_t k_rows = static_cast<int64_t>(B) * KV * Skv;
  const int wpb = kThreadsB / 32;
  if (q_rows > 0)
    flash_bwd_dq_f32_kernel<D><<<blocks_of(q_rows, wpb), kThreadsB, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO), lse, delta,
        static_cast<float*>(dq), H, KV, Sq, Skv, st, scale, causal, q_rows);
  flash_bwd_dkdv_f32_kernel<D><<<blocks_of(k_rows, wpb), kThreadsB, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), H, KV, Sq, Skv, st, scale,
      causal, k_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* dO,
                const float* lse, const float* delta, void* dq, void* dk, void* dv,
                int B, int H, int KV, int Sq, int Skv, const BwdStrides& st,
                float scale, int causal, cudaStream_t stream) {
  auto dq_kernel = flash_bwd_dq_bf16_kernel<D>;
  auto dkdv_kernel = flash_bwd_dkdv_bf16_kernel<D>;
  cudaError_t e = allow_smem(dq_kernel, dq_smem_bytes<D>());
  if (e == cudaSuccess) e = allow_smem(dkdv_kernel, dkdv_smem_bytes<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (Sq + kTile - 1) / kTile, n_kt = (Skv + kTile - 1) / kTile;
  if (n_qt > 0)
    dq_kernel<<<static_cast<unsigned>(B * H * n_qt), kThreadsB, dq_smem_bytes<D>(), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse, delta,
        static_cast<bf16*>(dq), H, KV, Sq, Skv, n_qt, st, scale, causal);
  dkdv_kernel<<<static_cast<unsigned>(B * KV * n_kt), kThreadsB, dkdv_smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KV, Sq, Skv, n_kt, st, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const void* out,
           const void* dO, const float* lse, float* delta, void* dq, void* dk, void* dv,
           int B, int H, int KV, int Sq, int Skv, const BwdStrides& st, float scale,
           int causal, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * H * Sq;
  if (rows > 0) {
    const unsigned blocks = blocks_of(rows, kRowWarps);
    if (dtype == 0)
      flash_bwd_delta_kernel<float><<<blocks, 32 * kRowWarps, 0, stream>>>(
          static_cast<const float*>(out), static_cast<const float*>(dO), delta, H, Sq,
          D, st, rows);
    else
      flash_bwd_delta_kernel<bf16><<<blocks, 32 * kRowWarps, 0, stream>>>(
          static_cast<const bf16*>(out), static_cast<const bf16*>(dO), delta, H, Sq, D,
          st, rows);
  }
  return dtype == 0
             ? launch_f32<D>(q, k, v, dO, lse, delta, dq, dk, dv, B, H, KV, Sq, Skv, st,
                             scale, causal, stream)
             : launch_bf16<D>(q, k, v, dO, lse, delta, dq, dk, dv, B, H, KV, Sq, Skv, st,
                              scale, causal, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. D in {16, 32, 64, 128}; H % KV == 0;
// Skv > 0. strides: 24 element strides, the (B, H, S) strides of q, k, v,
// out, dO, dq, dk and dv in that order (the last dimension of each has
// stride 1; for bf16 every stride is a multiple of 8 and every base
// 16-byte aligned). lse: the forward's (B, H, Sq) float32; delta: (B, H,
// Sq) float32 scratch. B*H*ceil(Sq/64), B*KV*ceil(Skv/64) and B*H*Sq stay
// below 2^31 (the wrapper checks). Returns cudaGetLastError() after the
// launches.
extern "C" int fa_flash_bwd(const void* q, const void* k, const void* v,
                            const void* out, const void* dO, const float* lse,
                            float* delta, void* dq, void* dk, void* dv, int dtype,
                            int B, int H, int KV, int Sq, int Skv, int D,
                            const int64_t* strides, float scale, int causal,
                            cudaStream_t stream) {
  if (B * KV == 0) return static_cast<int>(cudaGetLastError());
  static_assert(sizeof(BwdStrides) == 24 * sizeof(int64_t), "24 strides");
  BwdStrides st;
  memcpy(&st, strides, sizeof st);
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, out, dO, lse, delta, dq, dk, dv, B, H, KV, Sq, Skv, st, scale, causal, stream);
    case 32: return launch<32>(dtype, q, k, v, out, dO, lse, delta, dq, dk, dv, B, H, KV, Sq, Skv, st, scale, causal, stream);
    case 64: return launch<64>(dtype, q, k, v, out, dO, lse, delta, dq, dk, dv, B, H, KV, Sq, Skv, st, scale, causal, stream);
    case 128: return launch<128>(dtype, q, k, v, out, dO, lse, delta, dq, dk, dv, B, H, KV, Sq, Skv, st, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
