// Causal / non-causal GQA flash-attention forward: out (B,H,Sq,D) in the
// input's dtype and lse (B,H,Sq) float32, for q (B,H,Sq,D) and k, v
// (B,KV,Skv,D), bf16 or float32. Every operand is addressed through its
// (B, H, S) strides with a unit last stride, so the caller's (B,S,H,D)
// projections are read in place through a transposed view and out is
// written into whatever layout the caller allocated.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py:flash_mha_fwd, whose grid walks KV
// blocks sequentially per (b, h, q block) with (m, l, acc) in VMEM scratch.
// Here one thread block owns one (b, h, 64-row q tile) and the KV walk is a
// loop inside it, the online-softmax state in float32 registers.
//
// Arithmetic as the reference (kernels/flash_attention.py:31-69): causal
// means qpos >= kpos with both positions from 0, masked scores are -1e30
// (never -inf, so a fully masked tile gives no NaN), l is clamped at 1e-30,
// lse = m + log(l). KV tiles past the causal limit are never read. Unlike
// the Pallas body, which asserts Sq % bq == 0, a ragged last q tile and a
// ragged last KV tile are masked here: padding keys score -inf, so they get
// probability exactly 0.
//
// bf16 (the model path): flash_fwd_bf16_kernel. Both products run on the
// tensor cores, mma.sync.m16n8k16 over bf16 fragments with float32
// accumulators, fed by ldmatrix from bf16 shared memory. 4 warps, each
// owning 16 q rows; KV tiles of 64 keys. Q, K and V tiles arrive by 16-byte
// cp.async into rows padded by 16 bytes (D + 8 elements), which puts the 8
// rows of every ldmatrix on distinct bank groups. K and V tiles pass
// through a ring of two stages: a block issues Q and the first two K and V
// tiles at once, and each tile's stage is refilled with the tile two ahead
// as soon as P.V is done with it. Keys past the causal limit are not read
// even inside the last tile (their rows are zeroed and masked). The
// 1/sqrt(D) scale is applied to the float32 scores. P stays in registers:
// the score accumulators are rounded to bf16 pairs and used directly as
// the A fragments of P.V (the port's blocked path also meets V with P in
// V's dtype); l sums the unrounded float32 p. Only a tile that crosses the
// diagonal or the ragged end is masked. The output tile is staged through
// the (then free) Q buffer and stored in 16-byte rows.
//
// Bound on the H100 at the main path's shape (q, k, v 2048x8x128x64 bf16,
// causal, one call per layer and microbatch): q, k, v and out are 1.07 GB,
// 0.32 ms at 3.35 TB/s, against 2*2*B*H*Sq*Skv*D/2 = 34 GFLOP, 0.035 ms at
// the 989 TFLOP/s bf16 tensor-core rate — so by the bytes. Q tiles are read
// once, K and V tiles once per q tile that needs them; the two q tiles of
// one (b, h) are neighbouring blocks, so the second read of a K/V tile
// comes mostly from L2. A block takes 46 KB of shared memory at D = 64, so
// four share an SM and keep loads in flight between them. Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.398 ms at that
// shape (1.23x the bound), strided or contiguous. What keeps it from the
// bound: a block holds no load in flight while it computes and stores;
// a persistent grid prefetching the next (b, h), or wgmma with a TMA
// producer warp, would close that.
//
// float32: flash_fwd_kernel, the FMA kernel of the first port (K/V tiles of
// 32 keys staged as float32, lane = key in Q.K^T, lane = head dim in P.V,
// probabilities through shared memory). Tensor cores would give TF32,
// which cannot meet the float32 tolerance; the float32 route is off the
// model path.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float kMasked = -1e30f;

// Element strides of the (B, H, S) dimensions of q, k, v and out.
struct Strides {
  int64_t q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};

__device__ __forceinline__ float warp_max_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// ---- float32: FMA kernel ---------------------------------------------------

constexpr int kFlashThreads = 128;           // 4 warps
constexpr int kRowsPerWarp = 16;
constexpr int kBQ = 4 * kRowsPerWarp;        // q rows per block
constexpr int kBK32 = 32;                    // keys per float32 KV tile

// Shared memory (float32): Q tile (kBQ, D), K tile (kBK32, D+1) padded so
// lane j's row reads hit distinct banks, V tile (kBK32, D), and per warp
// the probabilities (kRowsPerWarp, kBK32).
template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK32 * (D + 1) + kBK32 * D +
                          4 * kRowsPerWarp * kBK32);
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int KV, int Sq, int Skv,
                 Strides st, float scale, int causal) {
  constexpr int ND = (D + 31) / 32;  // head dims per lane in P.V
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * D;
  float* Vs = Ks + kBK32 * (D + 1);
  float* Ps = Vs + kBK32 * D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;              // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kBQ;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + kvh * st.k_h;
  const float* vb = v + b * st.v_b + kvh * st.v_h;

  for (int i = tid; i < kBQ * D; i += kFlashThreads) {
    const int r = i / D, d = i - r * D;
    Qs[i] = q0 + r < Sq ? qb[(q0 + r) * st.q_s + d] * scale : 0.f;
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
  float* Pw = Ps + warp * kRowsPerWarp * kBK32;
  for (int k0 = 0; k0 < kv_end; k0 += kBK32) {
    __syncthreads();  // the previous tile's readers are done (and Qs is in)
    for (int i = tid; i < kBK32 * D; i += kFlashThreads) {
      const int j = i / D, d = i - j * D;
      const bool in = k0 + j < Skv;
      Ks[j * (D + 1) + d] = in ? kb[(k0 + j) * st.k_s + d] : 0.f;
      Vs[i] = in ? vb[(k0 + j) * st.v_s + d] : 0.f;
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
      Pw[r * kBK32 + lane] = p;
    }
    __syncwarp();

    // acc += P . V over the tile's keys, lane owning dims lane + 32c
#pragma unroll 2
    for (int j = 0; j < kBK32; j += 4) {
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
        const float4 p4 = *reinterpret_cast<const float4*>(Pw + r * kBK32 + j);
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

  float* ob = out + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + r0 + r;
    const float lt = fmaxf(warp_sum_f(l[r]), 1e-30f);
    if (qpos >= Sq) continue;
    float* orow = ob + qpos * st.o_s;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = acc[r][c] / lt;
    }
    if (lane == 0) lse[static_cast<int64_t>(bh) * Sq + qpos] = m[r] + logf(lt);
  }
}

// ---- bf16: tensor-core kernel ----------------------------------------------

constexpr int kBK = 64;  // keys per bf16 KV tile

constexpr int kStages = 2;  // K and V tiles in flight per block

template <int D>
struct Bf16Tile {
  static constexpr int kLd = D + 8;  // shared row stride in elements (+16 B)
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (kBQ + 2 * kStages * kBK) * kLd;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false the 16 bytes are zeroed
// and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ROWS rows of D bf16 from g (row stride rs elements), rows row0.. of the
// sequence, into shared rows of Bf16Tile<D>::kLd; rows at or past n_rows
// are zeroed.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm, const __nv_bfloat16* g,
                                          int64_t rs, int row0, int n_rows) {
  constexpr int C = D / 8;  // 16-byte chunks per row
  constexpr int kLd = Bf16Tile<D>::kLd;
  for (int i = threadIdx.x; i < ROWS * C; i += kFlashThreads) {
    const int r = i / C, c = i - r * C;
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* src = g + (ok ? (row0 + r) * rs : 0) + c * 8;
    cp_async16(smem_addr(sm + r * kLd + c * 8), src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      int H, int KV, int Sq, int Skv, int n_qt, Strides st,
                      float scale, int causal) {
  constexpr int kLd = Bf16Tile<D>::kLd;
  constexpr int KD = D / 16;    // 16-wide k chunks of the head dim (Q.K^T)
  constexpr int NS = kBK / 8;   // 8-key n blocks of the scores
  constexpr int NO = D / 8;     // 8-dim n blocks of the output
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * kLd;              // kStages K tiles
  __nv_bfloat16* Vs = Ks + kStages * kBK * kLd;    // kStages V tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row / column pair
  // one 1-D grid, (b, h) outer, so any B*H fits; the heavier causal tiles
  // of a (b, h) start first, and its tiles run side by side (K/V from L2)
  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (blockIdx.x - bh * n_qt);
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const __nv_bfloat16* qb = q + b * st.q_b + h * st.q_h;
  const __nv_bfloat16* kb = k + b * st.k_b + kvh * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + kvh * st.v_h;
  // keys at or past kv_end are never read: past the causal limit their
  // zeroed rows score -1e30 (p = 0), past Skv -inf
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int n_kt = (kv_end + kBK - 1) / kBK;

  // commit groups, in order: {Q, K0}, {V0}, {K1}, {V1}, then {K j+2},
  // {V j+2} after tile j — empty where there is no tile, so the counts in
  // the waits below hold for every j
  load_tile<D, kBQ>(Qs, qb, st.q_s, q0, Sq);
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < n_kt) load_tile<D, kBK>(Ks + t * kBK * kLd, kb, st.k_s, t * kBK, kv_end);
    cp_async_commit();
    if (t < n_kt) load_tile<D, kBK>(Vs + t * kBK * kLd, vb, st.v_s, t * kBK, kv_end);
    cp_async_commit();
  }

  cp_async_wait<2 * kStages - 1>();  // Q and K tile 0
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc)
    ldmatrix_x4(qf[kc], smem_addr(Qs + (warp * 16 + (lane & 15)) * kLd +
                                  kc * 16 + (lane >> 4) * 8));

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const int qrow = q0 + warp * 16 + g;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kBK;
    const __nv_bfloat16* Kt = Ks + (j % kStages) * kBK * kLd;
    const __nv_bfloat16* Vt = Vs + (j % kStages) * kBK * kLd;
    if (j > 0) {
      cp_async_wait<2 * kStages - 1>();  // K tile j (V j and the next may fly)
      __syncthreads();
    }
    // S = Q . K^T: ldmatrix of K rows gives the col-major B fragments
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                                  kc * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], kf[2], kf[3]);
      }

    // online softmax over the tile, float32; only an edge tile is masked
    const bool edge = (causal && k0 + kBK - 1 > q0) || k0 + kBK > Skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qpos = qrow + (e >> 1) * 8;
          if (kpos >= Skv) x = -INFINITY;           // padding: probability 0
          else if (causal && qpos < kpos) x = kMasked;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
      alpha[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    uint32_t pf[NS][2];  // P as bf16 pairs: the A fragments of P.V
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p0 = __expf(s[n][0] - m[0]), p1 = __expf(s[n][1] - m[0]);
      const float p2 = __expf(s[n][2] - m[1]), p3 = __expf(s[n][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[n][0] = pack_bf16(p0, p1);
      pf[n][1] = pack_bf16(p2, p3);
    }

    cp_async_wait<2 * kStages - 2>();  // V tile j (the next tiles may fly)
    __syncthreads();
    // O += P . V: ldmatrix.trans of V rows gives the col-major B fragments
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t a[4] = {pf[2 * kc][0], pf[2 * kc][1], pf[2 * kc + 1][0],
                             pf[2 * kc + 1][1]};
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(Vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                        dp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dp], a, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage's K and V
    const int nxt = j + kStages;
    if (nxt < n_kt)
      load_tile<D, kBK>(Ks + (j % kStages) * kBK * kLd, kb, st.k_s, nxt * kBK, kv_end);
    cp_async_commit();
    if (nxt < n_kt)
      load_tile<D, kBK>(Vs + (j % kStages) * kBK * kLd, vb, st.v_s, nxt * kBK, kv_end);
    cp_async_commit();
  }

  // epilogue: the four lanes of a row hold its l in parts
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
    const int qpos = qrow + r * 8;
    if (t4 == 0 && qpos < Sq)
      lse[static_cast<int64_t>(bh) * Sq + qpos] = m[r] + logf(l[r]);
  }
  // stage the warp's 16 rows in its own rows of the Q buffer (only this
  // warp read them), then store 16-byte chunks
  __nv_bfloat16* Ow = Qs + warp * 16 * kLd;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Ow + g * kLd + n * 8 + 2 * t4) =
        __floats2bfloat162_rn(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Ow + (g + 8) * kLd + n * 8 + 2 * t4) =
        __floats2bfloat162_rn(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = out + b * st.o_b + h * st.o_h;
  constexpr int C = D / 8;
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = i / C, c = i - r * C;
    const int qpos = q0 + warp * 16 + r;
    if (qpos < Sq)
      *reinterpret_cast<uint4*>(ob + qpos * st.o_s + c * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * kLd + c * 8);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int KV, int Sq, int Skv,
               const Strides& st, float scale, int causal, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, KV, Sq,
      Skv, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int H, int KV, int Sq, int Skv,
                const Strides& st, float scale, int causal, cudaStream_t stream) {
  const size_t smem = Bf16Tile<D>::kSmem;
  auto kernel = flash_fwd_bf16_kernel<D>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int64_t blocks = static_cast<int64_t>(B) * H * n_qt;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), kFlashThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, H, KV, Sq, Skv, n_qt, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int KV, int Sq, int Skv, const Strides& st,
           float scale, int causal, cudaStream_t stream) {
  return dtype == 0
             ? launch_f32<D>(q, k, v, out, lse, B, H, KV, Sq, Skv, st, scale, causal, stream)
             : launch_bf16<D>(q, k, v, out, lse, B, H, KV, Sq, Skv, st, scale, causal, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. D in {16, 32, 64, 128}; H % KV == 0.
// strides: 12 element strides, the (B, H, S) strides of q, k, v and out in
// that order (the last dimension of each has stride 1; for bf16 every
// stride is a multiple of 8 and every base 16-byte aligned). float32: at
// most 65535 q tiles of 64. Returns cudaGetLastError() after the launch.
extern "C" int fa_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, float* lse, int dtype, int B, int H,
                            int KV, int Sq, int Skv, int D,
                            const int64_t* strides, float scale, int causal,
                            cudaStream_t stream) {
  if (B * H == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, out, lse, B, H, KV, Sq, Skv, st, scale, causal, stream);
    case 32: return launch<32>(dtype, q, k, v, out, lse, B, H, KV, Sq, Skv, st, scale, causal, stream);
    case 64: return launch<64>(dtype, q, k, v, out, lse, B, H, KV, Sq, Skv, st, scale, causal, stream);
    case 128: return launch<128>(dtype, q, k, v, out, lse, B, H, KV, Sq, Skv, st, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
