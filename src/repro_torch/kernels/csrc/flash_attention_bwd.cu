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
//   dq:   one block per (b, h, 128-row q tile), looping over the 64-key
//         tiles the causal mask lets through;
//   dk/dv: one block per (b, kv head, 128-key tile), looping over the G
//         heads of the group and, per head, the 64-row q tiles at or past
//         the tile's first key (causal).
// bf16 (the model path), both for Hopper (sm_90a): a block is one producer
// warpgroup and two consumer warpgroups of 64 rows each (wgmma's M), with
// setmaxnreg moving registers from the producer (40) to the consumers
// (232). One producer thread loads the block's own 128 rows once (K and V
// for dk/dv, Q and dO for dq) and streams the other side's 64-row tiles
// (Q, dO, lse and delta; or K and V) through a ring of kStages stages in
// shared memory, all by TMA (cp.async.bulk.tensor on rank-4 maps over the
// (B,H,S,D) views' own strides, 128-byte swizzle, rows past S filled with
// zeros; lse and delta by 1-D maps in boxes of 68 floats from the 16-byte
// boundary at or before the tile's first row, since a (b, h) row starts at
// any 4-byte offset and a box must start on 16 bytes) behind mbarriers:
// full (the bytes landed) and empty (both
// consumers are done). The ring runs on across the heads of a group. A
// consumer computes S^T = K.Q^T and dP^T = V.dO^T (dk/dv; S = Q.K^T and
// dP = dO.V^T for dq) by wgmma m64n64k16 with both operands in shared
// memory, p and ds in float32 registers (only tiles that straddle the
// diagonal or a ragged edge are masked; tiles wholly above it are skipped),
// then rounds p and ds to bf16 pairs in registers and feeds them as
// wgmma's register A operand to dV += P^T.dO, dK += dS^T.Q (dQ += dS.K),
// with B read from the shared tile transposed (MN-major). dk and dv (dq)
// stay float32 in registers for the whole walk and are written once.
// A head dim below 64 is loaded as a 64-wide box whose columns past D
// arrive as zeros.
// float32: one warp per q row (dq) or per key (dk/dv), lane = head dim,
// the dot products by warp shuffles; float32 is off the model path.
//
// Bound on the H100 at the training shape (B 4, H 16, KV 8, S 2,048, D 128,
// bf16, causal): 2.5 x the forward's 2 * 2 * B * H * S * S * D / 2 = 68.7
// GFLOP, i.e. 172 GFLOP (the five products q.k, dO.v, ds.K, ds^T.Q, p^T.dO
// over the causal half), 0.17 ms at the 989 TFLOP/s bf16 tensor-core rate,
// against q, out, dO, dq (33.5 MB each), k, v, dk, dv (16.8 MB each) and
// lse read or written once, 0.2 GB, 0.06 ms at 3.35 TB/s: so by the
// operations. The split into a dq and a dk/dv kernel computes S and dP in
// both (7 products, ~240 GFLOP with the straddling tiles). Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W: 0.5865 ms at that
// shape (dk/dv 0.3023, dq 0.2504, delta 0.0338), 3.4x the bound, against
// PyTorch's SDPA backward at 0.4990 ms. What holds it back (estimated, not
// measured): an S or dP wgmma reads both operands from shared memory, 4 KB
// an m64n64k16, about what shared memory delivers (128 B a cycle) in the
// 32 cycles the tensor cores take for it; and a warpgroup waits for each
// tile's last product before it starts the next tile, the other warpgroup
// filling the gap only in part. Tried and slower on the card: issuing dV
// before dS is formed (ptxas serialized the dk/dv wgmmas for want of
// registers at D = 128), software-pipelining dq's tiles (2 and 3 stages),
// a 3-stage ring, and blocks grouped by head instead of heaviest first.
#include "common.cuh"

#include <cuda.h>  // CUtensorMap; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <math.h>
#include <string.h>

#include <utility>

namespace {

constexpr int kThreadsB = 128;  // 4 warps (float32 kernels)
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

// ---- bf16: warp-specialised wgmma kernels (sm_90a) --------------------------

using bf16 = __nv_bfloat16;

constexpr int kWg = 128;            // threads of a warpgroup
constexpr int kBlock = 3 * kWg;     // consumers 0 and 1, then the producer
constexpr int kRows = 64;           // a consumer's rows; a streamed tile's rows
constexpr int kBoxBytes = 64 * 128; // one TMA box: 64 rows x 64 bf16 (128 B)
constexpr int kStages = 2;          // ring depth
constexpr int kVecBox = kRows + 4;  // lse / delta floats a stage loads (16-byte start)
constexpr int kVecSlot = 384;       // bytes of a stage's lse or delta slot
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block (byte offsets from a 1024-aligned base, which the
// 128-byte swizzle needs). A 64-column half of an operand is [rows][64]
// bf16, 128 bytes a row; D = 128 has two halves, D <= 64 one.
//   A, B     the block's own 128 rows (dk/dv: K, V; dq: Q, dO): a half is
//            16 KB, consumer c's 64 rows start at c * 8 KB in it;
//   stage s  two streamed 64-row operands (dk/dv: Q, dO; dq: K, V), 8 KB a
//            half; then per stage kVecBox lse and delta floats (dk/dv);
//   full[kStages], empty[kStages], fixed: the mbarriers.
template <int D>
struct Smem {
  static constexpr int NH = D < 64 ? 1 : D / 64;
  static constexpr int kFixed = NH * 2 * kBoxBytes;
  static constexpr int kTile = NH * kBoxBytes;
  static constexpr int kA = 0, kB = kFixed, kStage0 = 2 * kFixed;
  static constexpr int kRowVec = kStage0 + kStages * 2 * kTile;
  static constexpr int kBars = kRowVec + kStages * 2 * kVecSlot;
  static constexpr int kAlloc = kBars + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

// One box of a rank-4 map at (c0, c1, c2, c3) = (d, s, h, b) into dst.
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_1d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0) : "memory");
}

// wgmma descriptor of an operand in a 128-byte-swizzled half at shared
// address a (8-row groups 1024 bytes apart). K-major (the head dim along
// K): a 16-wide k step adds 32 bytes inside the swizzled row. MN-major
// (rows along K, the head dim along N): a 16-row k step adds 2048 bytes.
// The wgmma wrappers add such offsets (in 16-byte units) inside their asm,
// so that only one descriptor per operand lives in registers.
__device__ __forceinline__ uint64_t sw128(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving an accumulator across a wgmma boundary.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_D32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "   \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),          \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),    \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),             \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),             \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),             \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64 float32, the warpgroup's fragment) = A (64 x 16) . B (16 x 64)
// + (accumulate ? d : 0), both K-major in shared memory at descriptors
// da + OA and db + OB.
template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile("{\n.reg .pred p;\n.reg .b64 rda, rdb;\nsetp.ne.b32 p, %34, 0;\n"
               "add.s64 rda, %32, %35;\nadd.s64 rdb, %33, %36;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
               ", rda, rdb, p, 1, 1, 0, 0;\n}\n"
               : WG_OUT32(d)
               : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
}

// d += A . B with A (64 x 16 bf16) in registers, in the accumulator's
// layout (a[0]: row g, cols 2t, 2t+1; a[1]: row g + 8; a[2], a[3]: cols + 8),
// and B MN-major in shared memory at descriptor db + OB.
template <int OB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\n.reg .b64 rdb;\nsetp.ne.b32 p, %37, 0;\n"
               "add.s64 rdb, %36, %38;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
               ", {%32, %33, %34, %35}, rdb, p, 1, 1, 1;\n}\n"
               : WG_OUT32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(OB));
}

template <int... KC>
__device__ __forceinline__ void product_nt(float (&acc)[32], uint64_t fixed, uint64_t tile,
                                           std::integer_sequence<int, KC...>) {
  (wgmma_ss<((KC / 4) * 2 * kBoxBytes + (KC % 4) * 32) / 16,
            ((KC / 4) * kBoxBytes + (KC % 4) * 32) / 16>(acc, fixed, tile, KC > 0), ...);
}

// acc = A . B^T for a consumer: A its 64 rows of a fixed operand at
// shared address `fixed` (128-row halves), B a streamed 64-row tile at
// `tile`, over the head dim (K-major both): D / 16 k steps.
template <int D>
__device__ __forceinline__ void product_nt(float (&acc)[32], uint32_t fixed, uint32_t tile) {
  product_nt(acc, sw128(fixed), sw128(tile), std::make_integer_sequence<int, D / 16>{});
}

template <int NH, int... I>
__device__ __forceinline__ void product_rt(float (&acc)[NH][32], const uint32_t (&a)[4][4],
                                           uint64_t tile, std::integer_sequence<int, I...>) {
  // I = 4 * h + ks: half h of the head dim, k step ks (16 rows of the tile)
  (wgmma_rs<((I / 4) * kBoxBytes + (I % 4) * 2048) / 16>(acc[I / 4], a[I % 4], tile), ...);
}

// acc[h] += A . T for every 64-column half h of the head dim: A (64 x 64)
// bf16 pairs in registers, four 16-wide k steps; T the streamed 64-row
// tile at shared address `tile` (MN-major: its rows run along K).
template <int NH>
__device__ __forceinline__ void product_rt(float (&acc)[NH][32], const uint32_t (&a)[4][4],
                                           uint32_t tile) {
  product_rt<NH>(acc, a, sw128(tile), std::make_integer_sequence<int, 4 * NH>{});
}

// The 64 x 64 float32 fragment x as bf16 A operands of four k steps.
__device__ __forceinline__ void to_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[ks][r] = pack2(x[8 * ks + 2 * r], x[8 * ks + 2 * r + 1]);
}

// Write a consumer's D columns of acc (times mul) as bf16 to rows row0 + r
// (r = warp * 16 + g and + 8) of g (row stride rs), rows below n_rows.
template <int D, int NH>
__device__ __forceinline__ void store_acc(const float (&acc)[NH][32], float mul, bf16* g,
                                          int64_t rs, int row0, int n_rows) {
  const int tid = threadIdx.x % kWg, lane = tid & 31;
  const int r0 = row0 + (tid >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (h * 64 + 8 * j >= D) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < n_rows)
          *reinterpret_cast<__nv_bfloat162*>(g + row * rs + h * 64 + 8 * j + c0) =
              __floats2bfloat162_rn(acc[h][4 * j + 2 * r] * mul, acc[h][4 * j + 2 * r + 1] * mul);
      }
    }
}

// The ring's barriers, full[kStages] (the producer's one arrival and the
// bytes) and right after them empty[kStages] (every consumer thread), and
// the fixed rows' barrier, made visible to the whole block. Every thread
// calls it.
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* fixed) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&full[kStages + s], 2 * kWg);
    }
    mbar_init(fixed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// dk, dv: one block per (b, kv head, 128-key tile); the tiles of every
// (b, kv head) at the first key offset come first (the heaviest, causal).
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_lse,
                            const __grid_constant__ CUtensorMap tm_delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV,
                            int Sq, int Skv, int n_bk, BwdStrides st, float scale,
                            int causal) {
  using L = Smem<D>;
  constexpr int NH = L::NH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* fixed = empty + kStages;

  const int kt = blockIdx.x / n_bk, bk = blockIdx.x - kt * n_bk;
  const int b = bk / KV, kvh = bk - b * KV, G = H / KV;
  const int k0 = kt * 2 * kRows;
  const int qt0 = causal ? k0 / kRows : 0;
  const int per_head = max((Sq + kRows - 1) / kRows - qt0, 0);
  const int n_iter = G * per_head;

  init_barriers(full, fixed);

  if (threadIdx.x >= 2 * kWg) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * kWg) {
      // a box wholly past the sequence is not loaded (its rows are no key)
      const int n_rb = k0 + kRows < Skv ? 2 : 1;
      mbar_expect_tx(fixed, 2 * n_rb * NH * kBoxBytes);
      for (int h = 0; h < NH; ++h)
        for (int rb = 0; rb < n_rb; ++rb) {
          const int off = h * 2 * kBoxBytes + rb * kBoxBytes;
          tma_4d(sm + L::kA + off, &tm_k, fixed, h * 64, k0 + rb * kRows, kvh, b);
          tma_4d(sm + L::kB + off, &tm_v, fixed, h * 64, k0 + rb * kRows, kvh, b);
        }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages, gi = it / per_head;
        const int hq = kvh * G + gi, q0 = (qt0 + it - gi * per_head) * kRows;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::kTile + 2 * kVecBox * 4);
        uint8_t* tile = sm + L::kStage0 + s * 2 * L::kTile;
        for (int h = 0; h < NH; ++h) {
          tma_4d(tile + h * kBoxBytes, &tm_q, &full[s], h * 64, q0, hq, b);
          tma_4d(tile + L::kTile + h * kBoxBytes, &tm_do, &full[s], h * 64, q0, hq, b);
        }
        const int row = ((b * H + hq) * Sq + q0) & ~3;
        tma_1d(sm + L::kRowVec + s * 2 * kVecSlot, &tm_lse, &full[s], row);
        tma_1d(sm + L::kRowVec + s * 2 * kVecSlot + kVecSlot, &tm_delta, &full[s], row);
      }
    }
  } else {  // consumer c: keys k0 + 64c ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = threadIdx.x / kWg, tid = threadIdx.x % kWg;
    const int lane = tid & 31, t = lane & 3;
    const int key_lo = k0 + c * kRows;
    const int key = key_lo + (tid >> 5) * 16 + (lane >> 2);  // this thread's keys: key, key + 8
    const float sl2 = scale * kLog2e;
    float dka[NH][32], dva[NH][32];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[h][i] = dva[h][i] = 0.f;
    const uint32_t sK = smem_u32(sm + L::kA) + c * kBoxBytes;
    const uint32_t sV = smem_u32(sm + L::kB) + c * kBoxBytes;
    mbar_wait(fixed, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages, gi = it / per_head;
      const int q0 = (qt0 + it - gi * per_head) * kRows;
      mbar_wait(&full[s], (it / kStages) & 1);
      // no work when this warpgroup's keys all lie past Skv or (causal) after
      // every q row of the tile
      if (key_lo < Skv && (!causal || q0 + kRows - 1 >= key_lo)) {
        const uint32_t sQ = smem_u32(sm + L::kStage0 + s * 2 * L::kTile), sDO = sQ + L::kTile;
        // the tile's first row sits at ((b * H + h) * Sq + q0) % 4 in the box
        const int off = ((b * H + kvh * G + gi) * Sq + q0) & 3;
        const float* Ls = reinterpret_cast<const float*>(sm + L::kRowVec + s * 2 * kVecSlot) + off;
        const float* Ds = Ls + kVecSlot / 4;
        float sa[32], dpa[32];
        wg_fence();
        product_nt<D>(sa, sK, sQ);   // S^T = K.Q^T: keys down, q across
        wg_commit();
        product_nt<D>(dpa, sV, sDO); // dP^T = V.dO^T
        wg_commit();
        wg_wait<1>();
        pin(sa);
        const bool edge = (causal && q0 < key_lo + kRows - 1) || q0 + kRows > Sq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float l2[2] = {Ls[8 * j + 2 * t] * kLog2e, Ls[8 * j + 2 * t + 1] * kLog2e};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(fmaf(sa[4 * j + e], sl2, -l2[e & 1]));
            if (edge) {
              const int qpos = q0 + 8 * j + 2 * t + (e & 1);
              if (qpos >= Sq || (causal && qpos < key + 8 * (e >> 1))) p = 0.f;
            }
            sa[4 * j + e] = p;
          }
        }
        wg_wait<0>();
        pin(dpa);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d2[2] = {Ds[8 * j + 2 * t], Ds[8 * j + 2 * t + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) dpa[4 * j + e] = sa[4 * j + e] * (dpa[4 * j + e] - d2[e & 1]);
        }
        uint32_t pa[4][4], dsa[4][4];
        to_a(sa, pa);
        to_a(dpa, dsa);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          pin(dva[h]);
          pin(dka[h]);
        }
        wg_fence();
        product_rt<NH>(dva, pa, sDO);   // dV += P^T.dO
        product_rt<NH>(dka, dsa, sQ);   // dK += dS^T.Q
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          pin(dva[h]);
          pin(dka[h]);
        }
      }
      mbar_arrive(&empty[s]);
    }
    store_acc<D, NH>(dka, scale, dk + b * st.dk_b + kvh * st.dk_h, st.dk_s, key_lo, Skv);
    store_acc<D, NH>(dva, 1.f, dv + b * st.dv_b + kvh * st.dv_h, st.dv_s, key_lo, Skv);
  }
}

// dq: one block per (b, h, 128-row q tile); the last q tile of every
// (b, h) comes first (the heaviest, causal).
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int H, int KV, int Sq, int Skv, int n_qt,
                          int n_bh, BwdStrides st, float scale, int causal) {
  using L = Smem<D>;
  constexpr int NH = L::NH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* fixed = empty + kStages;

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int bh = blockIdx.x % n_bh;
  const int b = bh / H, h = bh - b * H, kvh = h / (H / KV);
  const int q0 = qt * 2 * kRows;
  const int kv_end = causal ? min(Skv, q0 + 2 * kRows) : Skv;
  const int n_iter = (kv_end + kRows - 1) / kRows;

  init_barriers(full, fixed);

  if (threadIdx.x >= 2 * kWg) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * kWg) {
      // a box wholly past the sequence is not loaded (its rows are no query)
      const int n_rb = q0 + kRows < Sq ? 2 : 1;
      mbar_expect_tx(fixed, 2 * n_rb * NH * kBoxBytes);
      for (int hh = 0; hh < NH; ++hh)
        for (int rb = 0; rb < n_rb; ++rb) {
          const int off = hh * 2 * kBoxBytes + rb * kBoxBytes;
          tma_4d(sm + L::kA + off, &tm_q, fixed, hh * 64, q0 + rb * kRows, h, b);
          tma_4d(sm + L::kB + off, &tm_do, fixed, hh * 64, q0 + rb * kRows, h, b);
        }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::kTile);
        uint8_t* tile = sm + L::kStage0 + s * 2 * L::kTile;
        for (int hh = 0; hh < NH; ++hh) {
          tma_4d(tile + hh * kBoxBytes, &tm_k, &full[s], hh * 64, it * kRows, kvh, b);
          tma_4d(tile + L::kTile + hh * kBoxBytes, &tm_v, &full[s], hh * 64, it * kRows, kvh, b);
        }
      }
    }
  } else {  // consumer c: q rows q0 + 64c ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = threadIdx.x / kWg, tid = threadIdx.x % kWg;
    const int lane = tid & 31, t = lane & 3;
    const int q_lo = q0 + c * kRows;
    const int qrow = q_lo + (tid >> 5) * 16 + (lane >> 2);  // this thread's rows: qrow, qrow + 8
    const float sl2 = scale * kLog2e;
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qrow + 8 * r;
      const int64_t at = static_cast<int64_t>(bh) * Sq + qpos;
      l2[r] = qpos < Sq ? lse[at] * kLog2e : 0.f;
      dl[r] = qpos < Sq ? delta[at] : 0.f;
    }
    float dqa[NH][32];
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[hh][i] = 0.f;
    const uint32_t sQ = smem_u32(sm + L::kA) + c * kBoxBytes;
    const uint32_t sDO = smem_u32(sm + L::kB) + c * kBoxBytes;
    mbar_wait(fixed, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages, k0 = it * kRows;
      mbar_wait(&full[s], (it / kStages) & 1);
      // no work when this warpgroup's rows all lie past Sq or (causal)
      // before every key of the tile
      if (q_lo < Sq && (!causal || k0 <= q_lo + kRows - 1)) {
        const uint32_t sK = smem_u32(sm + L::kStage0 + s * 2 * L::kTile), sV = sK + L::kTile;
        float sa[32], dpa[32];
        wg_fence();
        product_nt<D>(sa, sQ, sK);    // S = Q.K^T
        wg_commit();
        product_nt<D>(dpa, sDO, sV);  // dP = dO.V^T
        wg_commit();
        wg_wait<1>();
        pin(sa);
        const bool edge = (causal && k0 + kRows - 1 > q_lo) || k0 + kRows > Skv;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(fmaf(sa[4 * j + e], sl2, -l2[e >> 1]));
            if (edge) {
              const int kpos = k0 + 8 * j + 2 * t + (e & 1);
              if (kpos >= Skv || (causal && kpos > qrow + 8 * (e >> 1))) p = 0.f;
            }
            sa[4 * j + e] = p;
          }
        wg_wait<0>();
        pin(dpa);
#pragma unroll
        for (int i = 0; i < 32; ++i) dpa[i] = sa[i] * (dpa[i] - dl[(i >> 1) & 1]);
        uint32_t dsa[4][4];
        to_a(dpa, dsa);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) pin(dqa[hh]);
        wg_fence();
        product_rt<NH>(dqa, dsa, sK);  // dQ += dS.K
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) pin(dqa[hh]);
      }
      mbar_arrive(&empty[s]);
    }
    store_acc<D, NH>(dqa, scale, dq + b * st.dq_b + h * st.dq_h, st.dq_s, q_lo, Sq);
  }
}

// ---- host side ----------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up in libcuda at run time (the library
// links the runtime only).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A rank-4 map over the bf16 (B, N, S, D) view at base with element strides
// (sb, sn, ss): 64 x 64 boxes (D, S), 128-byte swizzle, zeros past the edges.
// A dimension of size 1 is never stepped over, so its stride may be any
// legal value.
bool map_bhsd(EncodeTiled enc, CUtensorMap* m, const void* base, int B, int N, int S, int D,
              int64_t sb, int64_t sn, int64_t ss) {
  auto bytes = [](int64_t stride, int n) -> cuuint64_t {
    return n > 1 ? static_cast<cuuint64_t>(stride) * sizeof(bf16) : 16;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(ss, S), bytes(sn, N), bytes(sb, B)};
  const cuuint32_t box[4] = {64, kRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A rank-1 map over n float32 at base (16-byte aligned), boxes of kVecBox.
bool map_rows(EncodeTiled enc, CUtensorMap* m, const float* base, int64_t n) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {sizeof(float)};
  const cuuint32_t box[1] = {kVecBox};
  const cuuint32_t unit[1] = {1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  constexpr int smem = Smem<D>::kAlloc;
  auto dq_kernel = flash_bwd_dq_wgmma_kernel<D>;
  auto dkdv_kernel = flash_bwd_dkdv_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // zeroed maps for q, dO, lse and delta when Sq == 0: no block loads them
  CUtensorMap tq = {}, tk = {}, tv = {}, tdo = {}, tl = {}, td = {};
  bool ok = map_bhsd(enc, &tk, k, B, KV, Skv, D, st.k_b, st.k_h, st.k_s) &&
            map_bhsd(enc, &tv, v, B, KV, Skv, D, st.v_b, st.v_h, st.v_s);
  if (Sq > 0)
    ok = ok && map_bhsd(enc, &tq, q, B, H, Sq, D, st.q_b, st.q_h, st.q_s) &&
         map_bhsd(enc, &tdo, dO, B, H, Sq, D, st.do_b, st.do_h, st.do_s) &&
         map_rows(enc, &tl, lse, static_cast<int64_t>(B) * H * Sq) &&
         map_rows(enc, &td, delta, static_cast<int64_t>(B) * H * Sq);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Sq + 2 * kRows - 1) / (2 * kRows);
  const int n_kt = (Skv + 2 * kRows - 1) / (2 * kRows);
  if (n_qt > 0)
    dq_kernel<<<static_cast<unsigned>(B * H * n_qt), kBlock, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), H, KV, Sq, Skv, n_qt, B * H, st,
        scale, causal);
  dkdv_kernel<<<static_cast<unsigned>(B * KV * n_kt), kBlock, smem, stream>>>(
      tq, tk, tv, tdo, tl, td, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KV, Sq, Skv,
      B * KV, st, scale, causal);
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
// 16-byte aligned). lse: the forward's (B, H, Sq) float32, 16-byte
// aligned; delta: (B, H, Sq) float32 scratch. B*H*ceil(Sq/128),
// B*KV*ceil(Skv/128) and B*H*Sq stay below 2^31 (the wrapper checks).
// Returns cudaGetLastError() after the launches, or the error that kept
// them from being made.
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
