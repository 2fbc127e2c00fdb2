// bf16 tensor-core and copy helpers of the flash forward
// (flash_attention.cu): cp.async into shared memory, ldmatrix,
// mma.sync.m16n8k16 over bf16 with float32 accumulators.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
// sequence, into shared rows of D + 8 elements (padded by 16 bytes, which
// puts the 8 rows of every ldmatrix on distinct bank groups), by the
// block's THREADS threads; rows at or past n_rows are zeroed.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm, const __nv_bfloat16* g,
                                          int64_t rs, int row0, int n_rows) {
  constexpr int C = D / 8;  // 16-byte chunks per row
  constexpr int kLd = D + 8;
  for (int i = threadIdx.x; i < ROWS * C; i += THREADS) {
    const int r = i / C, c = i - r * C;
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* src = g + (ok ? (row0 + r) * rs : 0) + c * 8;
    cp_async16(smem_addr(sm + r * kLd + c * 8), src, ok);
  }
}

}  // namespace
