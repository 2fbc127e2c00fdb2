// Shared helpers for the relational kernels: warp / block reductions.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;  // every relational kernel launches 256 threads

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

template <typename T> __device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// Sum of one value per thread over a kThreads-thread block; the result is
// valid in thread 0. Every thread of the block must call it.
template <typename T> __device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_tot[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_tot[wid] = v;
  __syncthreads();
  v = 0;
  if (wid == 0) {
    v = lane < kThreads / 32 ? warp_tot[lane] : T(0);
    v = warp_sum(v);
  }
  return v;
}
