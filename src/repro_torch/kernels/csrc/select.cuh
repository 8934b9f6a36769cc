// Block-wide top-k selection shared by topk_select.cu and locus_merge.cu.
//
// A candidate (score, column) becomes one 64-bit order key: the larger key
// has the higher score and, on equal scores, the lower column — the order
// of `lax.top_k` and of the Pallas kernels' first-maximum argmax.  Round r
// of a selection takes the largest key strictly below round r-1's, so no
// candidate is ever masked or written back: the rows are read, never
// modified, and any width works.  Key 0 means "no candidate left"
// (columns are < 2^31, so every real key is > 0), and ~0 starts the first
// round (every real key is below it).
#pragma once

#include <cuda_runtime.h>

namespace kselect {

typedef unsigned long long u64;

constexpr u64 kNone = 0ull;
constexpr u64 kFirst = ~0ull;

__device__ __forceinline__ u64 order_key(int score, int col) {
  return ((u64)((unsigned)score ^ 0x80000000u) << 32) |
         (u64)(0x7fffffffu - (unsigned)col);
}

__device__ __forceinline__ int key_col(u64 key) {
  return (int)(0x7fffffffu - (unsigned)(key & 0xffffffffull));
}

// Max of every thread's `v` into every thread.  `slots` is shared memory
// for one value per warp; blockDim.x is a multiple of 32.  Starts and
// ends synchronised, so `slots` may be reused by the next call.
__device__ __forceinline__ u64 block_max(u64 v, u64* slots) {
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 m = kNone;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = slots[w] > m ? slots[w] : m;
  __syncthreads();
  return m;
}

}  // namespace kselect
