// Top-k selection shared by topk_select.cu and locus_merge.cu: one warp
// per row with the candidates in registers, and a block-wide fallback for
// rows wider than a warp holds.
//
// A candidate (score, column) becomes one 64-bit order key: the larger key
// has the higher score and, on equal scores, the lower column — the order
// of `lax.top_k` and of the Pallas kernels' first-maximum argmax.  Round r
// of a selection takes the largest key strictly below round r-1's, so no
// candidate is ever masked or written back: the rows are read, never
// modified, and any row order works.  Key 0 means "no candidate left"
// (columns are < 2^31, so every real key is > 0), and ~0 starts the first
// round (every real key is below it).
#pragma once

#include <cuda_runtime.h>

namespace kselect {

typedef unsigned long long u64;

constexpr u64 kNone = 0ull;
constexpr u64 kFirst = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ u64 order_key(int score, int col) {
  return ((u64)((unsigned)score ^ 0x80000000u) << 32) |
         (u64)(0x7fffffffu - (unsigned)col);
}

__device__ __forceinline__ int key_col(u64 key) {
  return (int)(0x7fffffffu - (unsigned)(key & 0xffffffffull));
}

__device__ __forceinline__ int key_score(u64 key) {
  return (int)((unsigned)(key >> 32) ^ 0x80000000u);
}

// Max of every thread's `v` into every thread.  `slots` is shared memory
// for one value per warp; blockDim.x is a multiple of 32.  Starts and
// ends synchronised, so `slots` may be reused by the next call.
__device__ __forceinline__ u64 block_max(u64 v, u64* slots) {
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_down_sync(kFull, v, off);
    v = o > v ? o : v;
  }
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 m = kNone;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = slots[w] > m ? slots[w] : m;
  __syncthreads();
  return m;
}

// m[0] = max(m[0 .. 2W)): a tree of halvings whose widths are compile-time
// constants, so every index is static and m stays in registers.
template <int W, int R>
__device__ __forceinline__ void tree_max(u64 (&m)[R]) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) m[i] = m[i] > m[i + W] ? m[i] : m[i + W];
    tree_max<W / 2>(m);
  }
}

// The largest of a lane's R keys below `prev` (kNone if none): the keys
// are masked independently, then reduced as a tree, so the compares of a
// round overlap instead of forming one chain of R.
template <int R>
__device__ __forceinline__ u64 lane_max_below(const u64 (&key)[R],
                                              u64 prev) {
  u64 m[R];
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = key[i] < prev ? key[i] : kNone;
  tree_max<R / 2>(m);
  return m[0];
}

// The warp's largest 64-bit key, in every lane: two 32-bit warp
// reductions (Ampere's redux.sync, one instruction each) — the largest
// high word, then the largest low word among the lanes holding it — in
// place of a 5-step butterfly of 64-bit shuffles (ten shfl.sync).
__device__ __forceinline__ u64 warp_max(u64 v) {
  const unsigned hi = __reduce_max_sync(kFull, (unsigned)(v >> 32));
  const unsigned lo = __reduce_max_sync(
      kFull, (unsigned)(v >> 32) == hi ? (unsigned)v : 0u);
  return ((u64)hi << 32) | lo;
}

// The top k of one row held by a warp: lane l holds columns i*32 + l in
// key[i] (kNone past the row) and their payloads in pay[i].  Round r: each
// lane takes the largest of its keys below round r-1's (unrolled compares,
// the arrays stay in registers), `warp_max` gives every lane the warp's
// maximum, and the lane that holds that column writes its score and
// payload to out_s[r] / out_p[r].  No barrier and no shared memory in a
// round.  Once the row is exhausted (k > its width) the rest is -1,
// written by the whole warp at once.
template <int R>
__device__ __forceinline__ void warp_select(const u64 (&key)[R],
                                            const int (&pay)[R], int k,
                                            int* __restrict__ out_s,
                                            int* __restrict__ out_p) {
  const int lane = threadIdx.x & 31;
  u64 prev = kFirst;
  for (int r = 0; r < k; ++r) {
    const u64 best = warp_max(lane_max_below<R>(key, prev));
    if (best == kNone) {            // warp-uniform: the row is exhausted
      for (int t = r + lane; t < k; t += 32) {
        out_s[t] = -1;
        out_p[t] = -1;
      }
      return;
    }
    const int col = key_col(best);
    if ((col & 31) == lane) {
      const int slot = col >> 5;
      int p = -1;
#pragma unroll
      for (int i = 0; i < R; ++i) p = i == slot ? pay[i] : p;
      out_s[r] = key_score(best);
      out_p[r] = p;
    }
    prev = best;
  }
}

}  // namespace kselect
