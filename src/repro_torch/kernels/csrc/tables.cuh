// Table reads shared by the kernels: the search of a sorted int32 table,
// and the compressed layout's flag bits, chain-representative rank and
// u16/int32 dtype tiers (trie_build.pack_compressed).
#pragma once

#include <cuda_runtime.h>

namespace tables {

// p_flags bits of the compressed layout (trie_build.PACK_*)
constexpr int kDictUnary = 1;
constexpr int kSynUnary = 2;
constexpr int kIsSyn = 4;

// First index in [lo, hi) of a sorted int32 table with a[idx] >= x.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo,
                                           int hi, int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Rank of a node's chain representative in the n >= 1 sorted stored ids:
// the first id at or after it, clipped to the last (an unstored dict node
// reads every per-node value there).
__device__ __forceinline__ int rep_rank(const int* __restrict__ ids, int n,
                                        int node) {
  const int pos = lower_bound(ids, 0, n, node);
  return pos < n ? pos : n - 1;
}

// Entry i of a tier-variable table, widened to int: u16 when `u16`, int32
// otherwise.
__device__ __forceinline__ int load_tier(const void* p, long long i,
                                         int u16) {
  return u16 ? (int)((const unsigned short*)p)[i] : ((const int*)p)[i];
}

}  // namespace tables
