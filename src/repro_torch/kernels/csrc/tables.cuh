// Table reads shared by the kernels: the search of a sorted int32 table,
// and the compressed layout's flag bits, chain-representative rank (by
// binary search, or through a static search tree) and u16/int32 dtype
// tiers (trie_build.pack_compressed).
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

// rep_rank through the static search tree over the ids
// (core/engine/packed.py `rank_tree`).  Level m >= 1 above the ids holds
// ceil(n / 16^m) keys, key i the largest id of window i (entries
// [16i, 16i + 16)) of the level below, padded with INT_MAX to a multiple
// of 16; the levels are stored top first, and the top one is a single
// window.  A level is one 64-byte node read with four 16-byte loads: the
// count of its keys below `node` is the window to read next, clipped to
// the last (a node above every id).  The ids' own window ends the search.
// ~log16(n) dependent loads, where rep_rank makes ~log2(n).
__device__ __forceinline__ int tree_rank(const int* __restrict__ tree,
                                         const int* __restrict__ ids, int n,
                                         int node) {
  int levels = 0;
  long long span = 16;   // 16^(levels + 1)
  while (span < n) {
    span <<= 4;
    ++levels;
  }
  long long p = 0;     // window at the current level
  long long off = 0;   // the current level's offset in the tree
  for (int m = levels; m >= 1; --m) {
    const int4* w = reinterpret_cast<const int4*>(tree + off + 16 * p);
    int below = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = __ldg(w + q);
      below += (v.x < node) + (v.y < node) + (v.z < node) + (v.w < node);
    }
    const long long keys = (n + (1ll << (4 * m)) - 1) >> (4 * m);
    p = min(16 * p + below, keys - 1);
    // the level's padded size: 16 * ceil(n / 16^(m+1))
    off += ((n + (1ll << (4 * (m + 1))) - 1) >> (4 * (m + 1))) << 4;
  }
  const long long lo = 16 * p;
  int below = 0;
  if (lo + 16 <= n) {
    const int4* w = reinterpret_cast<const int4*>(ids + lo);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = __ldg(w + q);
      below += (v.x < node) + (v.y < node) + (v.z < node) + (v.w < node);
    }
  } else {
    for (long long i = lo; i < n; ++i) below += ids[i] < node;
  }
  const long long pos = lo + below;
  return pos < n ? (int)pos : n - 1;
}

// Entry i of a tier-variable table, widened to int: u16 when `u16`, int32
// otherwise.
__device__ __forceinline__ int load_tier(const void* p, long long i,
                                         int u16) {
  return u16 ? (int)((const unsigned short*)p)[i] : ((const int*)p)[i];
}

}  // namespace tables
