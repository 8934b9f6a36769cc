// Cached phase 2: per-node top-K gather + merge over a locus antichain
// (loci int32[B, F] -> scores[B, k], sids[B, k]) on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/locus_merge.py:53
// `locus_topk_merge`, and the wrapper around it that reads the packed
// layout's quantized cache (repro/kernels/ops.py:285
// `cached_topk_merge_packed`).  The candidates are the F*K entries of the
// loci's cache rows, loci-major then K-minor, -1 where a slot is empty;
// the result is their top k by (score, lower flat index), padded with -1
// when k >= F*K.
//
//   1. Each locus finds its cache row: the node itself in the dense layout
//      (int32 topk_score/topk_sid [N, K]); in the packed layout the rank
//      of its chain representative among the sorted c_ids, through the
//      static 16-ary search tree over c_ids (tables.cuh `tree_rank`: one
//      64-byte node a level, ~log16(n_c) dependent loads in place of the
//      ~log2(n_c) of a binary search).
//   2. Packed rows are decoded at the read: a u16 entry e means score
//      base[row] + e - 1 and sid e - 1, 0 is an empty slot; i32 entries
//      are raw.  Only the rows gathered are decoded.
//   3. Warp path, F*K <= 1024: one warp per query.  The lanes find the F
//      rows (one locus a lane, F <= 32 at the engine's widths) and their
//      score bases into the warp's slice of shared memory, then gather
//      candidate i*32 + lane straight into key[i] / sid[i] in registers
//      (R = 1..32 a lane, a template parameter).  A lane's R loads are
//      unconditional, so all are in flight at once, and a warp load reads
//      32 neighbouring entries: a K=16 row pair is one 128-byte line.
//      select.cuh `warp_select` takes the k rounds with no barrier and no
//      shared memory.  Several queries a block, one per warp.
//   4. Block path, F*K > 1024 (never on the cached route's widths, kept so
//      that no shape that ran before raises): one block per query stages
//      the candidates in shared memory and takes k rounds of block-wide
//      argmax (select.cuh `block_max`).
//
// Bound: the bytes a query must read are its F loci, F cache rows of K
// (score, sid) pairs and, packed, a rank search per locus: ~20 KB for
// B=64, F=32, K=16, ~6 ns at 3.35 TB/s.  What costs is latency: the
// chain of dependent loads of a rank search, the gather, and k dependent
// selection rounds.  What the design does about it: the tree cuts the
// rank chain to ~log16(n_c) loads, every row is read once into registers,
// and a round is a few dozen instructions of one warp.
#include <cuda_runtime.h>

#include "select.cuh"
#include "tables.cuh"

// Mirrors the wrapper's ctypes structure (locus_merge.py `_Cache`); the
// wrapper builds it once per index.
struct Cache {
  // dense: int32 [N, K]; packed: u16 or int32 [C, K] per the two tiers
  const void* score;
  const void* sid;
  const int* base;   // packed: per-row score base
  const int* c_ids;  // packed: stored node ids, sorted
  const int* tree;   // packed: the search tree over c_ids
  int packed;
  int K;
  int score_u16;
  int sid_u16;
  int n_c;
  int pad_;
};

namespace {

using kselect::u64;
using tables::load_tier;

// Cache row of a locus (>= 0): the node (dense) or the clipped rank of
// its chain representative in c_ids (packed).
__device__ __forceinline__ int cache_row(const Cache& c, int node) {
  return c.packed ? tables::tree_rank(c.tree, c.c_ids, c.n_c, node) : node;
}

// Entry e of cache row r, decoded: (score, sid).
__device__ __forceinline__ void cache_entry(const Cache& c, int r, int e,
                                            int& s, int& p) {
  const long long i = (long long)r * c.K + e;
  const int es = load_tier(c.score, i, c.score_u16);
  const int ei = load_tier(c.sid, i, c.sid_u16);
  if (c.packed && c.score_u16) {
    s = es == 0 ? -1 : c.base[r] + es - 1;
  } else {
    s = es;
  }
  if (c.packed && c.sid_u16) {
    p = ei == 0 ? -1 : ei - 1;
  } else {
    p = ei;
  }
}

// Entry at[i] of a tier-variable table for each of a lane's R candidates
// (at[i] < 0: none, entry 0 is read and ignored).  The tier is a branch
// outside the unrolled loop, so the R loads are all in flight at once.
template <int R>
__device__ __forceinline__ void load_entries(const void* table, int u16,
                                             const int (&at)[R],
                                             int (&v)[R]) {
  if (u16) {
    const unsigned short* t = (const unsigned short*)table;
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = __ldg(t + max(at[i], 0));
  } else {
    const int* t = (const int*)table;
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = __ldg(t + max(at[i], 0));
  }
}

template <int R>
__global__ void __launch_bounds__(256)
    merge_warp(Cache c, const int* __restrict__ loci, int batch, int F,
               int k, int* __restrict__ out_s, int* __restrict__ out_p) {
  extern __shared__ int smem[];
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= batch) return;   // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  // this warp's F cache rows and, for the u16 score tier, their bases:
  // one locus a lane
  int* rows = smem + (threadIdx.x >> 5) * 2 * F;
  int* bases = rows + F;
  const bool biased = c.packed && c.score_u16;
  for (int f = lane; f < F; f += 32) {
    const int node = loci[(long long)b * F + f];
    const int r = node < 0 ? -1 : cache_row(c, node);
    rows[f] = r;
    bases[f] = biased && r >= 0 ? c.base[r] : 0;
  }
  __syncwarp();
  const int K = c.K;
  const int C = F * K;
  // j / K for j < C <= 1024 as one multiply: (j + 0.5) / K is at least
  // 0.5 / K >= 2^-11 from an integer, far beyond float's error there
  const float inv_k = 1.0f / (float)K;
  int at[R];   // the entry of candidate i*32 + lane, -1 where none
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = i * 32 + lane;
    const int f = (int)(((float)min(j, C - 1) + 0.5f) * inv_k);
    const int r = rows[f];
    at[i] = j < C && r >= 0 ? r * K + (j - f * K) : -1;
  }
  int es[R];
  int ei[R];
  load_entries<R>(c.score, c.score_u16, at, es);
  load_entries<R>(c.sid, c.sid_u16, at, ei);
  const bool sid_biased = c.packed && c.sid_u16;
  u64 key[R];
  int sid[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = i * 32 + lane;
    int s = -1;
    int p = -1;
    if (at[i] >= 0) {
      // the row's base is read again rather than kept: R more registers
      // a lane spill at R = 32
      const int f = (int)(((float)j + 0.5f) * inv_k);
      s = biased ? (es[i] == 0 ? -1 : bases[f] + es[i] - 1) : es[i];
      p = sid_biased ? ei[i] - 1 : ei[i];   // a u16 0 (empty) is -1
    }
    key[i] = j < C ? kselect::order_key(s, j) : kselect::kNone;
    sid[i] = p;
  }
  kselect::warp_select<R>(key, sid, k, out_s + (long long)b * k,
                          out_p + (long long)b * k);
}

__global__ void merge_block(Cache c, const int* __restrict__ loci, int F,
                            int k, int* __restrict__ out_s,
                            int* __restrict__ out_p) {
  extern __shared__ int smem[];
  const int K = c.K;
  const int C = F * K;
  int* cs = smem;       // C candidate scores
  int* ci = cs + C;     // C candidate sids
  int* rows = ci + C;   // F cache rows (-1: empty slot)
  __shared__ u64 slots[32];

  const int b = blockIdx.x;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const int node = loci[(long long)b * F + f];
    rows[f] = node < 0 ? -1 : cache_row(c, node);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const int r = rows[j / K];
    int s = -1;
    int p = -1;
    if (r >= 0) cache_entry(c, r, j % K, s, p);
    cs[j] = s;
    ci[j] = p;
  }
  __syncthreads();

  u64 prev = kselect::kFirst;
  for (int r = 0; r < k; ++r) {
    u64 best = kselect::kNone;
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const u64 key = kselect::order_key(cs[j], j);
      if (key < prev && key > best) best = key;
    }
    best = kselect::block_max(best, slots);
    if (threadIdx.x == 0) {
      const long long o = (long long)b * k + r;
      if (best == kselect::kNone) {   // k >= F*K: the union is exhausted
        out_s[o] = -1;
        out_p[o] = -1;
      } else {
        const int col = kselect::key_col(best);
        out_s[o] = cs[col];
        out_p[o] = ci[col];
      }
    }
    prev = best;
  }
}

// The largest dynamic shared memory merge_block has been allowed in this
// process: cudaFuncSetAttribute runs once per larger size, not per launch.
int g_block_shared = 48 * 1024;

template <int R>
void launch_warp(const Cache& c, const int* loci, int batch, int F, int k,
                 int threads, int shared, int* out_s, int* out_p,
                 cudaStream_t stream) {
  const int warps = threads / 32;
  merge_warp<R><<<(batch + warps - 1) / warps, threads, shared, stream>>>(
      c, loci, batch, F, k, out_s, out_p);
}

}  // namespace

// cache: the index's tables (built once by the wrapper); out: int32[2,
// batch, k] (scores, then sids).  regs: keys a lane on the warp path (1,
// 2, 4, 8, 16 or 32), 0 for the block path; threads: the block's threads
// (a warp multiple); shared: its dynamic shared memory in bytes.
extern "C" int locus_merge_launch(const Cache* cache, const void* loci,
                                  int batch, int F, int k, int regs,
                                  int threads, int shared, void* out,
                                  void* stream) {
  const Cache c = *cache;
  const int* l = (const int*)loci;
  int* out_s = (int*)out;
  int* out_p = out_s + (long long)batch * k;
  cudaStream_t st = (cudaStream_t)stream;
  if (batch <= 0) return (int)cudaGetLastError();
  switch (regs) {
    case 0:
      if (shared > g_block_shared) {
        const cudaError_t err = cudaFuncSetAttribute(
            merge_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
            shared);
        if (err != cudaSuccess) return (int)err;
        g_block_shared = shared;
      }
      merge_block<<<batch, threads, shared, st>>>(c, l, F, k, out_s, out_p);
      break;
    case 1: launch_warp<1>(c, l, batch, F, k, threads, shared, out_s, out_p, st); break;
    case 2: launch_warp<2>(c, l, batch, F, k, threads, shared, out_s, out_p, st); break;
    case 4: launch_warp<4>(c, l, batch, F, k, threads, shared, out_s, out_p, st); break;
    case 8: launch_warp<8>(c, l, batch, F, k, threads, shared, out_s, out_p, st); break;
    case 16: launch_warp<16>(c, l, batch, F, k, threads, shared, out_s, out_p, st); break;
    case 32: launch_warp<32>(c, l, batch, F, k, threads, shared, out_s, out_p, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* locus_merge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
