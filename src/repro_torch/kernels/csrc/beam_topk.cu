// Fused beam phase 2 (generator-pool priority search) on Hopper (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/beam_topk.py:413
// `beam_topk_batch` (emission tables resident in VMEM), :463
// `beam_topk_batch_streamed` (tables in HBM behind windowed DMA) and :440
// `beam_topk_batch_packed` (the compressed layout's emission store): on
// the card the emission tables sit in device memory and this one kernel
// reads them there, whatever their size.
//
// The search is written once, templated on its emission accessor — the
// seam of the Pallas kernels' `_ResidentEmit` / `_PackedEmit`:
//   - DenseEmit reads emit_ptr / emit_node / emit_score / emit_is_leaf and
//     leaf_sid;
//   - PackedEmit reads the chain-collapsed store: a stored node (a c_ids
//     entry) reads its emission row at its rank; an unstored, non-synonym
//     node has exactly one emission, (v+1, max_score of its chain
//     representative, not a leaf), at cursor 0; a leaf's string id comes
//     from a rank lookup into l_ids.  The u16 / i32 tiers of c_escore,
//     c_maxscore and l_sid widen to int at the load.
// Scores, sids and `exact` are therefore bit-identical across layouts.
//
// One thread block per query.  The pool (node `gn`, emission cursor `gc`,
// admissible bound `gb`; width W), the result heap (k) and `dropped_max`
// live in shared memory for the whole search.  Each step pops the best P
// generators, folds leaf emissions into the heap, turns internal emissions
// into new generators, advances the popped ones, and keeps the best W of
// the merged pool.  Every selection follows `lax.top_k` on the 64-bit key
// (INT_MAX - bound) << 32 | column: descending bound, ties to the lower
// column, so incumbents win ties over new entries exactly as in the
// reference.  The block loops while the reference's condition holds (best
// bound >= 0 and above the k-th score, fewer than max_steps steps), then
// sets exact = (dropped_max <= k-th score) & finished.
//
// Bound: the bytes a query must read are the emissions it pops (node,
// score, leaf flag) and the pointer pairs of the generators it re-arms —
// a few kilobytes, ~1e-5 ms at 3.35 TB/s for a batch of 64 — so the
// kernel is bound by its chain of block barriers and dependent loads.  The
// earlier design ran three block-wide bitonic sorts a step (the pop over
// W, the heap over k + P, the pool over W + P) and a block max, ~65
// barrier stages a step at W = 48, P = 8, k = 10, and re-read the bound of
// all W generators each step (on the packed accessor, a rank search each).
// This design keeps three facts exact:
//   - after a step the pool is in key order (column = rank), so from the
//     second step on the pop is columns 0..P-1 and the best bound gb[0];
//   - only the P popped entries and the P new generators change, so the
//     next pool is the merge of those 2P with the unchanged sorted run
//     P..W-1, and the heap the merge of k incumbents with P leaves; with
//     unique keys each element's place is its rank in its own list plus
//     its rank in the other (a merge path by counting and binary search),
//     the full sort's result exactly, and the best dropped bound is the
//     entry that lands at W;
//   - only the popped generators need a new bound, read with their
//     emission (one rank search on the packed accessor, not W).
// The first step's pool, formed from the loci, is unsorted, so step 0
// keeps the full sorts.  A later step is two block barriers: one after the
// P pops, one after the merges (a one-warp block at the default widths).
#include <cuda_runtime.h>

#include "tables.cuh"

namespace {

using tables::load_tier;

typedef unsigned long long u64;
constexpr int kIntMax = 2147483647;
constexpr u64 kPad = ~0ull;
constexpr u64 kColMask = 0xffffffffull;

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Sort key: ascending key = descending value, ties to the lower column.
// Values are >= -1, so INT_MAX - value fits in 32 unsigned bits.
__device__ __forceinline__ u64 rank_key(int value, int col) {
  return ((u64)((long long)kIntMax - (long long)value) << 32) |
         (u64)(unsigned)col;
}

__device__ void bitonic_sort(u64* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 x = a[lo];
        const u64 y = a[hi];
        if ((x > y) == up) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Emission reads of the uniform int32 layout.
struct DenseEmit {
  const int* emit_ptr;
  const int* emit_node;
  const int* emit_score;
  const unsigned char* emit_leaf;
  const int* leaf_sid;

  // Admissible bound of a generator: the score of its current emission,
  // or -1 when the node is dead or the cursor ran off its emission list.
  __device__ int bound(int node, int cursor) const {
    if (node < 0) return -1;
    const int e = emit_ptr[node] + cursor;
    return e < emit_ptr[node + 1] ? emit_score[e] : -1;
  }
  // The current emission of a live generator (its cursor is in-row), and
  // `next`, its bound once advanced: bound(node, cursor + 1).
  __device__ void pop(int node, int cursor, int& en, int& score, bool& leaf,
                      int& next) const {
    const int e = emit_ptr[node] + cursor;
    en = emit_node[e];
    score = emit_score[e];
    leaf = emit_leaf[e] != 0;
    next = e + 1 < emit_ptr[node + 1] ? emit_score[e + 1] : -1;
  }
  __device__ int sid(int leaf_node) const { return leaf_sid[leaf_node]; }
};

// Emission reads of the compressed layout (trie_build.pack_compressed).
struct PackedEmit {
  const unsigned char* flags;
  const int* c_ids;
  int n_c;
  const int* eptr;
  const int* enode;
  const void* escore;
  int escore_u16;
  const unsigned char* eleaf;
  const void* maxscore;
  int maxscore_u16;
  const int* l_ids;
  int n_l;
  const void* l_sid;
  int l_sid_u16;

  // the clipped rank of node's chain representative in c_ids; `stored`
  // when node is itself a c_ids entry
  __device__ int rep(int node, bool& stored) const {
    const int rc = tables::rep_rank(c_ids, n_c, node);
    stored = c_ids[rc] == node;
    return rc;
  }
  __device__ int bound(int node, int cursor) const {
    if (node < 0) return -1;
    bool stored;
    const int rc = rep(node, stored);
    if (stored) {
      const int e = eptr[rc] + cursor;
      return e < eptr[rc + 1] ? load_tier(escore, e, escore_u16) : -1;
    }
    if (!(flags[node] & tables::kIsSyn) && cursor == 0) {
      return load_tier(maxscore, rc, maxscore_u16);
    }
    return -1;
  }
  __device__ void pop(int node, int cursor, int& en, int& score, bool& leaf,
                      int& next) const {
    bool stored;
    const int rc = rep(node, stored);
    if (stored) {
      const int e = eptr[rc] + cursor;
      en = enode[e];
      score = load_tier(escore, e, escore_u16);
      leaf = eleaf[e] != 0;
      next = e + 1 < eptr[rc + 1] ? load_tier(escore, e + 1, escore_u16)
                                  : -1;
    } else {   // the derived emission of a chain node: its only one
      en = node + 1;
      score = load_tier(maxscore, rc, maxscore_u16);
      leaf = false;
      next = -1;
    }
  }
  __device__ int sid(int leaf_node) const {
    return load_tier(l_sid, tables::rep_rank(l_ids, n_l, leaf_node),
                     l_sid_u16);
  }
};

// Max of vals[0, n) (all >= -1) into every thread.
__device__ int block_max(const int* vals, int n, int* slot) {
  if (threadIdx.x == 0) *slot = -1;
  __syncthreads();
  int m = -1;
  for (int j = threadIdx.x; j < n; j += blockDim.x) m = max(m, vals[j]);
  atomicMax(slot, m);
  __syncthreads();
  const int out = *slot;
  __syncthreads();
  return out;
}

// Entries of one merge side: key, node, cursor, bound.
struct Entry {
  u64 key;
  int n;
  int c;
  int b;
};

// How many of keys[0, n) are below `key` (keys unique, in any order).
__device__ __forceinline__ int count_below(const u64* keys, int n, u64 key) {
  int r = 0;
  for (int i = 0; i < n; ++i) r += keys[i] < key ? 1 : 0;
  return r;
}

// How many of the sorted run rank_key(vals[j], j), j in [lo, hi), are
// below `key`.
__device__ __forceinline__ int run_below(const int* vals, int lo, int hi,
                                         u64 key) {
  const int base = lo;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rank_key(vals[mid], mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - base;
}

template <class E>
__global__ void beam_topk_kernel(E em, const int* __restrict__ loci, int F,
                                 int W,
                                 int P, int k, int max_steps, int key_cap,
                                 int* __restrict__ out_scores,
                                 int* __restrict__ out_sids,
                                 unsigned char* __restrict__ out_exact) {
  extern __shared__ u64 smem64[];
  u64* keys = smem64;                       // key_cap sort keys (step 0)
  u64* ch_key = keys + key_cap;             // 2P changed pool entries
  u64* lf_key = ch_key + 2 * P;             // P new leaves
  int* gn = (int*)(lf_key + P);             // W generator nodes
  int* gc = gn + W;                         // W emission cursors
  int* gb = gc + W;                         // W admissible bounds
  int* pool_n = gb + W;                     // W + P merged pool
  int* pool_c = pool_n + W + P;
  int* pool_b = pool_c + W + P;
  int* ls = pool_b + W + P;                 // k result scores
  int* li = ls + k;                         // k result string ids
  int* cat_s = li + k;                      // k + P heap merge
  int* cat_i = cat_s + k + P;
  int* topi = cat_i + k + P;                // P popped columns
  int* popped = topi + P;                   // P popped-valid flags
  int* ch_n = popped + P;                   // 2P changed entries
  int* ch_c = ch_n + 2 * P;
  int* ch_b = ch_c + 2 * P;
  int* lf_s = ch_b + 2 * P;                 // P new leaves
  int* lf_i = lf_s + P;
  __shared__ int s_slot;
  __shared__ int s_dropped;

  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int n = j < F ? loci[(long long)b * F + j] : -1;
    const int bound = em.bound(n, 0);
    gn[j] = bound >= 0 ? n : -1;
    gc[j] = 0;
    gb[j] = bound;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    ls[j] = -1;
    li[j] = -1;
  }
  if (threadIdx.x == 0) s_dropped = -1;
  __syncthreads();

  // the current and the next pool and heap: step 0 leaves its result in
  // (gn, gc, gb) and (ls, li); each later step merges into the others
  int* cn = gn;
  int* cc = gc;
  int* cb = gb;
  int* cs = ls;
  int* ci = li;
  int* nn = pool_n;
  int* nc = pool_c;
  int* nb = pool_b;
  int* ns = cat_s;
  int* ni = cat_i;
  bool sorted = false;   // the pool is in key order (after step 0)
  for (int step = 0; step < max_steps; ++step) {
    const int best = sorted ? cb[0] : block_max(gb, W, &s_slot);
    if (!(best >= 0 && cs[k - 1] < best)) break;   // uniform

    if (!sorted) {
      // step 0: the pool is as the loci left it, so each selection is a
      // full sort
      const int n_pop = pow2_at_least(W);
      const int n_heap = pow2_at_least(k + P);
      const int n_pool = pow2_at_least(W + P);
      for (int j = threadIdx.x; j < n_pop; j += blockDim.x) {
        keys[j] = j < W ? rank_key(gb[j], j) : kPad;
      }
      __syncthreads();
      bitonic_sort(keys, n_pop);
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        const int col = (int)(keys[p] & kColMask);
        topi[p] = col;
        int new_n = -1;
        int new_b = -1;
        int leaf_s = -1;
        int leaf_i = -1;
        const bool valid = gb[col] >= 0;
        if (valid) {
          int en;
          int sc;
          bool lf;
          int next;
          em.pop(gn[col], gc[col], en, sc, lf, next);
          if (lf) {
            leaf_s = sc;
            leaf_i = em.sid(en);
          } else {
            new_b = em.bound(en, 0);
            new_n = new_b >= 0 ? en : -1;
          }
        }
        popped[p] = valid ? 1 : 0;
        cat_s[k + p] = leaf_s;
        cat_i[k + p] = leaf_i;
        pool_n[W + p] = new_n;
        pool_c[W + p] = 0;
        pool_b[W + p] = new_b;
      }
      for (int j = threadIdx.x; j < k; j += blockDim.x) {
        cat_s[j] = ls[j];
        cat_i[j] = li[j];
      }
      for (int j = threadIdx.x; j < W; j += blockDim.x) pool_c[j] = gc[j];
      __syncthreads();

      // advance the popped generators (distinct columns)
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        if (popped[p]) pool_c[topi[p]] += 1;
      }
      // leaves -> result heap (incumbents sit at the lower columns)
      for (int j = threadIdx.x; j < n_heap; j += blockDim.x) {
        keys[j] = j < k + P ? rank_key(cat_s[j], j) : kPad;
      }
      __syncthreads();
      for (int j = threadIdx.x; j < W; j += blockDim.x) {
        const int bound = em.bound(gn[j], pool_c[j]);
        pool_b[j] = bound;
        pool_n[j] = bound >= 0 ? gn[j] : -1;
      }
      bitonic_sort(keys, n_heap);
      for (int r = threadIdx.x; r < k; r += blockDim.x) {
        const int col = (int)(keys[r] & kColMask);
        ls[r] = cat_s[col];
        li[r] = cat_i[col];
      }
      __syncthreads();

      // merge the pools, keep the best W by bound, track the best dropped
      for (int j = threadIdx.x; j < n_pool; j += blockDim.x) {
        keys[j] = j < W + P ? rank_key(pool_b[j], j) : kPad;
      }
      __syncthreads();
      bitonic_sort(keys, n_pool);
      int drop = -1;
      for (int r = threadIdx.x; r < W + P; r += blockDim.x) {
        const int col = (int)(keys[r] & kColMask);
        if (r < W) {
          gn[r] = pool_n[col];
          gc[r] = pool_c[col];
          gb[r] = pool_b[col];
        } else {
          drop = max(drop, pool_b[col]);
        }
      }
      atomicMax(&s_dropped, drop);
      __syncthreads();
      sorted = true;
      continue;
    }

    // a later step: pop columns 0..P-1 (changed entries 0..P-1 keep their
    // columns, new generators P..2P-1 take columns W..W+P-1)
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      int adv_n = cn[p];
      int adv_c = cc[p];
      int adv_b = cb[p];
      int new_n = -1;
      int new_b = -1;
      int leaf_s = -1;
      int leaf_i = -1;
      if (adv_b >= 0) {
        int en;
        int sc;
        bool lf;
        int next;
        em.pop(adv_n, adv_c, en, sc, lf, next);
        if (lf) {
          leaf_s = sc;
          leaf_i = em.sid(en);
        } else {
          new_b = em.bound(en, 0);
          new_n = new_b >= 0 ? en : -1;
        }
        adv_c += 1;
        adv_b = next;
        adv_n = next >= 0 ? adv_n : -1;
      }
      ch_n[p] = adv_n;
      ch_c[p] = adv_c;
      ch_b[p] = adv_b;
      ch_key[p] = rank_key(adv_b, p);
      ch_n[P + p] = new_n;
      ch_c[P + p] = 0;
      ch_b[P + p] = new_b;
      ch_key[P + p] = rank_key(new_b, W + p);
      lf_s[p] = leaf_s;
      lf_i[p] = leaf_i;
      lf_key[p] = rank_key(leaf_s, k + p);
    }
    __syncthreads();

    // the pool: the sorted run P..W-1 and the 2P changed entries, each
    // placed at its rank in its own side plus its rank in the other
    for (int x = threadIdx.x; x < W + P; x += blockDim.x) {
      Entry e;
      int pos;
      if (x < W - P) {
        const int j = P + x;
        e = {rank_key(cb[j], j), cn[j], cc[j], cb[j]};
        pos = x + count_below(ch_key, 2 * P, e.key);
      } else {
        const int q = x - (W - P);
        e = {ch_key[q], ch_n[q], ch_c[q], ch_b[q]};
        pos = count_below(ch_key, 2 * P, e.key) + run_below(cb, P, W, e.key);
      }
      if (pos < W) {
        nn[pos] = e.n;
        nc[pos] = e.c;
        nb[pos] = e.b;
      } else if (pos == W) {   // the best of the dropped tail
        s_dropped = max(s_dropped, e.b);
      }
    }
    // the heap: the k incumbents (sorted) and the P leaves
    for (int x = threadIdx.x; x < k + P; x += blockDim.x) {
      int sc;
      int id;
      int pos;
      if (x < k) {
        sc = cs[x];
        id = ci[x];
        pos = x + count_below(lf_key, P, rank_key(sc, x));
      } else {
        const int p = x - k;
        sc = lf_s[p];
        id = lf_i[p];
        pos = count_below(lf_key, P, lf_key[p]) +
              run_below(cs, 0, k, lf_key[p]);
      }
      if (pos < k) {
        ns[pos] = sc;
        ni[pos] = id;
      }
    }
    __syncthreads();
    int* t = cn; cn = nn; nn = t;
    t = cc; cc = nc; nc = t;
    t = cb; cb = nb; nb = t;
    t = cs; cs = ns; ns = t;
    t = ci; ci = ni; ni = t;
  }

  const int best = sorted ? cb[0] : block_max(gb, W, &s_slot);
  const int kth = cs[k - 1];
  const bool finished = !(best >= 0 && kth < best);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out_scores[(long long)b * k + j] = cs[j];
    out_sids[(long long)b * k + j] = ci[j];
  }
  if (threadIdx.x == 0) {
    out_exact[b] = (s_dropped <= kth && finished) ? 1 : 0;
  }
}

template <class E>
int launch(const E& em, const void* loci, int batch, int frontier, int gens,
           int expand, int k, int max_steps, int key_cap, int threads,
           int shared_bytes, void* out_scores, void* out_sids,
           void* out_exact, void* stream) {
  if (batch > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_topk_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
    beam_topk_kernel<E><<<batch, threads, shared_bytes,
                          (cudaStream_t)stream>>>(
        em, (const int*)loci, frontier, gens, expand, k, max_steps, key_cap,
        (int*)out_scores, (int*)out_sids, (unsigned char*)out_exact);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int beam_topk_launch(const void* emit_ptr, const void* emit_node,
                                const void* emit_score, const void* emit_leaf,
                                const void* leaf_sid, const void* loci,
                                int batch, int frontier, int gens, int expand,
                                int k, int max_steps, int key_cap,
                                int threads, int shared_bytes,
                                void* out_scores, void* out_sids,
                                void* out_exact, void* stream) {
  DenseEmit em;
  em.emit_ptr = (const int*)emit_ptr;
  em.emit_node = (const int*)emit_node;
  em.emit_score = (const int*)emit_score;
  em.emit_leaf = (const unsigned char*)emit_leaf;
  em.leaf_sid = (const int*)leaf_sid;
  return launch(em, loci, batch, frontier, gens, expand, k, max_steps,
                key_cap, threads, shared_bytes, out_scores, out_sids,
                out_exact, stream);
}

extern "C" int beam_topk_packed_launch(
    const void* flags, const void* c_ids, int n_c, const void* eptr,
    const void* enode, const void* escore, int escore_u16, const void* eleaf,
    const void* maxscore, int maxscore_u16, const void* l_ids, int n_l,
    const void* l_sid, int l_sid_u16, const void* loci, int batch,
    int frontier, int gens, int expand, int k, int max_steps, int key_cap,
    int threads, int shared_bytes, void* out_scores, void* out_sids,
    void* out_exact, void* stream) {
  PackedEmit em;
  em.flags = (const unsigned char*)flags;
  em.c_ids = (const int*)c_ids;
  em.n_c = n_c;
  em.eptr = (const int*)eptr;
  em.enode = (const int*)enode;
  em.escore = escore;
  em.escore_u16 = escore_u16;
  em.eleaf = (const unsigned char*)eleaf;
  em.maxscore = maxscore;
  em.maxscore_u16 = maxscore_u16;
  em.l_ids = (const int*)l_ids;
  em.n_l = n_l;
  em.l_sid = l_sid;
  em.l_sid_u16 = l_sid_u16;
  return launch(em, loci, batch, frontier, gens, expand, k, max_steps,
                key_cap, threads, shared_bytes, out_scores, out_sids,
                out_exact, stream);
}

extern "C" const char* beam_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
