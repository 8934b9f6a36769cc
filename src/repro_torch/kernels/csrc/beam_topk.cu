// Fused beam phase 2 (generator-pool priority search) on Hopper (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/beam_topk.py:413
// `beam_topk_batch` (emission tables resident in VMEM) and :463
// `beam_topk_batch_streamed` (tables in HBM behind windowed DMA): on the
// card the emission tables sit in device memory and this one kernel reads
// them there, whatever their size.
//
// One thread block per query.  The pool (node `gn`, emission cursor `gc`,
// admissible bound `gb`; width W), the result heap (k) and `dropped_max`
// live in shared memory for the whole search.  Each step pops the best P
// generators, folds leaf emissions into the heap, turns internal emissions
// into new generators, advances the popped ones, and keeps the best W of
// the merged pool.  Each of the three selections is a block-wide bitonic
// sort on the 64-bit key (INT_MAX - bound) << 32 | column: descending
// bound, ties to the lower column — `lax.top_k`'s order, so incumbents win
// ties over new entries exactly as in the reference.  The block loops
// while the reference's condition holds (best bound >= 0 and above the
// k-th score, fewer than max_steps steps), then sets
// exact = (dropped_max <= k-th score) & finished.
//
// Bound: the bytes a query must read are the emissions it pops (node,
// score, leaf flag) and the pointer pairs of the generators it re-arms —
// a few kilobytes — so the kernel is bound by its block-wide sorts and
// synchronisation, not by bandwidth.  What the design does about it: all
// search state stays in shared memory, the pool's emission reads run in
// parallel across the block, and each sort is sized to the next power of
// two of its own width (W + P for the pool, k + P for the heap).
#include <cuda_runtime.h>

namespace {

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

// Admissible bound of a generator: the score of its current emission, or
// -1 when the node is dead or the cursor ran off its emission list.
__device__ __forceinline__ int emit_bound(const int* __restrict__ emit_ptr,
                                          const int* __restrict__ emit_score,
                                          int node, int cursor) {
  if (node < 0) return -1;
  const int e = emit_ptr[node] + cursor;
  return e < emit_ptr[node + 1] ? emit_score[e] : -1;
}

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

__global__ void beam_topk_kernel(const int* __restrict__ emit_ptr,
                                 const int* __restrict__ emit_node,
                                 const int* __restrict__ emit_score,
                                 const unsigned char* __restrict__ emit_leaf,
                                 const int* __restrict__ leaf_sid,
                                 const int* __restrict__ loci, int F, int W,
                                 int P, int k, int max_steps, int key_cap,
                                 int* __restrict__ out_scores,
                                 int* __restrict__ out_sids,
                                 unsigned char* __restrict__ out_exact) {
  extern __shared__ u64 smem64[];
  u64* keys = smem64;                       // key_cap sort keys
  int* gn = (int*)(keys + key_cap);         // W generator nodes
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
  __shared__ int s_slot;
  __shared__ int s_dropped;

  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int n = j < F ? loci[(long long)b * F + j] : -1;
    const int bound = emit_bound(emit_ptr, emit_score, n, 0);
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

  const int n_pop = pow2_at_least(W);
  const int n_heap = pow2_at_least(k + P);
  const int n_pool = pow2_at_least(W + P);
  for (int step = 0; step < max_steps; ++step) {
    const int best = block_max(gb, W, &s_slot);
    if (!(best >= 0 && ls[k - 1] < best)) break;   // uniform

    // pop the best P generators
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
        const int e = emit_ptr[gn[col]] + gc[col];
        const int en = emit_node[e];
        if (emit_leaf[e]) {
          leaf_s = emit_score[e];
          leaf_i = leaf_sid[en];
        } else {
          new_b = emit_bound(emit_ptr, emit_score, en, 0);
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
      const int bound = emit_bound(emit_ptr, emit_score, gn[j], pool_c[j]);
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
  }

  const int best = block_max(gb, W, &s_slot);
  const int kth = ls[k - 1];
  const bool finished = !(best >= 0 && kth < best);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out_scores[(long long)b * k + j] = ls[j];
    out_sids[(long long)b * k + j] = li[j];
  }
  if (threadIdx.x == 0) {
    out_exact[b] = (s_dropped <= kth && finished) ? 1 : 0;
  }
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
  if (batch > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
    beam_topk_kernel<<<batch, threads, shared_bytes, (cudaStream_t)stream>>>(
        (const int*)emit_ptr, (const int*)emit_node, (const int*)emit_score,
        (const unsigned char*)emit_leaf, (const int*)leaf_sid,
        (const int*)loci, frontier, gens, expand, k, max_steps, key_cap,
        (int*)out_scores, (int*)out_sids, (unsigned char*)out_exact);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* beam_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
