// Cached phase 2: per-node top-K gather + merge over a locus antichain
// (loci int32[B, F] -> scores[B, k], sids[B, k]) on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/locus_merge.py:53
// `locus_topk_merge`, and the wrapper around it that reads the packed
// layout's quantized cache (repro/kernels/ops.py:285
// `cached_topk_merge_packed`).  One thread block per query:
//   1. each locus slot finds its cache row — the node itself in the dense
//      layout (int32 topk_score/topk_sid [N, K]); in the packed layout its
//      chain representative's rank, a lower bound over c_ids;
//   2. the F*K candidates are staged in shared memory, loci-major then
//      K-minor, -1 where the slot is empty.  Packed rows are decoded at the
//      read: a u16 entry e means score base[row] + e - 1 and sid e - 1, 0 is
//      an empty slot; i32 entries are raw.  Only the rows gathered are
//      decoded — never the whole [C, K] plane;
//   3. k rounds of block-wide argmax (select.cuh): the largest (score,
//      lower index) key below the previous round's.  Equal to a flat
//      first-max over the union; when k >= F*K the union comes out fully
//      sorted and the rest is padded with -1.
//
// Bound: the bytes a query must read are its F loci, F cache rows of K
// (score, sid) pairs and, packed, a rank search of c_ids per locus; the
// k dependent block reductions over F*K staged candidates dominate at the
// engine's shapes (F = 32, K = 16).  What the design does about it: every
// gathered row is read once from device memory into shared memory, and
// the selection never writes the candidates back.
#include <cuda_runtime.h>

#include "select.cuh"
#include "tables.cuh"

namespace {

using kselect::u64;
using tables::load_tier;

struct Cache {
  int packed;
  int K;
  // dense: int32 [N, K]; packed: u16 or int32 [C, K] per the two tiers
  const void* score;
  const void* sid;
  int score_u16;
  int sid_u16;
  const int* base;   // packed: per-row score base
  const int* c_ids;  // packed: stored node ids, sorted
  int n_c;
};

// Cache row of a locus (>= 0): the node (dense) or the clipped rank of
// its chain representative in c_ids (packed).
__device__ __forceinline__ int cache_row(const Cache& c, int node) {
  return c.packed ? tables::rep_rank(c.c_ids, c.n_c, node) : node;
}

__global__ void locus_merge_kernel(Cache c, const int* __restrict__ loci,
                                   int F, int k, int* __restrict__ out_s,
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
    int i = -1;
    if (r >= 0) {
      const long long e = (long long)r * K + j % K;
      const int es = load_tier(c.score, e, c.score_u16);
      const int ei = load_tier(c.sid, e, c.sid_u16);
      if (c.packed && c.score_u16) {
        s = es == 0 ? -1 : c.base[r] + es - 1;
      } else {
        s = es;
      }
      if (c.packed && c.sid_u16) {
        i = ei == 0 ? -1 : ei - 1;
      } else {
        i = ei;
      }
    }
    cs[j] = s;
    ci[j] = i;
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

}  // namespace

extern "C" int locus_merge_launch(int packed, int K, const void* score,
                                  const void* sid, int score_u16,
                                  int sid_u16, const void* base,
                                  const void* c_ids, int n_c,
                                  const void* loci, int batch, int F, int k,
                                  int threads, int shared_bytes, void* out_s,
                                  void* out_p, void* stream) {
  Cache c;
  c.packed = packed;
  c.K = K;
  c.score = score;
  c.sid = sid;
  c.score_u16 = score_u16;
  c.sid_u16 = sid_u16;
  c.base = (const int*)base;
  c.c_ids = (const int*)c_ids;
  c.n_c = n_c;
  if (batch > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        locus_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
    locus_merge_kernel<<<batch, threads, shared_bytes,
                         (cudaStream_t)stream>>>(c, (const int*)loci, F, k,
                                                 (int*)out_s, (int*)out_p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* locus_merge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
