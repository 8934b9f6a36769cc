// Fused candidate scoring + top-k on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/candidate_topk.py:51
// `candidate_topk`: dot-score one float32 query [D] against candidates
// [C, D] and keep the k best, score-descending, ties to the lower id (as
// lax.top_k).  The TPU kernel carries a running top-k across its
// sequential grid; blocks here run in parallel and in no order, so the
// work is two passes:
//   1. candidate_score_topk: one block per slice of `block_c` candidates
//      stages row tiles through shared memory with coalesced loads (rows
//      padded to D+1 floats, so the per-row dot products read shared
//      memory without bank conflicts), takes each row's dot product in
//      float32 (fmaf, in d order), and keeps the slice's top-k: a bitonic
//      sort of one 64-bit key per row, (~orderable(score) << 32) | id, so
//      an ascending sort is score-descending with ties to the lower id;
//   2. candidate_merge: each block sorts the k-key lists of `group`
//      slices and keeps the first k, until one list is left; the last
//      launch decodes it to (scores, ids).  Slots past C hold
//      (-3.0e38, -1), the Pallas kernel's init.
//
// Bound: the bytes of reading the candidates once, C*D*4 (2*C*D flops are
// far below the float32 rate).  What the design does about it: every
// candidate byte is read once, coalesced, and the scores never leave
// shared memory; only k keys per slice reach device memory.
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr u64 kEmpty = ~0ull;
constexpr float kNegFill = -3.0e38f;

// An unsigned 32-bit image of a float whose order is the float order.
__device__ __forceinline__ unsigned orderable(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// score-descending, id-ascending under an ascending sort
__device__ __forceinline__ u64 make_key(float score, int id) {
  return ((u64)(~orderable(score)) << 32) | (unsigned)id;
}

// Ascending bitonic sort of a[0, n), n a power of two.  Called by every
// thread of the block after a[] is written and synchronised; returns
// synchronised.
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

__global__ void candidate_score_topk(const float* __restrict__ query,
                                     const float* __restrict__ cands,
                                     int n_cands, int dim, int block_c,
                                     int tile_rows, int sort_n, int k,
                                     u64* __restrict__ out_keys) {
  extern __shared__ u64 smem[];
  u64* keys = smem;                               // sort_n
  float* q = (float*)(keys + sort_n);             // dim
  float* tile = q + dim;                          // tile_rows * (dim + 1)
  const long long base = (long long)blockIdx.x * block_c;
  const long long left = (long long)n_cands - base;
  const int n_here = left < block_c ? (int)left : block_c;
  const int stride = dim + 1;
  for (int d = threadIdx.x; d < dim; d += blockDim.x) q[d] = query[d];
  for (int j = threadIdx.x; j < sort_n; j += blockDim.x) keys[j] = kEmpty;
  __syncthreads();
  for (int r0 = 0; r0 < n_here; r0 += tile_rows) {
    const int rows = n_here - r0 < tile_rows ? n_here - r0 : tile_rows;
    const float* src = cands + (base + r0) * dim;
    for (int e = threadIdx.x; e < rows * dim; e += blockDim.x) {
      tile[(e / dim) * stride + e % dim] = src[e];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* row = tile + r * stride;
      float acc = 0.0f;
      for (int d = 0; d < dim; ++d) acc = fmaf(row[d], q[d], acc);
      keys[r0 + r] = make_key(acc, (int)(base + r0 + r));
    }
    __syncthreads();
  }
  bitonic_sort(keys, sort_n);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out_keys[(long long)blockIdx.x * k + j] = j < sort_n ? keys[j] : kEmpty;
  }
}

__global__ void candidate_merge(const u64* __restrict__ in_keys, int n_lists,
                                int k, int group, int sort_n,
                                u64* __restrict__ out_keys,
                                float* __restrict__ out_scores,
                                int* __restrict__ out_ids, int final_pass) {
  extern __shared__ u64 smem[];
  u64* keys = smem;
  const long long l0 = (long long)blockIdx.x * group;
  const long long nl = n_lists - l0 < group ? n_lists - l0 : group;
  const long long n_in = nl * k;
  for (int j = threadIdx.x; j < sort_n; j += blockDim.x) {
    keys[j] = j < n_in ? in_keys[l0 * k + j] : kEmpty;
  }
  __syncthreads();
  bitonic_sort(keys, sort_n);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const u64 key = j < sort_n ? keys[j] : kEmpty;
    if (!final_pass) {
      out_keys[(long long)blockIdx.x * k + j] = key;
    } else if (key == kEmpty) {
      out_scores[j] = kNegFill;
      out_ids[j] = -1;
    } else {
      out_scores[j] = from_orderable(~(unsigned)(key >> 32));
      out_ids[j] = (int)(unsigned)(key & 0xffffffffu);
    }
  }
}

}  // namespace

extern "C" int candidate_score_launch(const void* query, const void* cands,
                                      int n_cands, int dim, int block_c,
                                      int tile_rows, int sort_n, int k,
                                      int n_blocks, int threads,
                                      int shared_bytes, void* out_keys,
                                      void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      candidate_score_topk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared_bytes);
  if (err != cudaSuccess) return (int)err;
  candidate_score_topk<<<n_blocks, threads, shared_bytes,
                         (cudaStream_t)stream>>>(
      (const float*)query, (const float*)cands, n_cands, dim, block_c,
      tile_rows, sort_n, k, (u64*)out_keys);
  return (int)cudaGetLastError();
}

extern "C" int candidate_merge_launch(const void* in_keys, int n_lists,
                                      int k, int group, int sort_n,
                                      int n_blocks, int threads,
                                      int shared_bytes, void* out_keys,
                                      void* out_scores, void* out_ids,
                                      int final_pass, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      candidate_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared_bytes);
  if (err != cudaSuccess) return (int)err;
  candidate_merge<<<n_blocks, threads, shared_bytes, (cudaStream_t)stream>>>(
      (const u64*)in_keys, n_lists, k, group, sort_n, (u64*)out_keys,
      (float*)out_scores, (int*)out_ids, final_pass);
  return (int)cudaGetLastError();
}

extern "C" const char* candidate_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
