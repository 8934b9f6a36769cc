// Fused candidate scoring + top-k on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/candidate_topk.py:51
// `candidate_topk`: dot-score one query [D] against candidates [C, D]
// (float32 or bfloat16, each widened to float32; the sum in float32) and
// keep the k best, score-descending, ties to the lower id (as lax.top_k).
// Slots past C hold (-3.0e38, -1), the Pallas kernel's init.
//
// Bound: the bytes of reading the candidates once, C*D*sizeof(T); the
// 2*C*D flops are far below the float32 rate.  The design streams them:
//   1. candidate_score_select: two blocks per SM, each over one contiguous
//      slice of rows.  A row is read by `lpr` lanes with 16-byte loads
//      (D=64 float32: 16 lanes, two rows per warp load; bfloat16: 8 lanes,
//      four rows), kUnroll loads per lane, issued a round ahead of their
//      FMAs; the query sits in registers and the dot product is finished
//      by shuffles.  No score goes to device memory and nothing is staged
//      for the dot product.  Each block keeps the k-th best key so far as a
//      threshold, the 64-bit key (~orderable(score) << 32) | id, whose
//      ascending order is the answer's order: a row that does not beat it
//      is dropped with one compare; a row that does goes into a shared
//      buffer, which is sorted (bitonic; strides under a warp by shuffle)
//      down to its best k, raising the threshold, only when the next
//      rounds could overflow it.  A misaligned slice, or D not a multiple
//      of the vector width, takes the same kernel with scalar loads.
//   2. candidate_merge: one block streams the blocks' sorted k-key lists
//      through the same threshold buffer, position-major (the best key of
//      every list first), takes its first threshold as soon as it holds k
//      keys, and stops at the first round in which no key beats it: every
//      list is sorted, so nothing after it can.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

typedef unsigned long long u64;
constexpr u64 kEmpty = ~0ull;
constexpr float kNegFill = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;        // scoring block: 256 threads
constexpr int kUnroll = 8;       // row slots a lane loads before its FMAs
constexpr int kQRegs = 4;        // query vectors a lane keeps in registers
constexpr int kMinBlocks = 2;    // scoring blocks resident per SM
constexpr int kMergeThreads = 1024;

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

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(unsigned short x) {
  return __uint_as_float((unsigned)x << 16);
}

// W consecutive values of a row: one 16-byte load (VEC; W = 16 / sizeof(T))
// or one scalar load (W = 1), widened to float32.
template <class T, bool VEC>
struct Load {
  static constexpr int W = VEC ? 16 / (int)sizeof(T) : 1;
  typedef typename std::conditional<VEC, uint4, T>::type Raw;
  __device__ static __forceinline__ Raw load(const T* p) {
    if constexpr (VEC) {
      return __ldcs(reinterpret_cast<const uint4*>(p));   // read once
    } else {
      return __ldg(p);
    }
  }
  __device__ static __forceinline__ Raw zero() {
    if constexpr (VEC) {
      return make_uint4(0u, 0u, 0u, 0u);
    } else {
      return T(0);
    }
  }
  __device__ static __forceinline__ void to_float(const Raw& r, float* f) {
    if constexpr (!VEC) {
      f[0] = widen(r);
    } else if constexpr (sizeof(T) == 4) {
      f[0] = __uint_as_float(r.x);
      f[1] = __uint_as_float(r.y);
      f[2] = __uint_as_float(r.z);
      f[3] = __uint_as_float(r.w);
    } else {   // bfloat16 pairs, the lower address in the low half
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
};

__device__ __forceinline__ float query_at(const void* q, int q_bf16, int d) {
  return q_bf16 ? widen(static_cast<const unsigned short*>(q)[d])
                : static_cast<const float*>(q)[d];
}

// Bitonic stages of sizes size_lo..size_hi whose strides are below a warp
// (16, 8, ..., 1), on keys a[e] held one per lane: the partner e ^ stride
// sits in the same warp, so lanes swap by shuffle with no barrier.  Ends
// with a[] written back and synchronised.
__device__ void warp_stages(u64* a, int n, int size_lo, int size_hi) {
  for (int e0 = 0; e0 < n; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    u64 x = e < n ? a[e] : kEmpty;
    for (int size = size_lo; size <= size_hi; size <<= 1) {
      const bool up = (e & size) == 0;
      for (int s = (size >> 1) < 16 ? (size >> 1) : 16; s > 0; s >>= 1) {
        const u64 y = __shfl_xor_sync(kFull, x, s);
        const bool keep_min = ((e & s) == 0) == up;
        x = keep_min ? (x < y ? x : y) : (x < y ? y : x);
      }
    }
    if (e < n) a[e] = x;
  }
  __syncthreads();
}

// Ascending bitonic sort of a[0, n), n a power of two, by a block whose
// size is a multiple of 32.  Called by every thread of the block after a[]
// is written and synchronised; returns synchronised.  Strides of a warp or
// more go through shared memory, one barrier a stage; the rest by shuffle.
__device__ void bitonic_sort(u64* a, int n) {
  warp_stages(a, n, 2, n < 32 ? n : 32);
  for (int size = 64; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= 32; stride >>= 1) {
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
    warp_stages(a, n, size, size);
  }
}

// The block's threshold buffer: `buf` holds `*count` keys, the best k of
// them (after a flush) first; a key enters only if it is below `*thr`, the
// k-th best key kept so far (kEmpty until k keys were seen).
struct Buffer {
  u64* buf;
  int* count;
  u64* thr;

  // Sort the buffer, keep its best k and raise the threshold.  Every thread
  // calls it with the count it read; returns synchronised.
  __device__ void flush(int n_keys, int k) const {
    int n = 1;
    while (n < n_keys) n <<= 1;
    for (int j = n_keys + threadIdx.x; j < n; j += blockDim.x) buf[j] = kEmpty;
    __syncthreads();
    bitonic_sort(buf, n);
    if (threadIdx.x == 0) {
      if (n_keys >= k) *thr = buf[k - 1];
      *count = n_keys < k ? n_keys : k;
    }
    __syncthreads();
  }

  // Warp-aggregated append of the lanes that `take` their key.
  __device__ __forceinline__ void insert(bool take, u64 key) const {
    const unsigned m = __ballot_sync(kFull, take);
    if (m == 0) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(m) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(count, __popc(m));
    base = __shfl_sync(kFull, base, leader);
    if (take) buf[base + __popc(m & ((1u << lane) - 1u))] = key;
  }

  // Whether the buffer must be flushed before `round` more keys may come;
  // `eager`: also as soon as it first holds k keys (no threshold yet).
  static __device__ __forceinline__ bool full(int n_keys, u64 t, int k,
                                              int cap, int round,
                                              bool eager) {
    return cap - n_keys < round || (eager && t == kEmpty && n_keys >= k);
  }
};

// The vector v of kUnroll row slots (rows row0, row0 + rpw, ...), or
// zeros past the slice.
template <class T, bool VEC>
__device__ __forceinline__ void load_rows(const T* __restrict__ cands,
                                          int dim, int vpr, int row0, int r1,
                                          int rpw, int v,
                                          typename Load<T, VEC>::Raw* raw) {
  typedef Load<T, VEC> L;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int row = row0 + u * rpw;
    raw[u] = (row < r1 && v < vpr)
                 ? L::load(cands + (size_t)row * dim + (size_t)v * L::W)
                 : L::zero();
  }
}

// Lane-partial dot products of the slots with the query vector qv.
template <class T, bool VEC>
__device__ __forceinline__ void fma_rows(const typename Load<T, VEC>::Raw* raw,
                                         const float* qv, float* acc) {
  typedef Load<T, VEC> L;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    float f[L::W];
    L::to_float(raw[u], f);
#pragma unroll
    for (int e = 0; e < L::W; ++e) acc[u] = fmaf(f[e], qv[e], acc[u]);
  }
}

template <class T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    candidate_score_select(const void* __restrict__ query, int q_bf16,
                           const T* __restrict__ cands, int n_cands, int dim,
                           int rows_per_block, int lpr, int k, int cap,
                           u64* __restrict__ out_keys) {
  typedef Load<T, VEC> L;
  constexpr int W = L::W;
  extern __shared__ u64 smem[];
  __shared__ int s_count;
  __shared__ u64 s_thr;
  const Buffer B{smem, &s_count, &s_thr};
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int vpr = dim / W;
  const int rpw = 32 / lpr;
  const int lr = lane & (lpr - 1);
  const int nq = (vpr + lpr - 1) / lpr;
  const int round_rows = kWarps * kUnroll * rpw;
  const long long first = (long long)blockIdx.x * rows_per_block;
  const int r0 = first < n_cands ? (int)first : n_cands;
  const int r1 = first + rows_per_block < n_cands
                     ? (int)(first + rows_per_block) : n_cands;

  float q[kQRegs][W];
#pragma unroll
  for (int t = 0; t < kQRegs; ++t) {
    const int v = lr + t * lpr;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      q[t][e] = (t < nq && v < vpr) ? query_at(query, q_bf16, v * W + e)
                                    : 0.0f;
    }
  }
  if (threadIdx.x == 0) {
    s_count = 0;
    s_thr = kEmpty;
  }
  __syncthreads();

  typedef typename L::Raw Raw;
  const int slot0 = (warp * kUnroll) * rpw + lane / lpr;
  Raw next[kUnroll];   // the first vectors of the next round, in flight
  load_rows<T, VEC>(cands, dim, vpr, r0 + slot0, r1, rpw, lr, next);
  int rb = r0;
  while (rb < r1) {
    const int count = s_count;
    const u64 thr = s_thr;
    __syncthreads();
    if (Buffer::full(count, thr, k, cap, round_rows, false)) {
      B.flush(count, k);
      continue;
    }
    // until the buffer could overflow: the first threshold comes from a
    // full buffer, so that it already drops most rows
    int rounds = (cap - count) / round_rows;
    for (; rounds > 0 && rb < r1; --rounds, rb += round_rows) {
      const int row0 = rb + slot0;
      float acc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[u] = 0.0f;
      Raw cur[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = next[u];
      load_rows<T, VEC>(cands, dim, vpr, row0 + round_rows, r1, rpw, lr,
                        next);
      fma_rows<T, VEC>(cur, q[0], acc);
#pragma unroll
      for (int t = 1; t < kQRegs; ++t) {
        if (t < nq) {
          load_rows<T, VEC>(cands, dim, vpr, row0, r1, rpw, lr + t * lpr,
                            cur);
          fma_rows<T, VEC>(cur, q[t], acc);
        }
      }
      for (int t = kQRegs; t < nq; ++t) {   // wide rows: query from memory
        const int v = lr + t * lpr;
        float qv[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          qv[e] = v < vpr ? query_at(query, q_bf16, v * W + e) : 0.0f;
        }
        load_rows<T, VEC>(cands, dim, vpr, row0, r1, rpw, v, cur);
        fma_rows<T, VEC>(cur, qv, acc);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float s = acc[u];
        for (int o = lpr >> 1; o > 0; o >>= 1) {
          s += __shfl_xor_sync(kFull, s, o);
        }
        const int row = row0 + u * rpw;
        const u64 key = make_key(s, row);
        B.insert(lr == 0 && row < r1 && key < thr, key);
      }
    }
    __syncthreads();
  }
  const int count = s_count;
  B.flush(count, k);
  const int kept = s_count;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out_keys[(size_t)blockIdx.x * k + j] = j < kept ? smem[j] : kEmpty;
  }
}

__global__ void __launch_bounds__(kMergeThreads)
    candidate_merge(const u64* __restrict__ in_keys, int n_lists, int k,
                    int cap, float* __restrict__ out_scores,
                    int* __restrict__ out_ids) {
  extern __shared__ u64 smem[];
  __shared__ int s_count;
  __shared__ u64 s_thr;
  const Buffer B{smem, &s_count, &s_thr};
  const int round = blockDim.x;
  const long long total = (long long)n_lists * k;
  if (threadIdx.x == 0) {
    s_count = 0;
    s_thr = kEmpty;
  }
  __syncthreads();
  long long j0 = 0;
  while (j0 < total) {
    const int count = s_count;
    const u64 thr = s_thr;
    __syncthreads();
    if (Buffer::full(count, thr, k, cap, round, true)) {
      B.flush(count, k);
      continue;
    }
    const long long j = j0 + threadIdx.x;
    u64 key = kEmpty;
    if (j < total) {   // position-major: list j % n_lists, at j / n_lists
      const long long pos = j / n_lists;
      key = in_keys[(j - pos * n_lists) * k + pos];
    }
    B.insert(key < thr, key);
    j0 += round;
    __syncthreads();
    // a round that covered every list and kept nothing ends the stream
    if (s_count == count && round >= n_lists) break;
  }
  const int count = s_count;
  B.flush(count, k);
  const int kept = s_count;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if (j < kept) {
      const u64 key = smem[j];
      out_scores[j] = from_orderable(~(unsigned)(key >> 32));
      out_ids[j] = (int)(unsigned)(key & 0xffffffffu);
    } else {
      out_scores[j] = kNegFill;
      out_ids[j] = -1;
    }
  }
}

// Raise a kernel's dynamic shared-memory limit once per larger size.
template <class K>
cudaError_t allow_shared(K kernel, int bytes, int* set_so_far) {
  if (bytes <= 48 * 1024 || bytes <= *set_so_far) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *set_so_far = bytes;
  return err;
}

template <class T, bool VEC>
cudaError_t score(const void* query, int q_bf16, const void* cands,
                  int n_cands, int dim, int rows_per_block, int lpr, int k,
                  int cap, int n_blocks, void* keys, cudaStream_t stream) {
  static int set_so_far = 0;
  const int shared = 8 * cap;
  const cudaError_t err = allow_shared(candidate_score_select<T, VEC>,
                                       shared, &set_so_far);
  if (err != cudaSuccess) return err;
  candidate_score_select<T, VEC><<<n_blocks, kWarps * 32, shared, stream>>>(
      query, q_bf16, (const T*)cands, n_cands, dim, rows_per_block, lpr, k,
      cap, (u64*)keys);
  return cudaGetLastError();
}

}  // namespace

// Both passes on `stream`: the scoring blocks write n_blocks sorted k-key
// lists to `keys`, the merge decodes the best k into (scores, ids).
extern "C" int candidate_topk_launch(const void* query, int q_bf16,
                                     const void* cands, int c_bf16, int vec,
                                     int n_cands, int dim, int rows_per_block,
                                     int lpr, int k, int cap, int n_blocks,
                                     int merge_cap, void* keys,
                                     void* out_scores, void* out_ids,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (c_bf16) {
    err = vec ? score<unsigned short, true>(query, q_bf16, cands, n_cands,
                                            dim, rows_per_block, lpr, k, cap,
                                            n_blocks, keys, s)
              : score<unsigned short, false>(query, q_bf16, cands, n_cands,
                                             dim, rows_per_block, lpr, k, cap,
                                             n_blocks, keys, s);
  } else {
    err = vec ? score<float, true>(query, q_bf16, cands, n_cands, dim,
                                   rows_per_block, lpr, k, cap, n_blocks,
                                   keys, s)
              : score<float, false>(query, q_bf16, cands, n_cands, dim,
                                    rows_per_block, lpr, k, cap, n_blocks,
                                    keys, s);
  }
  if (err != cudaSuccess) return (int)err;
  static int merge_set = 0;
  const int shared = 8 * merge_cap;
  err = allow_shared(candidate_merge, shared, &merge_set);
  if (err != cudaSuccess) return (int)err;
  candidate_merge<<<1, kMergeThreads, shared, s>>>(
      (const u64*)keys, n_blocks, k, merge_cap, (float*)out_scores,
      (int*)out_ids);
  return (int)cudaGetLastError();
}

extern "C" const char* candidate_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
