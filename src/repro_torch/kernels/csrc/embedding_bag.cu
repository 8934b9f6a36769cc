// EmbeddingBag on Hopper (sm_90a), over a dense [B, MB] index matrix or a
// ragged (indices, offsets) batch.
//
// Replaces the Pallas kernel repro/kernels/embedding_bag.py:41
// `embedding_bag_dense`: out[b] = sum over the bag's entries m of
// w[m] * table[idx[m]] for idx >= 0 (an index past the table reads its last
// row, as the TPU kernel's clip does), divided by max(#valid, 1) in mean
// mode.  The table and the output share one type, float32 or bfloat16 (its
// bits, widened by a shift and narrowed round-to-nearest-even); weights are
// rounded to the table's type first, as the JAX wrapper's densify does; the
// sum is taken in float32.  The ragged entry reads bag b from entries
// offsets[b] .. min(offsets[b+1], offsets[b] + max_bag) of the flat arrays,
// the function repro.kernels.ops.embedding_bag computes, with no dense copy.
//
// Bound: the bytes of the rows gathered (one row of D values per valid
// index), the indices and weights, and the output.  The design: one warp
// per bag, kWarps bags a block (512 bags fill about one wave).  The warp
// reads 32 of the bag's indices and weights in one coalesced load, counts
// the valid ones with a ballot, and hands each entry to its lanes by
// shuffle: `lpr` lanes take a row with 16-byte loads (D=64: 16 lanes per
// float32 row, 8 per bfloat16 row), so a warp gathers 32/lpr rows a step
// and kUnroll steps are loaded before their FMAs.  The lane groups' partial
// sums meet by shuffle at the end.  No shared memory, no __syncthreads.
// A misaligned table or D not a multiple of the vector width takes the
// same kernel with scalar loads.
//
// The backward of the dense entry (no TPU kernel: repro differentiates its
// DIN's (a[..., None] * e_h).sum(1) with jax.grad) is a second kernel: for
// each entry m of bag b with a valid index r, d_weights[b, m] =
// <table[r], g[b]> and d_table[r] += w[b, m] * g[b] (each divided by the
// bag's valid count in mean mode), the second by atomics into a zeroed
// [V, D] float64 buffer that the wrapper rounds once to the table's type;
// a -1 pad gets d_weights 0 and adds nothing.  float64, because a row that
// many entries share takes them all: DIN's train batch (65,536 histories
// of zipf draws) adds ~1 M products into its hottest row, and a float32
// sum of that many, in an order the atomics do not fix, strays from the
// exact one by more than the 1e-5 of its scale that chip_smoke.py holds
// the kernel to.  Bound: the rows read once, the
// atomics' read-modify-write of d_table's touched rows, the zeroing, g,
// the indices, weights and d_weights.  The design: a warp per bag, as the
// forward; lpr lanes (a power of two <= min(D, 32)) take one entry with
// scalar loads, so a warp handles 32 / lpr entries a step, and the
// group's dot product meets by shuffle.  Atomics on a shared row
// serialize in L2.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;     // bags a block
constexpr int kUnroll = 4;    // row loads a lane issues before its FMAs

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(unsigned short x) {
  return __uint_as_float((unsigned)x << 16);
}

__device__ __forceinline__ unsigned short to_bf16(float x) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) {   // NaN stays a quiet NaN
    return (unsigned short)((u >> 16) | 0x40u);
  }
  return (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// A float32 value rounded to T's precision (and widened back).
template <class T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 4) {
    return x;
  } else {
    return widen(to_bf16(x));
  }
}

// W consecutive values of a row: one 16-byte load (VEC; W = 16 / sizeof(T))
// or one scalar load (W = 1).
template <class T, bool VEC>
struct Row {
  static constexpr int W = VEC ? 16 / (int)sizeof(T) : 1;
  typedef typename std::conditional<VEC, uint4, T>::type Raw;
  __device__ static __forceinline__ Raw load(const T* p) {
    if constexpr (VEC) {
      return __ldg(reinterpret_cast<const uint4*>(p));
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
  __device__ static __forceinline__ void store(const float* f, T* p) {
    if constexpr (!VEC) {
      if constexpr (sizeof(T) == 4) {
        *p = f[0];
      } else {
        *p = to_bf16(f[0]);
      }
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = (unsigned)to_bf16(f[2 * i]) |
               ((unsigned)to_bf16(f[2 * i + 1]) << 16);
      }
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

__device__ __forceinline__ long long int_at(const void* p, int is64,
                                            long long i) {
  return is64 ? static_cast<const long long*>(p)[i]
              : static_cast<const int*>(p)[i];
}

// w_kind: 0 no weights (each 1), 1 float32, 2 bfloat16
template <class T>
__device__ __forceinline__ float weight_at(const void* w, int w_kind,
                                           long long i) {
  if (w_kind == 1) return round_to<T>(static_cast<const float*>(w)[i]);
  if (w_kind == 2) return widen(static_cast<const unsigned short*>(w)[i]);
  return 1.0f;
}

template <class T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    embedding_bag_kernel(const T* __restrict__ table, long long n_rows,
                         int dim, const void* __restrict__ idx, int idx64,
                         long long n_idx, const void* __restrict__ weights,
                         int w_kind, const void* __restrict__ offsets,
                         int off64, int n_bags, int max_bag, int lpr,
                         int mean, T* __restrict__ out) {
  typedef Row<T, VEC> R;
  constexpr int W = R::W;
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;   // the whole warp
  long long start;
  int n;
  if (offsets != nullptr) {    // ragged: clamped to the flat arrays
    long long s = int_at(offsets, off64, bag);
    long long e = int_at(offsets, off64, bag + 1);
    s = s < 0 ? 0 : (s > n_idx ? n_idx : s);
    e = e > n_idx ? n_idx : e;
    const long long len = e - s;
    start = s;
    n = len <= 0 ? 0 : (len < max_bag ? (int)len : max_bag);
  } else {
    start = bag * max_bag;
    n = max_bag;
  }
  const int vpr = dim / W;
  const int rpw = 32 / lpr;
  const int grp = lane / lpr;
  for (int v0 = 0; v0 < vpr; v0 += lpr) {
    const int v = v0 + (lane & (lpr - 1));
    float acc[W];
#pragma unroll
    for (int e = 0; e < W; ++e) acc[e] = 0.0f;
    int count = 0;
    for (int e0 = 0; e0 < n; e0 += 32) {
      const int cl = n - e0 < 32 ? n - e0 : 32;
      int r = -1;
      float w = 0.0f;
      if (lane < cl) {
        const long long i = int_at(idx, idx64, start + e0 + lane);
        r = i < 0 ? -1 : (i < n_rows ? (int)i : (int)(n_rows - 1));
        w = weight_at<T>(weights, w_kind, start + e0 + lane);
      }
      count += __popc(__ballot_sync(kFull, r >= 0));
      for (int j0 = 0; j0 < cl; j0 += rpw * kUnroll) {
        typename R::Raw raw[kUnroll];
        float wt[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * rpw + grp;
          const int rj = __shfl_sync(kFull, r, j & 31);
          const float wj = __shfl_sync(kFull, w, j & 31);
          const bool ok = j < cl && rj >= 0 && v < vpr;
          raw[u] = ok ? R::load(table + (size_t)rj * dim + (size_t)v * W)
                      : R::zero();
          wt[u] = ok ? wj : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float f[W];
          R::to_float(raw[u], f);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[e] = fmaf(wt[u], f[e], acc[e]);
        }
      }
    }
    for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], o);
    }
    if (grp == 0 && v < vpr) {
      if (mean) {
        const float denom = (float)(count > 1 ? count : 1);
#pragma unroll
        for (int e = 0; e < W; ++e) acc[e] = acc[e] / denom;
      }
      R::store(acc, out + (size_t)bag * dim + (size_t)v * W);
    }
  }
}

template <class T, bool VEC>
void launch(const void* table, long long n_rows, int dim, const void* idx,
            int idx64, long long n_idx, const void* weights, int w_kind,
            const void* offsets, int off64, int n_bags, int max_bag, int lpr,
            int mean, void* out, cudaStream_t stream) {
  embedding_bag_kernel<T, VEC>
      <<<(n_bags + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
          (const T*)table, n_rows, dim, idx, idx64, n_idx, weights, w_kind,
          offsets, off64, n_bags, max_bag, lpr, mean, (T*)out);
}

template <class T>
__global__ void __launch_bounds__(kWarps * 32)
    embedding_bag_backward_kernel(const T* __restrict__ table,
                                  long long n_rows, int dim,
                                  const int* __restrict__ idx,
                                  const void* __restrict__ weights,
                                  int w_kind, const float* __restrict__ grad,
                                  int n_bags, int max_bag, int lpr, int mean,
                                  double* __restrict__ d_table,
                                  float* __restrict__ d_weights) {
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;   // the whole warp
  const long long start = bag * max_bag;
  const int n = max_bag;
  int count = 0;               // the bag's valid entries (mean divides)
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int e = e0 + lane;
    count += __popc(__ballot_sync(kFull, e < n && idx[start + e] >= 0));
  }
  const float denom = mean ? (float)(count > 1 ? count : 1) : 1.0f;
  const int grp = lane / lpr;
  const int sub = lane & (lpr - 1);
  const int rpw = 32 / lpr;
  const float* g = grad + (size_t)bag * dim;
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int cl = n - e0 < 32 ? n - e0 : 32;
    int r = -1;
    float w = 0.0f;
    if (lane < cl) {
      const long long i = idx[start + e0 + lane];
      r = i < 0 ? -1 : (i < n_rows ? (int)i : (int)(n_rows - 1));
      w = weight_at<T>(weights, w_kind, start + e0 + lane);
    }
    for (int j0 = 0; j0 < cl; j0 += rpw) {
      const int j = j0 + grp;  // < 32: rpw divides 32
      const int rj = __shfl_sync(kFull, r, j);
      const float wj = __shfl_sync(kFull, w, j);
      float dot = 0.0f;
      if (j < cl && rj >= 0) {
        const T* row = table + (size_t)rj * dim;
        double* drow =
            d_table == nullptr ? nullptr : d_table + (size_t)rj * dim;
        const float s = wj / denom;
        for (int d = sub; d < dim; d += lpr) {
          const float gd = g[d];
          if (d_weights != nullptr) dot = fmaf(widen(row[d]), gd, dot);
          if (drow != nullptr) atomicAdd(drow + d, (double)(s * gd));
        }
      }
      for (int o = 1; o < lpr; o <<= 1) {
        dot += __shfl_xor_sync(kFull, dot, o);
      }
      if (d_weights != nullptr && sub == 0 && j < cl) {
        d_weights[start + e0 + j] = rj >= 0 ? dot / denom : 0.0f;
      }
    }
  }
}

template <class T>
void launch_backward(const void* table, long long n_rows, int dim,
                     const void* idx, const void* weights, int w_kind,
                     const void* grad, int n_bags, int max_bag, int lpr,
                     int mean, void* d_table, void* d_weights,
                     cudaStream_t stream) {
  embedding_bag_backward_kernel<T>
      <<<(n_bags + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
          (const T*)table, n_rows, dim, (const int*)idx, weights, w_kind,
          (const float*)grad, n_bags, max_bag, lpr, mean, (double*)d_table,
          (float*)d_weights);
}

}  // namespace

// The dense entry's backward: grad float32 [n_bags, dim], idx int32
// [n_bags, max_bag]; d_table float64 [n_rows, dim] zeroed by the caller,
// d_weights float32 [n_bags, max_bag]; either may be null (not wanted).
extern "C" int embedding_bag_backward_launch(
    const void* table, long long n_rows, int dim, int bf16, int lpr,
    const void* idx, const void* weights, int w_kind, const void* grad,
    int n_bags, int max_bag, int mean, void* d_table, void* d_weights,
    void* stream) {
  if (n_bags > 0 && max_bag > 0) {
    auto run = bf16 ? launch_backward<unsigned short> : launch_backward<float>;
    run(table, n_rows, dim, idx, weights, w_kind, grad, n_bags, max_bag, lpr,
        mean, d_table, d_weights, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// offsets null: the dense entry (bag b is idx[b*max_bag .. +max_bag)).
extern "C" int embedding_bag_launch(const void* table, long long n_rows,
                                    int dim, int bf16, int vec, int lpr,
                                    const void* idx, int idx64,
                                    long long n_idx, const void* weights,
                                    int w_kind, const void* offsets,
                                    int off64, int n_bags, int max_bag,
                                    int mean, void* out, void* stream) {
  if (n_bags > 0) {
    auto run = bf16 ? (vec ? launch<unsigned short, true>
                           : launch<unsigned short, false>)
                    : (vec ? launch<float, true> : launch<float, false>);
    run(table, n_rows, dim, idx, idx64, n_idx, weights, w_kind, offsets,
        off64, n_bags, max_bag, lpr, mean, out, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
