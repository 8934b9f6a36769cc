// EmbeddingBag over a dense [B, MB] index matrix on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/embedding_bag.py:41
// `embedding_bag_dense`: out[b] = sum over m of w[b, m] * table[idx[b, m]]
// for idx >= 0 (an index past the table reads its last row, as the TPU
// kernel's clip does), divided by max(#valid, 1) in mean mode.  The table,
// the weights and the output share one type, float32 or bfloat16 (its
// bits, widened by a shift and narrowed round-to-nearest-even); the sum is
// taken in float32 in bag order.
//
// One block per bag; thread d owns columns d, d + blockDim, ...  The TPU
// kernel keeps its table tile in VMEM; here the table stays in device
// memory and each bag's rows are read once, a warp reading consecutive
// columns of one row (coalesced), with the bag's indices and weights
// staged in shared memory.
//
// Bound: the bytes of the rows gathered (one row of D values per valid
// index), the indices and weights, and the output.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(unsigned short x) {
  return __uint_as_float((unsigned)x << 16);
}

__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }
__device__ __forceinline__ void narrow(float x, unsigned short* out) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) {   // NaN stays a quiet NaN
    *out = (unsigned short)((u >> 16) | 0x40u);
    return;
  }
  *out = (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

template <class T>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     long long n_rows, int dim,
                                     const int* __restrict__ idx,
                                     const T* __restrict__ weights,
                                     int max_bag, int mean,
                                     T* __restrict__ out) {
  extern __shared__ int smem[];
  int* rows = smem;                          // max_bag
  float* w = (float*)(rows + max_bag);       // max_bag
  const long long b = blockIdx.x;
  for (int m = threadIdx.x; m < max_bag; m += blockDim.x) {
    const int r = idx[b * max_bag + m];
    rows[m] = r < 0 ? -1 : (r < n_rows ? r : (int)(n_rows - 1));
    w[m] = widen(weights[b * max_bag + m]);
  }
  __syncthreads();
  int count = 0;
  for (int m = 0; m < max_bag; ++m) count += rows[m] >= 0;
  const float denom = (float)(count > 1 ? count : 1);
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    float acc = 0.0f;
    for (int m = 0; m < max_bag; ++m) {
      const int r = rows[m];
      if (r >= 0) acc = fmaf(w[m], widen(table[(long long)r * dim + d]), acc);
    }
    narrow(mean ? acc / denom : acc, &out[b * dim + d]);
  }
}

template <class T>
int launch(const void* table, long long n_rows, int dim, const void* idx,
           const void* weights, int batch, int max_bag, int mean,
           int threads, void* out, void* stream) {
  const int shared = 8 * max_bag;
  if (shared > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        embedding_bag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared);
    if (err != cudaSuccess) return (int)err;
  }
  if (batch > 0) {
    embedding_bag_kernel<T><<<batch, threads, shared,
                              (cudaStream_t)stream>>>(
        (const T*)table, n_rows, dim, (const int*)idx, (const T*)weights,
        max_bag, mean, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int embedding_bag_launch(const void* table, long long n_rows,
                                    int dim, const void* idx,
                                    const void* weights, int batch,
                                    int max_bag, int mean, int bf16,
                                    int threads, void* out, void* stream) {
  return bf16 ? launch<unsigned short>(table, n_rows, dim, idx, weights,
                                       batch, max_bag, mean, threads, out,
                                       stream)
              : launch<float>(table, n_rows, dim, idx, weights, batch,
                              max_bag, mean, threads, out, stream);
}

extern "C" const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
