// Batched longest-prefix trie walk on Hopper (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/trie_walk.py:81 `trie_walk`
// (CSR tables resident in VMEM) and :148 `trie_walk_streamed` (tables in
// HBM behind windowed DMA): on the card the tables sit in device memory and
// this one kernel reads them there, whatever their size.
//
// One thread per query.  Each of the L steps is one lower-bound search of
// the current node's child row (`first_child` / `edge_char`), then one read
// of `edge_child`.  A `while (lo < hi)` search returns the same index as
// the reference's fixed-round search, since the lower bound is unique.
//
// Bound: the bytes the walk must read are tiny (a pointer pair, a few
// characters and one child per consumed character), so the kernel is
// bound by the latency of its dependent loads, not by bandwidth or
// arithmetic.  What the design does about it: queries are independent
// threads, so the card overlaps the loads of many walks; the binary search
// touches O(log row) entries of a row that lies in one or two cache lines.
#include <cuda_runtime.h>

namespace {

__global__ void trie_walk_kernel(const int* __restrict__ first_child,
                                 const int* __restrict__ edge_char,
                                 const int* __restrict__ edge_child,
                                 int n_edges,
                                 const int* __restrict__ queries,
                                 const int* __restrict__ qlens,
                                 int batch, int seq_len,
                                 int* __restrict__ node_out,
                                 int* __restrict__ depth_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  int node = 0;
  int depth = 0;
  // an empty table short-circuits to the root at depth 0, as the
  // reference does
  if (n_edges > 0) {
    const int* q = queries + (long long)b * seq_len;
    const int qlen = qlens[b];
    for (int i = 0; i < seq_len && i < qlen; ++i) {
      const int c = q[i];
      if (c < 0) break;
      int lo = first_child[node];
      const int end = first_child[node + 1];
      int hi = end;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (edge_char[mid] < c) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      // a step that finds no child ends the walk for good
      if (lo >= end || edge_char[lo] != c) break;
      node = edge_child[lo];
      ++depth;
    }
  }
  node_out[b] = node;
  depth_out[b] = depth;
}

}  // namespace

extern "C" int trie_walk_launch(const void* first_child, const void* edge_char,
                                const void* edge_child, int n_edges,
                                const void* queries, const void* qlens,
                                int batch, int seq_len, void* node_out,
                                void* depth_out, void* stream) {
  if (batch > 0) {
    const int threads = 128;
    const int blocks = (batch + threads - 1) / threads;
    trie_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)first_child, (const int*)edge_char,
        (const int*)edge_child, n_edges, (const int*)queries,
        (const int*)qlens, batch, seq_len, (int*)node_out, (int*)depth_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* trie_walk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
