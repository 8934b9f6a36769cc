// Top-k selection with a payload (int32 scores[B, C], payload[B, C] ->
// top_s[B, k], top_p[B, k]) on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/topk_select.py:37 `topk_select`
// (k rounds of argmax-and-mask over a VMEM tile).  Here one thread block
// takes one row.  Round r: every thread scans its strided share of the
// row for the largest order key (select.cuh) strictly below round r-1's,
// a warp-shuffle + per-warp-slot reduction gives the block's winner, and
// thread 0 writes its score and payload.  Ties go to the lower column, as
// in `lax.top_k`; the row is never modified, so any C works and there is
// no masking sentinel.  The grid is exactly B blocks, so the TPU
// wrapper's padded rows (scores -(2^31-1), payload -1) have no
// counterpart here.  k > C is refused by the wrapper; k == C sorts the
// row.
//
// Bound: a row is read k times (from L1 after the first round) and each
// round costs two block barriers, so at the engine's shapes (C = 16 on
// the rule-free cached route, up to a few hundred for merges) the kernel
// is bound by its k dependent reductions, not by the bytes — the bytes
// of one read of the inputs and one write of the outputs are what the
// card must at least move.  What the design does about it: one block per
// row keeps rows independent across the SMs, and a round needs no shared
// candidate state beyond one 64-bit key per warp.
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

using kselect::u64;

__global__ void topk_select_kernel(const int* __restrict__ scores,
                                   const int* __restrict__ payload, int C,
                                   int k, int* __restrict__ out_s,
                                   int* __restrict__ out_p) {
  __shared__ u64 slots[32];
  const long long row = (long long)blockIdx.x * C;
  u64 prev = kselect::kFirst;
  for (int r = 0; r < k; ++r) {
    u64 best = kselect::kNone;
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const u64 key = kselect::order_key(scores[row + j], j);
      if (key < prev && key > best) best = key;
    }
    best = kselect::block_max(best, slots);
    if (threadIdx.x == 0) {
      const long long o = (long long)blockIdx.x * k + r;
      if (best == kselect::kNone) {   // unreachable while k <= C
        out_s[o] = -1;
        out_p[o] = -1;
      } else {
        const int col = kselect::key_col(best);
        out_s[o] = scores[row + col];
        out_p[o] = payload[row + col];
      }
    }
    prev = best;
  }
}

}  // namespace

extern "C" int topk_select_launch(const void* scores, const void* payload,
                                  int batch, int C, int k, int threads,
                                  void* out_s, void* out_p, void* stream) {
  if (batch > 0) {
    topk_select_kernel<<<batch, threads, 0, (cudaStream_t)stream>>>(
        (const int*)scores, (const int*)payload, C, k, (int*)out_s,
        (int*)out_p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* topk_select_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
