// Top-k selection with a payload (int32 scores[B, C], payload[B, C] ->
// top_s[B, k], top_p[B, k]) on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/topk_select.py:37 `topk_select`
// (k rounds of argmax-and-mask over a VMEM tile).  Ties go to the lower
// column, as in `lax.top_k`; the row is never modified and may be in any
// order, so the same kernel serves the rule-free cached route (sorted
// rows of C = K) and unsorted merges.  k > C is refused by the wrapper;
// k == C sorts the row.
//
//   - Warp path, C <= 1024 (select.cuh `warp_select`): one warp per row,
//     R = 1, 2, 4, ... 32 order keys a lane in registers (column
//     i*32 + lane in key[i], a template parameter so the arrays stay in
//     registers), read once with coalesced loads, all R of a lane in
//     flight at once.  A round is R masked compares reduced as a tree and
//     two 32-bit warp reductions (redux.sync): no barrier, no shared
//     memory.  Several rows a block, one per warp; the wrapper
//     picks the warps so that a batch spreads over the SMs.
//   - Block path, C > 1024: one block per row; a round scans the row's
//     strided share from L1 and reduces through select.cuh `block_max`
//     (two barriers a round).
//
// Bound: the bytes of one read of the inputs and one write of the
// outputs are what the card must at least move (13 KB at the rule-free
// route's B=64, C=16: ~4 ns at 3.35 TB/s), far below a launch; what the
// kernel costs is its k dependent rounds and, end to end, the host's
// launch.  What the design does about it: a round is a few dozen
// instructions of one warp, and the wrapper's launch is one ctypes call
// (see topk_select.py).
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

using kselect::u64;

template <int R>
__global__ void __launch_bounds__(256)
    topk_select_warp(const int* __restrict__ scores,
                     const int* __restrict__ payload, int batch, int C,
                     int k, int* __restrict__ out_s,
                     int* __restrict__ out_p) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= batch) return;   // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long row = (long long)b * C;
  // every load unconditional (past the row, the last column again), so
  // the R loads of a lane are all in flight at once
  int sc[R];
  int pay[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = min(i * 32 + lane, C - 1);
    sc[i] = __ldg(scores + row + j);
    pay[i] = __ldg(payload + row + j);
  }
  u64 key[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = i * 32 + lane;
    key[i] = j < C ? kselect::order_key(sc[i], j) : kselect::kNone;
  }
  kselect::warp_select<R>(key, pay, k, out_s + (long long)b * k,
                          out_p + (long long)b * k);
}

__global__ void topk_select_block(const int* __restrict__ scores,
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

template <int R>
void launch_warp(const int* scores, const int* payload, int batch, int C,
                 int k, int threads, int* out_s, int* out_p,
                 cudaStream_t stream) {
  const int warps = threads / 32;
  topk_select_warp<R><<<(batch + warps - 1) / warps, threads, 0, stream>>>(
      scores, payload, batch, C, k, out_s, out_p);
}

}  // namespace

// out: int32[2, batch, k] (scores, then payloads).  regs: keys a lane on
// the warp path (1, 2, 4, 8, 16 or 32), 0 for the block path; threads:
// the block's threads (a warp multiple).
extern "C" int topk_select_launch(const void* scores, const void* payload,
                                  int batch, int C, int k, int regs,
                                  int threads, void* out, void* stream) {
  const int* s = (const int*)scores;
  const int* p = (const int*)payload;
  int* out_s = (int*)out;
  int* out_p = out_s + (long long)batch * k;
  cudaStream_t st = (cudaStream_t)stream;
  if (batch > 0) {
    switch (regs) {
      case 0:
        topk_select_block<<<batch, threads, 0, st>>>(s, p, C, k, out_s,
                                                     out_p);
        break;
      case 1: launch_warp<1>(s, p, batch, C, k, threads, out_s, out_p, st); break;
      case 2: launch_warp<2>(s, p, batch, C, k, threads, out_s, out_p, st); break;
      case 4: launch_warp<4>(s, p, batch, C, k, threads, out_s, out_p, st); break;
      case 8: launch_warp<8>(s, p, batch, C, k, threads, out_s, out_p, st); break;
      case 16: launch_warp<16>(s, p, batch, C, k, threads, out_s, out_p, st); break;
      case 32: launch_warp<32>(s, p, batch, C, k, threads, out_s, out_p, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* topk_select_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
