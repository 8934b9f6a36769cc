// Batched longest-prefix trie walk on Hopper (sm_90a), a warp a query.
//
// Replaces the Pallas kernels repro/kernels/trie_walk.py:81 `trie_walk`
// (CSR tables resident in VMEM) and :148 `trie_walk_streamed` (tables in
// HBM behind windowed DMA): on the card the tables sit in device memory and
// this one kernel reads them there, whatever their size.  With a frontier
// width F it also writes the rule-free route's loci
// (repro/core/engine/substrate.py:331-334: column 0 the node where the walk
// matched the whole query, else -1; the other columns -1; overflow 0), so
// that phase 1 of a rule-free index is this one launch.
//
// Bound: the bytes a walk must read are tiny (per consumed character a
// pointer pair, one child row's characters and children), far below a
// microsecond at 3.35 TB/s.  What bounds the kernel is the latency of the
// chain of dependent loads along the batch's longest walk.  What the design
// does about it:
// - one warp walks one query, a few warps a block, so that a batch of 64
//   spreads over 64 SMs (the wrapper's launch plan, from the batch and the
//   SM count);
// - the query sits in registers, 32 characters a chunk (lane j holds
//   character 32c + j; the next chunk is loaded while this one is walked),
//   and a step takes its character by a shuffle: no query load on the
//   chain;
// - a step is two dependent loads: the node's pointer pair (issued as soon
//   as the node is known), then the child row's characters and children
//   side by side, lane j reading edge lo + j.  Characters in a row are
//   sorted and unique, so a ballot of `char >= c` gives the row's lower
//   bound and a shuffle its character and child.  A row wider than 32 is
//   read 32 edges a round, up to the first round that holds a character
//   >= c: the same index the lower bound returns.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The wrapper's `_Trie` (kernels/trie_walk.py), field for field.
struct Trie {
  const int* first_child;
  const int* edge_char;
  const int* edge_child;
  int n_edges;
  int pad_;
};

// frontier == 0: node[b] at out[b], depth[b] at out[batch + b].
// frontier F > 0: loci[b, :F] at out[b * F], overflow[b] at
// out[batch * F + b].
__global__ void trie_walk_kernel(const Trie t,
                                 const int* __restrict__ queries,
                                 const int* __restrict__ qlens, int batch,
                                 int seq_len, int frontier,
                                 int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (b >= batch) return;   // the whole warp
  const int qlen = __ldg(qlens + b);
  const int steps = min(qlen, seq_len);
  const int* q = queries + (long long)b * seq_len;
  int node = 0;
  int depth = 0;
  // an empty table short-circuits to the root at depth 0, as the
  // reference does
  if (t.n_edges > 0 && steps > 0) {
    int chunk = lane < seq_len ? __ldg(q + lane) : -1;
    int lo = __ldg(t.first_child);
    int hi = __ldg(t.first_child + 1);
    bool walking = true;
    for (int base = 0; walking && base < steps; base += 32) {
      const int at = base + 32 + lane;
      const int next = (base + 32 < steps && at < seq_len) ? __ldg(q + at)
                                                           : -1;
      const int n = min(steps - base, 32);
      for (int j = 0; j < n; ++j) {
        const int c = __shfl_sync(kFull, chunk, j);
        // a -1 (padding) inside qlen ends the walk
        if (c < 0) {
          walking = false;
          break;
        }
        int child = -1;
        for (int e0 = lo;; e0 += 32) {
          const int e = e0 + lane;
          const bool in = e < hi;
          const int ec = in ? __ldg(t.edge_char + e) : INT_MAX;
          const int ek = in ? __ldg(t.edge_child + e) : -1;
          const unsigned ge = __ballot_sync(kFull, ec >= c);
          if (ge) {   // the lower bound is e0 + its lowest lane
            const int l = __ffs(ge) - 1;
            const int lc = __shfl_sync(kFull, ec, l);
            const int lk = __shfl_sync(kFull, ek, l);
            if (lc == c) child = lk;
            break;
          }
        }
        // a step that finds no child ends the walk for good
        if (child < 0) {
          walking = false;
          break;
        }
        node = child;
        ++depth;
        lo = __ldg(t.first_child + child);
        hi = __ldg(t.first_child + child + 1);
      }
      chunk = next;
    }
  }
  if (frontier == 0) {
    if (lane == 0) {
      out[b] = node;
      out[batch + b] = depth;
    }
    return;
  }
  // partial walks have no completions
  const int locus = depth == qlen ? node : -1;
  int* row = out + (long long)b * frontier;
  for (int f = lane; f < frontier; f += 32) row[f] = f == 0 ? locus : -1;
  if (lane == 0) out[(long long)batch * frontier + b] = 0;
}

}  // namespace

extern "C" int trie_walk_launch(const void* trie, const void* queries,
                                const void* qlens, int batch, int seq_len,
                                int frontier, int threads, int blocks,
                                void* out, void* stream) {
  if (batch > 0) {
    trie_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        *(const Trie*)trie, (const int*)queries, (const int*)qlens, batch,
        seq_len, frontier, (int*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* trie_walk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
