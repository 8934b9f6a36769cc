// Fused synonym-aware locus DP (phase 1 for tt/et/ht and every packed
// index, at edit budget 0, 1 or 2) on Hopper (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/locus_dp.py:732
// `locus_dp_walk` (tables resident in VMEM), :773 `locus_dp_walk_streamed`
// (dictionary tables in HBM behind windowed DMA), :832
// `locus_dp_walk_packed` and :871 `locus_dp_walk_packed_streamed` (the same
// sweep over the compressed layout): on the card every table sits in
// device memory and this one kernel reads it there, whatever its size.
//
// The sweep is written once, templated on its table accessor — the seam
// of the Pallas kernels' `_ResidentTables` / `_PackedResidentTables`:
//   - DenseTables reads the uniform int32 CSRs and planes;
//   - PackedTables reads the compressed layout: a unary node's child is
//     v+1 when the next node's u8 label matches (PACK_DICT_UNARY /
//     PACK_SYN_UNARY), branching rows go through a rank lookup into the
//     sorted b_ids / sb_ids, `tout` comes from c_tout at the chain
//     representative (a synonym node is its own chain: v+1), and teleport
//     and link rows come through t_ids and la_ids.  u8 planes widen to int
//     at the load; an empty side table matches nothing (its size is
//     checked, never its pointer read).
// The merges, the overflow counts and the antichain step are therefore
// one code for both layouts — the counts decide `exact` and the retry.
//
// Bounded-edit mode (edit budget E > 0): a frontier entry is the state
// node*(E+1)+d, d the edits spent so far (E = 0 is the identity).  The
// literal step gains substitute (every other dict child at d+1) and insert
// (stay put at d+1, refused at synonym nodes) parts, and every completed
// row gains E delete rounds (every dict child at d+1, no character
// consumed) after its teleports.  Teleports and rule steps carry d
// through.  A node's dict children come from its child window: the
// first_child row (dense) or the unary label / the rank-looked-up b_* row
// (packed), read once per frontier entry before the candidates are formed.
//
// One thread block per query.  The (L+1, F) frontier buffer lives in
// dynamic shared memory for the whole sweep, and so do the candidate,
// merged and window rows of one merge when they fit; past the 227 KB a
// block may have, the wrapper gives each block a slice of a device-memory
// workspace for them (and, past that, for the frontier too).  At each
// position i up to the query's last character:
//   - literal step: row i+1 gets the dict and synonym children of row i
//     labelled q[i] (one lower-bound search per live state), and at E > 0
//     the insert and substitute states;
//   - rule steps: thread 0 descends the rule trie from position i; every
//     full-lhs match (at most `rule_matches` per position, counted per
//     term) looks up (anchor, rule) in the link store for each dict node
//     of row i and merges the targets into the row where the lhs ends;
//   - write-back: row i+1 is complete, so its teleport targets are merged
//     in, then the E delete rounds.
// Every merge keeps `dedup_pad`'s result exactly: ids ascending, the first
// F kept, overflow += max(uniques - F, 0).  The final row drops synonym
// loci, is deduplicated again, and loses every id covered by another's
// preorder interval [id, tout).  The states are decoded to nodes first.
//
// Bound: the bytes a query must read are a pointer pair, a few characters
// and a child per live state and position, plus teleport and link rows
// (~1e-5 ms at the card's 3.35 TB/s for a batch of 64), so the kernel is
// bound by its chain of block-wide barriers and the latency of its
// dependent table loads.  The earlier design sorted every merge's padded
// candidate row (the substitute and delete segments F x branch_width wide,
// branch_width the root's fanout, ~90 % empty) by a block-wide bitonic
// sort and compacted it by a Hillis-Steele scan, one barrier per stage,
// at all L = 32 positions: at F = 32, ~70 barrier stages a position at
// E = 0 (the literal merge of 128 slots: 28 sort stages + 7 scan steps,
// then the teleport merge) and ~160 at E >= 1 (1,024-slot sorts).  This
// design:
//   - ends the sweep at the query's last character (rows past it hold no
//     state, and their merges add no overflow);
//   - forms candidates only for live states, the substitute and delete
//     children laid out by an exclusive prefix over the live states'
//     child windows (not F x branch_width), and compacts the live ones by
//     warp ballot and one shared counter;
//   - skips a merge with no live candidate (the row stands, no overflow);
//   - sorts only the next power of two of the live count, and merges the
//     target row (sorted and unique already) with it by merge path, then
//     deduplicates by ballot and popcount — in warp 0 alone, synchronised
//     by __syncwarp, up to 256 sorted slots, else by the block;
//   - finalizes in warp 0: the row's nodes are already sorted, and the
//     antichain test is a running max of tout (was O(F^2) a query).
// Block barriers a position at F = 32: 4 at E = 0 (candidates, publish;
// for the literal and the teleport merge), 10 at E = 1 (+ the windows of
// the literal step and of one delete round, and its merge), 14 at E = 2;
// a merge's sort stages in between are warp-synchronous.  The block has
// 4F threads (at most 512): one per slot of the widest common merge.
#include <cuda_runtime.h>

#include "tables.cuh"

namespace {

using tables::lower_bound;

constexpr int kIntMax = 2147483647;

// The rule trie (dense in both layouts).
struct RuleTables {
  const int* first_child;
  const int* edge_char;
  const int* edge_child;
  int n_edges;
  const int* term_plane;
  int term_width;
};

struct Shape {
  int frontier;
  int seq_len;
  int rule_matches;
  int max_lhs_len;
  int max_terms;
  int cand_cap;
  int edit_budget;    // E
  int buf_in_ws;      // the frontier rows live in the workspace
  int cand_in_ws;     // the candidate / scan rows live in the workspace
  long long ws_stride;   // workspace ints of one block
};

// A frontier state's node and edit count (E1 = E + 1); -1 -> (-1, 0).
__device__ __forceinline__ int state_node(int st, int e1) {
  return st < 0 ? -1 : st / e1;
}
__device__ __forceinline__ int state_edits(int st, int e1) {
  return st < 0 ? 0 : st % e1;
}
__device__ __forceinline__ int encode(int node, int d, int e1) {
  return node < 0 ? -1 : node * e1 + d;
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Child of `node` labelled `c` in a CSR trie, or -1.
__device__ __forceinline__ int csr_child(const int* __restrict__ ptr,
                                         const int* __restrict__ chars,
                                         const int* __restrict__ children,
                                         int n_chars, int node, int c) {
  if (node < 0 || c < 0 || n_chars == 0) return -1;
  int lo = ptr[node];
  const int end = ptr[node + 1];
  int hi = end;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (chars[mid] < c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < end && chars[lo] == c) ? children[lo] : -1;
}

// Target of rule `rid` in the rule-sorted link rows [lo, end), or -1.
__device__ __forceinline__ int link_in_row(const int* __restrict__ rule,
                                           const int* __restrict__ target,
                                           int lo, int end, int rid) {
  const int pos = lower_bound(rule, lo, end, rid);
  return (pos < end && rule[pos] == rid) ? target[pos] : -1;
}

// Reads of the uniform int32 layout.
struct DenseTables {
  const int* first_child;
  const int* edge_char;
  const int* edge_child;
  int n_edges;
  const int* s_first_child;
  const int* s_edge_char;
  const int* s_edge_child;
  int n_syn_edges;
  const unsigned char* syn_mask;
  const int* tout_arr;
  const int* tele_plane;
  int tele_width;
  int teleports;
  const int* link_ptr;
  const int* link_rule;
  const int* link_target;
  int n_links;

  __device__ bool has_syn() const { return n_syn_edges > 0; }
  __device__ int dict_child(int node, int c) const {
    return csr_child(first_child, edge_char, edge_child, n_edges, node, c);
  }
  __device__ int syn_child(int node, int c) const {
    return csr_child(s_first_child, s_edge_char, s_edge_child, n_syn_edges,
                     node, c);
  }
  // teleport target `col` of node (>= 0), or -1
  __device__ int tele(int node, int col) const {
    return tele_plane[(long long)node * tele_width + col];
  }
  __device__ bool is_syn(int node) const { return syn_mask[node] != 0; }
  __device__ int tout(int node) const { return tout_arr[node]; }
  // child window of node (>= 0): its first_child row [lo, lo + cnt)
  __device__ void window(int node, int* lo, int* cnt) const {
    if (n_edges == 0) {
      *lo = 0;
      *cnt = 0;
      return;
    }
    *lo = first_child[node];
    *cnt = first_child[node + 1] - *lo;
  }
  // column w < cnt of a window: (character, child)
  __device__ void window_at(int lo, int w, int* ch, int* child) const {
    *ch = edge_char[lo + w];
    *child = edge_child[lo + w];
  }
  __device__ int link(int anchor, int rid) const {
    if (anchor < 0 || n_links == 0) return -1;
    return link_in_row(link_rule, link_target, link_ptr[anchor],
                       link_ptr[anchor + 1], rid);
  }
};

// Exact position of `node` in a sorted id table of n entries, or -1.
__device__ __forceinline__ int rank_exact(const int* __restrict__ ids, int n,
                                          int node) {
  if (n == 0) return -1;
  const int pos = lower_bound(ids, 0, n, node);
  return (pos < n && ids[pos] == node) ? pos : -1;
}

// Reads of the compressed layout (trie_build.pack_compressed); node ids
// are the dense layout's, so every read returns the dense value.
struct PackedTables {
  const unsigned char* labels;
  const unsigned char* flags;
  int n_nodes;
  const int* c_ids;
  int n_c;
  const int* c_tout;
  const int* b_ids;
  int n_b;
  const int* b_ptr;
  const unsigned char* b_char;
  const int* b_child;
  const int* sb_ids;
  int n_sb;
  const int* sb_ptr;
  const unsigned char* sb_char;
  const int* sb_child;
  int n_sb_edges;
  const int* t_ids;
  int n_t;
  const int* t_plane;
  int tele_width;
  int teleports;
  const int* la_ids;
  int n_la;
  const int* la_ptr;
  const int* link_rule;
  const int* link_target;
  int n_links;

  // synonym nodes exist iff teleports do or a non-unary syn row was kept
  __device__ bool has_syn() const { return n_t > 0 || n_sb_edges > 0; }

  __device__ int child(const int* ids, int n_ids, const int* ptr,
                       const unsigned char* chars, const int* children,
                       int unary_bit, int node, int c) const {
    if (node < 0 || c < 0) return -1;
    const int r = rank_exact(ids, n_ids, node);
    if (r >= 0) {   // a branching row
      int lo = ptr[r];
      const int end = ptr[r + 1];
      int hi = end;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((int)chars[mid] < c) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      return (lo < end && (int)chars[lo] == c) ? children[lo] : -1;
    }
    // a unary node: its one child is v+1, labelled by v+1's incoming byte
    if ((flags[node] & unary_bit) && node + 1 < n_nodes &&
        (int)labels[node + 1] == c) {
      return node + 1;
    }
    return -1;
  }
  __device__ int dict_child(int node, int c) const {
    return child(b_ids, n_b, b_ptr, b_char, b_child, tables::kDictUnary,
                 node, c);
  }
  __device__ int syn_child(int node, int c) const {
    return child(sb_ids, n_sb, sb_ptr, sb_char, sb_child, tables::kSynUnary,
                 node, c);
  }
  __device__ int tele(int node, int col) const {
    const int r = rank_exact(t_ids, n_t, node);
    return r < 0 ? -1 : t_plane[(long long)r * tele_width + col];
  }
  __device__ bool is_syn(int node) const {
    return (flags[node] & tables::kIsSyn) != 0;
  }
  // child window of node (>= 0): a branching node's b_* row [lo, lo+cnt),
  // or a unary node's one (label, v+1) pair, marked by lo = -(node + 2)
  __device__ void window(int node, int* lo, int* cnt) const {
    const int r = rank_exact(b_ids, n_b, node);
    if (r >= 0 && b_ptr[r + 1] > b_ptr[r]) {
      *lo = b_ptr[r];
      *cnt = b_ptr[r + 1] - b_ptr[r];
    } else if ((flags[node] & tables::kDictUnary) && node + 1 < n_nodes) {
      *lo = -(node + 2);
      *cnt = 1;
    } else {
      *lo = 0;
      *cnt = 0;
    }
  }
  __device__ void window_at(int lo, int w, int* ch, int* child) const {
    if (lo < 0) {
      const int node = -lo - 2;
      *ch = (int)labels[node + 1];
      *child = node + 1;
    } else {
      *ch = (int)b_char[lo + w];
      *child = b_child[lo + w];
    }
  }
  // a dict node reads its chain representative: the first stored id at
  // or after it (the clipped lower bound over c_ids)
  __device__ int tout(int node) const {
    if (is_syn(node)) return node + 1;
    return c_tout[tables::rep_rank(c_ids, n_c, node)];
  }
  __device__ int link(int anchor, int rid) const {
    if (anchor < 0 || n_links == 0) return -1;
    const int r = rank_exact(la_ids, n_la, anchor);
    if (r < 0) return -1;
    return link_in_row(link_rule, link_target, la_ptr[r], la_ptr[r + 1],
                       rid);
  }
};

constexpr unsigned kFull = 0xffffffffu;
// The largest block (its launch bound): 512 threads of up to 128 registers
// fit an SM's 65,536.
constexpr int kMaxThreads = 512;
// Merges whose sorted candidates fit this many slots run in warp 0 alone,
// synchronised by __syncwarp: no block barrier between the candidates'
// barrier and the one that publishes the row.
constexpr int kWarpMergeMax = 256;

// Slots of the block's small scratch (`sc`, after the query characters,
// the rule matches and the row lengths).
constexpr int kCount = 0;    // two candidate counters, used by turns
constexpr int kTotal = 2;    // uniques of the last merge
constexpr int kWin = 3;      // child windows of the last row_windows
constexpr int kMatch = 4;    // rule matches of this position
constexpr int kWarpTotals = 5;   // 32 per-warp counts (block compaction)
constexpr int kScratch = kWarpTotals + 32;

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// First index in [lo, hi) of a sorted int32 table with a[idx] > x.
__device__ __forceinline__ int upper_bound(const int* a, int lo, int hi,
                                           int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The threads that run one merge: warp 0 alone, or the whole block.
struct WarpGroup {
  static constexpr bool kBlock = false;
  __device__ static int rank() { return threadIdx.x & 31; }
  __device__ static int size() { return 32; }
  __device__ static void sync() { __syncwarp(); }
};
struct BlockGroup {
  static constexpr bool kBlock = true;
  __device__ static int rank() { return threadIdx.x; }
  __device__ static int size() { return blockDim.x; }
  __device__ static void sync() { __syncthreads(); }
};

// Ascending bitonic sort of a[0, n), n a power of two, by the group;
// returns synchronised.
template <class G>
__device__ void bitonic_sort(int* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = G::rank(); i < (n >> 1); i += G::size()) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const int x = a[lo];
        const int y = a[hi];
        if ((x > y) == up) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      G::sync();
    }
  }
}

// out[0, na + nb) = the sorted a[0, na) and b[0, nb) merged, a first on
// ties: each element lands at its own index plus its rank in the other
// list (merge path by binary search).  Returns synchronised.
template <class G>
__device__ void merge_sorted(const int* a, int na, const int* b, int nb,
                             int* out) {
  for (int i = G::rank(); i < na + nb; i += G::size()) {
    if (i < na) {
      const int x = a[i];
      out[i + lower_bound(b, 0, nb, x)] = x;
    } else {
      const int y = b[i - na];
      out[i - na + upper_bound(a, 0, na, y)] = y;
    }
  }
  G::sync();
}

// The distinct values of the sorted m[0, n), ascending, into
// dst[0, min(u, F)) by ballot and popcount; returns u to the group.
template <class G>
__device__ int compact_unique(const int* m, int n, int* dst, int F,
                              int* warp_totals) {
  int base = 0;
  for (int c = 0; c < n; c += G::size()) {
    const int i = c + G::rank();
    const bool keep = i < n && (i == 0 || m[i] != m[i - 1]);
    const unsigned bal = __ballot_sync(kFull, keep);
    int off = __popc(bal & lanes_below());
    int chunk = __popc(bal);
    if (G::kBlock) {   // add the counts of the warps before this one
      const int w = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) warp_totals[w] = chunk;
      __syncthreads();
      chunk = 0;
      for (int x = 0; x < (int)(blockDim.x >> 5); ++x) {
        const int v = warp_totals[x];
        if (x < w) off += v;
        chunk += v;
      }
      __syncthreads();   // the totals are rewritten by the next chunk
    }
    if (keep && base + off < F) dst[base + off] = m[i];
    base += chunk;
  }
  return base;
}

// dst (sorted, unique, its first na live) U the sorted cand[0, nb), into
// dst; returns the uniques.  cand is padded to a power of two in place.
template <class G>
__device__ int merge_group(int* dst, int na, int* cand, int nb, int* merged,
                           int F, int* warp_totals) {
  const int n = pow2_at_least(nb);
  for (int j = nb + G::rank(); j < n; j += G::size()) cand[j] = kIntMax;
  G::sync();
  bitonic_sort<G>(cand, n);
  merge_sorted<G>(dst, na, cand, nb, merged);
  return compact_unique<G>(merged, na + nb, dst, F, warp_totals);
}

// One reference merge: row dst (sorted, unique, *len live, -1 after) U
// the candidates gen(0..slots) (-1 for none), deduplicated back into dst;
// returns its overflow max(uniques - F, 0) to every thread.  The live
// candidates are compacted first (a warp ballot and one shared counter:
// their order is free, since they are sorted next), so only they are
// sorted, and dst, sorted already, is merged with them by merge path.
// A merge with no live candidate leaves dst as it is (uniques <= F).
// `turn` alternates the two counters: thread 0 clears the one the next
// merge uses while this one's count is read.
template <class Gen>
__device__ int merge_into(int* dst, int* len, int F, int slots, Gen gen,
                          int* cand, int* merged, int* sc, int& turn) {
  int* counter = sc + kCount + turn;
  if (threadIdx.x == 0) sc[kCount + (turn ^ 1)] = 0;
  turn ^= 1;
  for (int j0 = 0; j0 < slots; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const int v = j < slots ? gen(j) : -1;
    const unsigned bal = __ballot_sync(kFull, v >= 0);
    if (bal) {
      int base = 0;
      if ((threadIdx.x & 31) == 0) base = atomicAdd(counter, __popc(bal));
      base = __shfl_sync(kFull, base, 0);
      if (v >= 0) cand[base + __popc(bal & lanes_below())] = v;
    }
  }
  __syncthreads();
  const int nb = *counter;
  if (nb == 0) return 0;   // uniform
  if (pow2_at_least(nb) <= kWarpMergeMax) {
    if (threadIdx.x < 32) {
      const int total = merge_group<WarpGroup>(dst, *len, cand, nb, merged,
                                               F, nullptr);
      if (threadIdx.x == 0) {
        *len = min(total, F);
        sc[kTotal] = total;
      }
    }
  } else {
    const int total = merge_group<BlockGroup>(dst, *len, cand, nb, merged, F,
                                              sc + kWarpTotals);
    if (threadIdx.x == 0) {
      *len = min(total, F);
      sc[kTotal] = total;
    }
  }
  __syncthreads();
  const int total = sc[kTotal];
  return total > F ? total - F : 0;
}

// The child windows of row[0, n) into (wlo[f], wcnt[f]) — cnt 0 for a
// state with no edit left (d == E) — and their exclusive prefix wpre
// (warp 0, by shuffles); returns the windows' total to every thread.
template <class T>
__device__ int row_windows(const T& t, const int* row, int n, int E,
                           int* wlo, int* wcnt, int* wpre, int* sc) {
  for (int f = threadIdx.x; f < n; f += blockDim.x) {
    const int node = state_node(row[f], E + 1);
    int l = 0;
    int c = 0;
    if (node >= 0 && state_edits(row[f], E + 1) < E) t.window(node, &l, &c);
    wlo[f] = l;
    wcnt[f] = c;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int c0 = 0; c0 < n; c0 += 32) {
      const int i = c0 + lane;
      const int own = i < n ? wcnt[i] : 0;
      int v = own;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += y;
      }
      if (i < n) wpre[i] = base + v - own;
      base += __shfl_sync(kFull, v, 31);
    }
    if (lane == 0) sc[kWin] = base;
  }
  __syncthreads();
  return sc[kWin];
}

// The window of slot s in [0, total): the last f with wpre[f] <= s (its
// count is > 0), and the column w within it.
__device__ __forceinline__ int window_of(const int* wpre, int n, int s,
                                         int* w) {
  const int f = upper_bound(wpre, 0, n, s) - 1;
  *w = s - wpre[f];
  return f;
}

// row (its *len live states) += its teleport targets (each at its
// source's edit count); returns the overflow of the merge.
template <class T>
__device__ int tele_expand(const T& t, int* row, int* len, int F, int e1,
                           int* cand, int* merged, int* sc, int& turn) {
  const int tw = t.tele_width;
  const int slots = *len * tw;
  if (slots == 0) return 0;
  return merge_into(
      row, len, F, slots,
      [&](int j) {
        const int st = row[j / tw];
        return encode(t.tele(state_node(st, e1), j % tw),
                      state_edits(st, e1), e1);
      },
      cand, merged, sc, turn);
}

// One delete round over row: every dict child of a state with d < E, at
// d+1; returns the overflow of the merge.
template <class T>
__device__ int delete_round(const T& t, int* row, int* len, int F, int E,
                            int* cand, int* merged, int* win, int* sc,
                            int& turn) {
  const int n = *len;
  if (n == 0) return 0;
  int* wlo = win;
  int* wcnt = wlo + F;
  int* wpre = wcnt + F;
  const int slots = row_windows(t, row, n, E, wlo, wcnt, wpre, sc);
  if (slots == 0) return 0;
  return merge_into(
      row, len, F, slots,
      [&](int s) {
        int w;
        const int f = window_of(wpre, n, s, &w);
        int ch, child;
        t.window_at(wlo[f], w, &ch, &child);
        return encode(child, state_edits(row[f], E + 1) + 1, E + 1);
      },
      cand, merged, sc, turn);
}

// The fixpoint of a completed row: its teleports, then E delete rounds.
template <class T>
__device__ int expand_row(const T& t, int* row, int* len, int F, int E,
                          int* cand, int* merged, int* win, int* sc,
                          int& turn) {
  int overflow = 0;
  if (t.teleports > 0) {
    overflow += tele_expand(t, row, len, F, E + 1, cand, merged, sc, turn);
  }
  for (int r = 0; r < E; ++r) {
    overflow += delete_round(t, row, len, F, E, cand, merged, win, sc, turn);
  }
  return overflow;
}

template <class T>
__global__ void __launch_bounds__(kMaxThreads)
    locus_dp_kernel(T t, RuleTables r, Shape s,
                    const int* __restrict__ queries,
                    const int* __restrict__ qlens,
                    int* __restrict__ workspace, int* __restrict__ loci_out,
                    int* __restrict__ overflow_out) {
  extern __shared__ int smem[];
  const int F = s.frontier;
  const int L = s.seq_len;
  const int M = s.rule_matches;
  const int C = s.cand_cap;
  const int E = s.edit_budget;
  const int E1 = E + 1;
  const int b = blockIdx.x;
  int* sm = smem;
  int* ws = workspace == nullptr ? nullptr
                                 : workspace + (long long)b * s.ws_stride;
  int* buf;                            // (L + 1) * F frontier rows
  if (s.buf_in_ws) {
    buf = ws;
    ws += (L + 1) * F;
  } else {
    buf = sm;
    sm += (L + 1) * F;
  }
  int* cand;                           // C compacted candidates
  if (s.cand_in_ws) {
    cand = ws;
  } else {
    cand = sm;
    sm += 3 * C;
  }
  int* merged = cand + C;              // C: a row merged with them
  int* win = merged + C;               // 3F: child windows of one row
  int* q = sm;                         // L query characters
  int* m_rule = q + L;                 // M rule matches of one position
  int* m_end = m_rule + (M > 0 ? M : 1);
  int* rowlen = m_end + (M > 0 ? M : 1);   // L + 1 live counts
  int* sc = rowlen + L + 1;            // kScratch ints

  const int* qrow = queries + (long long)b * L;
  for (int i = threadIdx.x; i < (L + 1) * F; i += blockDim.x) buf[i] = -1;
  for (int i = threadIdx.x; i < L; i += blockDim.x) q[i] = qrow[i];
  for (int i = threadIdx.x; i <= L; i += blockDim.x) rowlen[i] = 0;
  for (int i = threadIdx.x; i < kScratch; i += blockDim.x) sc[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    buf[0] = 0;   // the root at d=0 encodes to 0
    rowlen[0] = 1;
  }
  __syncthreads();
  // the sweep ends at the query's last character: past it a row has no
  // state and no merge adds overflow
  int n_pos = 0;
  for (int i = 0; i < L; ++i) {
    if (q[i] >= 0) n_pos = i + 1;
  }
  int turn = 0;

  // the same in every thread: merges return it to all
  int overflow = expand_row(t, buf, rowlen, F, E, cand, merged, win, sc,
                            turn);

  const int has_syn = t.has_syn() ? 1 : 0;
  for (int i = 0; i < n_pos; ++i) {
    const int* row = buf + i * F;
    int* nxt = buf + (i + 1) * F;
    const int c = q[i];
    const int n = rowlen[i];

    // literal step: row i+1 U dict children U synonym children, and at
    // E > 0 U insert states U substitute states (slots of n, n, n and
    // one per child-window column)
    const bool edits = E > 0 && c >= 0;
    int* wlo = win;
    int* wcnt = wlo + F;
    int* wpre = wcnt + F;
    const int n_sub =
        edits && n > 0 ? row_windows(t, row, n, E, wlo, wcnt, wpre, sc) : 0;
    const int off_ins = (1 + has_syn) * n;
    const int off_sub = off_ins + (edits ? n : 0);
    const int slots = off_sub + n_sub;
    if (slots > 0) {
      overflow += merge_into(
          nxt, rowlen + i + 1, F, slots,
          [&](int j) {
            if (j < off_ins) {
              const int f = j < n ? j : j - n;
              const int st = row[f];
              const int node = state_node(st, E1);
              const int ch = j < n ? t.dict_child(node, c)
                                   : t.syn_child(node, c);
              return encode(ch, state_edits(st, E1), E1);
            }
            if (j < off_sub) {
              // insert: the query has an extra character; mid-variant
              // (synonym) nodes absorb none
              const int st = row[j - off_ins];
              const int node = state_node(st, E1);
              const int d = state_edits(st, E1);
              return node >= 0 && d < E && !t.is_syn(node)
                         ? node * E1 + d + 1
                         : -1;
            }
            // substitute: every dict child not labelled c (the matching
            // one rides the literal part); no window at d == E
            int w;
            const int f = window_of(wpre, n, j - off_sub, &w);
            int ch, child;
            t.window_at(wlo[f], w, &ch, &child);
            return ch != c ? encode(child, state_edits(row[f], E1) + 1, E1)
                           : -1;
          },
          cand, merged, sc, turn);
    }

    // rule steps through the link store
    if (M > 0) {
      if (threadIdx.x == 0) {
        int node = 0;
        int cnt = 0;
        for (int j = 0; j < s.max_lhs_len; ++j) {
          const int ch = i + j < L ? q[i + j] : -1;
          node = csr_child(r.first_child, r.edge_char, r.edge_child,
                           r.n_edges, node, ch);
          if (node < 0) break;
          for (int j2 = 0; j2 < s.max_terms; ++j2) {
            const int rid = r.term_plane[(long long)node * r.term_width + j2];
            if (rid >= 0 && cnt < M) {
              m_rule[cnt] = rid;
              m_end[cnt] = i + j + 1;
              ++cnt;
            }
          }
        }
        sc[kMatch] = cnt;
      }
      __syncthreads();
      const int nm = n > 0 ? sc[kMatch] : 0;
      for (int m = 0; m < nm; ++m) {
        const int rid = m_rule[m];
        const int end = m_end[m];
        overflow += merge_into(
            buf + end * F, rowlen + end, F, n,
            [&](int j) {
              const int a = state_node(row[j], E1);
              return a >= 0 && !t.is_syn(a)
                         ? encode(t.link(a, rid), state_edits(row[j], E1),
                                  E1)
                         : -1;
            },
            cand, merged, sc, turn);
      }
      __syncthreads();   // sc[kMatch] and m_* are rewritten next position
    }

    // write-back: row i+1 is complete (rule ends are > i), expand it
    overflow += expand_row(t, nxt, rowlen + i + 1, F, E, cand, merged, win,
                           sc, turn);
  }

  // finalize the row at the query's own length (warp 0).  The row is
  // sorted by state, so its nodes (state / (E+1)) are non-decreasing:
  // dropping synonym nodes and the repeats of a node keeps it sorted, and
  // a locus is covered by another's preorder interval [id, tout) iff the
  // running max of tout over the smaller loci exceeds it.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int ql = qlens[b];
    ql = ql < 0 ? 0 : (ql > L ? L : ql);
    const int* row = buf + ql * F;
    const int n = rowlen[ql];
    int* fin = cand;
    int nf = 0;
    for (int c0 = 0; c0 < n; c0 += 32) {
      const int i = c0 + lane;
      int v = -1;
      bool keep = false;
      if (i < n) {
        v = state_node(row[i], E1);
        keep = !t.is_syn(v) && (i == 0 || state_node(row[i - 1], E1) != v);
      }
      const unsigned bal = __ballot_sync(kFull, keep);
      if (keep) fin[nf + __popc(bal & lanes_below())] = v;
      nf += __popc(bal);
    }
    __syncwarp();
    int carry = -1;   // the largest tout of the loci before this chunk
    for (int c0 = 0; c0 < F; c0 += 32) {
      const int j = c0 + lane;
      const int x = j < nf ? fin[j] : -1;
      int incl = x >= 0 ? t.tout(x) : -1;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl = max(incl, y);
      }
      int excl = __shfl_up_sync(kFull, incl, 1);
      excl = max(lane == 0 ? -1 : excl, carry);
      if (j < F) loci_out[(long long)b * F + j] = x >= 0 && excl > x ? -1 : x;
      carry = max(carry, __shfl_sync(kFull, incl, 31));
    }
    if (lane == 0) overflow_out[b] = overflow;
  }
}

template <class T>
int launch(const T& t, const RuleTables& r, const Shape& s, int threads,
           int shared_bytes, const void* queries, const void* qlens,
           int batch, void* workspace, void* loci_out, void* overflow_out,
           void* stream) {
  if (batch > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        locus_dp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
    locus_dp_kernel<T><<<batch, threads, shared_bytes,
                         (cudaStream_t)stream>>>(
        t, r, s, (const int*)queries, (const int*)qlens, (int*)workspace,
        (int*)loci_out, (int*)overflow_out);
  }
  return (int)cudaGetLastError();
}

RuleTables rule_tables(const void* r_first_child, const void* r_edge_char,
                       const void* r_edge_child, int n_r_edges,
                       const void* r_term_plane, int term_width) {
  RuleTables r;
  r.first_child = (const int*)r_first_child;
  r.edge_char = (const int*)r_edge_char;
  r.edge_child = (const int*)r_edge_child;
  r.n_edges = n_r_edges;
  r.term_plane = (const int*)r_term_plane;
  r.term_width = term_width;
  return r;
}

Shape shape(int frontier, int seq_len, int rule_matches, int max_lhs_len,
            int max_terms, int cand_cap, int edit_budget,
            int buf_in_ws, int cand_in_ws, long long ws_stride) {
  Shape s;
  s.frontier = frontier;
  s.seq_len = seq_len;
  s.rule_matches = rule_matches;
  s.max_lhs_len = max_lhs_len;
  s.max_terms = max_terms;
  s.cand_cap = cand_cap;
  s.edit_budget = edit_budget;
  s.buf_in_ws = buf_in_ws;
  s.cand_in_ws = cand_in_ws;
  s.ws_stride = ws_stride;
  return s;
}

}  // namespace

extern "C" int locus_dp_launch(
    const void* first_child, const void* edge_char, const void* edge_child,
    int n_edges, const void* s_first_child, const void* s_edge_char,
    const void* s_edge_child, int n_syn_edges, const void* syn_mask,
    const void* tout, const void* tele_plane, int tele_width, int teleports,
    const void* link_ptr, const void* link_rule, const void* link_target,
    int n_links, const void* r_first_child, const void* r_edge_char,
    const void* r_edge_child, int n_r_edges, const void* r_term_plane,
    int term_width, int frontier, int seq_len, int rule_matches,
    int max_lhs_len, int max_terms, int cand_cap, int edit_budget,
    int buf_in_ws, int cand_in_ws, long long ws_stride,
    int threads, int shared_bytes, const void* queries, const void* qlens,
    int batch, void* workspace, void* loci_out, void* overflow_out,
    void* stream) {
  DenseTables t;
  t.first_child = (const int*)first_child;
  t.edge_char = (const int*)edge_char;
  t.edge_child = (const int*)edge_child;
  t.n_edges = n_edges;
  t.s_first_child = (const int*)s_first_child;
  t.s_edge_char = (const int*)s_edge_char;
  t.s_edge_child = (const int*)s_edge_child;
  t.n_syn_edges = n_syn_edges;
  t.syn_mask = (const unsigned char*)syn_mask;
  t.tout_arr = (const int*)tout;
  t.tele_plane = (const int*)tele_plane;
  t.tele_width = tele_width;
  t.teleports = teleports;
  t.link_ptr = (const int*)link_ptr;
  t.link_rule = (const int*)link_rule;
  t.link_target = (const int*)link_target;
  t.n_links = n_links;
  return launch(t,
                rule_tables(r_first_child, r_edge_char, r_edge_child,
                            n_r_edges, r_term_plane, term_width),
                shape(frontier, seq_len, rule_matches, max_lhs_len,
                      max_terms, cand_cap, edit_budget, buf_in_ws, cand_in_ws, ws_stride),
                threads, shared_bytes, queries, qlens, batch, workspace,
                loci_out, overflow_out, stream);
}

extern "C" int locus_dp_packed_launch(
    const void* labels, const void* flags, int n_nodes, const void* c_ids,
    int n_c, const void* c_tout, const void* b_ids, int n_b,
    const void* b_ptr, const void* b_char, const void* b_child,
    const void* sb_ids, int n_sb, const void* sb_ptr, const void* sb_char,
    const void* sb_child, int n_sb_edges, const void* t_ids, int n_t,
    const void* t_plane, int tele_width, int teleports, const void* la_ids,
    int n_la, const void* la_ptr, const void* link_rule,
    const void* link_target, int n_links, const void* r_first_child,
    const void* r_edge_char, const void* r_edge_child, int n_r_edges,
    const void* r_term_plane, int term_width, int frontier, int seq_len,
    int rule_matches, int max_lhs_len, int max_terms, int cand_cap,
    int edit_budget, int buf_in_ws, int cand_in_ws,
    long long ws_stride, int threads, int shared_bytes, const void* queries,
    const void* qlens, int batch, void* workspace, void* loci_out,
    void* overflow_out, void* stream) {
  PackedTables t;
  t.labels = (const unsigned char*)labels;
  t.flags = (const unsigned char*)flags;
  t.n_nodes = n_nodes;
  t.c_ids = (const int*)c_ids;
  t.n_c = n_c;
  t.c_tout = (const int*)c_tout;
  t.b_ids = (const int*)b_ids;
  t.n_b = n_b;
  t.b_ptr = (const int*)b_ptr;
  t.b_char = (const unsigned char*)b_char;
  t.b_child = (const int*)b_child;
  t.sb_ids = (const int*)sb_ids;
  t.n_sb = n_sb;
  t.sb_ptr = (const int*)sb_ptr;
  t.sb_char = (const unsigned char*)sb_char;
  t.sb_child = (const int*)sb_child;
  t.n_sb_edges = n_sb_edges;
  t.t_ids = (const int*)t_ids;
  t.n_t = n_t;
  t.t_plane = (const int*)t_plane;
  t.tele_width = tele_width;
  t.teleports = teleports;
  t.la_ids = (const int*)la_ids;
  t.n_la = n_la;
  t.la_ptr = (const int*)la_ptr;
  t.link_rule = (const int*)link_rule;
  t.link_target = (const int*)link_target;
  t.n_links = n_links;
  return launch(t,
                rule_tables(r_first_child, r_edge_char, r_edge_child,
                            n_r_edges, r_term_plane, term_width),
                shape(frontier, seq_len, rule_matches, max_lhs_len,
                      max_terms, cand_cap, edit_budget, buf_in_ws, cand_in_ws, ws_stride),
                threads, shared_bytes, queries, qlens, batch, workspace,
                loci_out, overflow_out, stream);
}

extern "C" const char* locus_dp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
