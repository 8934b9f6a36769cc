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
// scan and scan2 rows of one merge when they fit; past the 227 KB a block
// may have, the wrapper gives each block a slice of a device-memory
// workspace for them (and, past that, for the frontier too).  At each
// position i:
//   - literal step: row i+1 gets the dict and synonym children of row i
//     labelled q[i] (one lower-bound search per frontier entry), and at
//     E > 0 the insert and substitute states;
//   - rule steps: thread 0 descends the rule trie from position i; every
//     full-lhs match (at most `rule_matches` per position, counted per
//     term) looks up (anchor, rule) in the link store for each dict node
//     of row i and merges the targets into the row where the lhs ends —
//     only when some target exists;
//   - write-back: row i+1 is complete, so its teleport targets are merged
//     in, then the E delete rounds.
// Every merge is a block-wide bitonic sort of the candidate row (padded to
// a power of two with INT_MAX for empty) and a prefix-sum compaction: ids
// ascending, the first F kept, overflow += max(uniques - F, 0) — exactly
// `dedup_pad`.  The final row drops synonym loci, is deduplicated again,
// and loses every id covered by another's preorder interval [id, tout).
// The states are decoded to nodes before that step.
//
// Bound: the bytes a query must read are a pointer pair, a few characters
// and a child per live frontier entry and position, plus teleport and link
// rows — small next to the work of keeping the frontier canonical, so the
// kernel is bound by block-wide synchronisation and the latency of its
// dependent table loads, not by bandwidth.  What the design does about it:
// the frontier and every merge stay in shared memory (no device-memory
// traffic between positions), and the table lookups of one merge run in
// parallel across the block's threads.
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
  int branch_width;   // BW: the widest child window
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

// Ascending bitonic sort of a[0, n), n a power of two.  Called by every
// thread of the block after a[] is written and synchronised; returns
// synchronised.
__device__ void bitonic_sort(int* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
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
      __syncthreads();
    }
  }
}

__device__ __forceinline__ bool first_of_run(const int* a, int i) {
  return a[i] != kIntMax && (i == 0 || a[i] != a[i - 1]);
}

// Sort cand[0, n) and write its unique ids, ascending, into out[0, width)
// (-1 padded).  Returns max(#unique - width, 0) to every thread.
__device__ int sort_compact(int* cand, int n, int* out, int width,
                            int* scan, int* scan2) {
  bitonic_sort(cand, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    scan[i] = first_of_run(cand, i) ? 1 : 0;
  }
  __syncthreads();
  int* src = scan;
  int* dst = scan2;
  for (int off = 1; off < n; off <<= 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      dst[i] = src[i] + (i >= off ? src[i - off] : 0);
    }
    __syncthreads();
    int* tmp = src;
    src = dst;
    dst = tmp;
  }
  const int total = src[n - 1];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (first_of_run(cand, i)) {
      const int r = src[i] - 1;
      if (r < width) out[r] = cand[i];
    }
  }
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    if (j >= total) out[j] = -1;
  }
  __syncthreads();
  return total > width ? total - width : 0;
}

// row [F] += its teleport targets (each at its source's edit count),
// deduplicated back to [F]; returns the overflow of the merge.
template <class T>
__device__ int tele_expand(const T& t, int* row, int F, int e1, int* cand,
                           int* scan, int* scan2) {
  const int tw = t.tele_width;
  const int total = F * (1 + tw);
  const int n = pow2_at_least(total);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int v = -1;
    if (j < F) {
      v = row[j];
    } else if (j < total) {
      const int st = row[(j - F) / tw];
      const int node = state_node(st, e1);
      if (node >= 0) {
        v = encode(t.tele(node, (j - F) % tw), state_edits(st, e1), e1);
      }
    }
    cand[j] = v < 0 ? kIntMax : v;
  }
  __syncthreads();
  return sort_compact(cand, n, row, F, scan, scan2);
}

// The child window of every state of row [F] into (lo[f], cnt[f]); cnt is
// 0 for an empty slot and for a state with no edit left (d == E).
// Returns synchronised.
template <class T>
__device__ void row_windows(const T& t, const int* row, int F, int E,
                            int* lo, int* cnt) {
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const int node = state_node(row[f], E + 1);
    int l = 0;
    int c = 0;
    if (node >= 0 && state_edits(row[f], E + 1) < E) t.window(node, &l, &c);
    lo[f] = l;
    cnt[f] = c;
  }
  __syncthreads();
}

// One delete round over row [F]: every dict child of a state with d < E,
// at d+1, merged into the row; returns the overflow of the merge.  The
// windows sit in scan/scan2 until the candidates are formed.
template <class T>
__device__ int delete_round(const T& t, int* row, int F, int E, int BW,
                            int* cand, int* scan, int* scan2) {
  row_windows(t, row, F, E, scan, scan2);
  const int total = F * (1 + BW);
  const int n = pow2_at_least(total);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int v = -1;
    if (j < F) {
      v = row[j];
    } else if (j < total) {
      const int f = (j - F) / BW;
      const int w = (j - F) % BW;
      if (w < scan2[f]) {
        int ch, child;
        t.window_at(scan[f], w, &ch, &child);
        v = encode(child, state_edits(row[f], E + 1) + 1, E + 1);
      }
    }
    cand[j] = v < 0 ? kIntMax : v;
  }
  __syncthreads();
  return sort_compact(cand, n, row, F, scan, scan2);
}

// The fixpoint of a completed row: its teleports, then E delete rounds.
template <class T>
__device__ int expand_row(const T& t, int* row, int F, int E, int BW,
                          int* cand, int* scan, int* scan2) {
  int overflow = 0;
  if (t.teleports > 0) {
    overflow += tele_expand(t, row, F, E + 1, cand, scan, scan2);
  }
  for (int r = 0; r < E; ++r) {
    overflow += delete_round(t, row, F, E, BW, cand, scan, scan2);
  }
  return overflow;
}

template <class T>
__global__ void locus_dp_kernel(T t, RuleTables r, Shape s,
                                const int* __restrict__ queries,
                                const int* __restrict__ qlens,
                                int* __restrict__ workspace,
                                int* __restrict__ loci_out,
                                int* __restrict__ overflow_out) {
  extern __shared__ int smem[];
  const int F = s.frontier;
  const int L = s.seq_len;
  const int M = s.rule_matches;
  const int C = s.cand_cap;
  const int E = s.edit_budget;
  const int E1 = E + 1;
  const int BW = s.branch_width;
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
  int* cand;                           // C candidates of one merge
  if (s.cand_in_ws) {
    cand = ws;
  } else {
    cand = sm;
    sm += 3 * C;
  }
  int* scan = cand + C;                // C
  int* scan2 = scan + C;               // C
  int* q = sm;                         // L query characters
  int* m_rule = q + L;                 // M rule matches of one position
  int* m_end = m_rule + (M > 0 ? M : 1);
  __shared__ int n_match;

  const int* qrow = queries + (long long)b * L;
  for (int i = threadIdx.x; i < (L + 1) * F; i += blockDim.x) buf[i] = -1;
  for (int i = threadIdx.x; i < L; i += blockDim.x) q[i] = qrow[i];
  __syncthreads();
  if (threadIdx.x == 0) buf[0] = 0;   // the root at d=0 encodes to 0
  __syncthreads();

  // the same in every thread: merges return it to all
  int overflow = expand_row(t, buf, F, E, BW, cand, scan, scan2);

  const int has_syn = t.has_syn() ? 1 : 0;
  for (int i = 0; i < L; ++i) {
    const int* row = buf + i * F;
    int* nxt = buf + (i + 1) * F;
    const int c = q[i];

    // literal step: row i+1 U dict children U synonym children, and at
    // E > 0 U insert states U substitute states (segments of F, F, F,
    // F and F*BW candidates)
    const bool edits = E > 0 && c >= 0;
    if (edits) row_windows(t, row, F, E, scan, scan2);
    const int off_ins = (2 + has_syn) * F;
    const int off_sub = off_ins + (edits ? F : 0);
    const int total = off_sub + (edits ? F * BW : 0);
    const int n = pow2_at_least(total);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      int v = -1;
      if (j < F) {
        v = nxt[j];
      } else if (j < off_ins) {
        const int f = j < 2 * F ? j - F : j - 2 * F;
        const int st = row[f];
        const int node = state_node(st, E1);
        const int ch = j < 2 * F ? t.dict_child(node, c)
                                 : t.syn_child(node, c);
        v = encode(ch, state_edits(st, E1), E1);
      } else if (j < off_sub) {
        // insert: the query has an extra character; mid-variant
        // (synonym) nodes absorb none
        const int st = row[j - off_ins];
        const int node = state_node(st, E1);
        const int d = state_edits(st, E1);
        if (node >= 0 && d < E && !t.is_syn(node)) v = node * E1 + d + 1;
      } else if (j < total) {
        // substitute: every dict child not labelled c (the matching one
        // rides the literal part); the window is empty at d == E
        const int f = (j - off_sub) / BW;
        const int w = (j - off_sub) % BW;
        if (w < scan2[f]) {
          int ch, child;
          t.window_at(scan[f], w, &ch, &child);
          if (ch != c) v = encode(child, state_edits(row[f], E1) + 1, E1);
        }
      }
      cand[j] = v < 0 ? kIntMax : v;
    }
    __syncthreads();
    overflow += sort_compact(cand, n, nxt, F, scan, scan2);

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
        n_match = cnt;
      }
      __syncthreads();
      const int nm = n_match;
      for (int m = 0; m < nm; ++m) {
        const int rid = m_rule[m];
        int* dst = buf + m_end[m] * F;
        int any = 0;
        for (int j = threadIdx.x; j < F; j += blockDim.x) {
          const int a = state_node(row[j], E1);
          int tg = -1;
          if (a >= 0 && !t.is_syn(a)) {
            tg = encode(t.link(a, rid), state_edits(row[j], E1), E1);
          }
          cand[F + j] = tg < 0 ? kIntMax : tg;
          any |= tg >= 0;
        }
        if (__syncthreads_or(any)) {
          const int n2 = pow2_at_least(2 * F);
          for (int j = threadIdx.x; j < n2; j += blockDim.x) {
            if (j < F) {
              cand[j] = dst[j] < 0 ? kIntMax : dst[j];
            } else if (j >= 2 * F) {
              cand[j] = kIntMax;
            }
          }
          __syncthreads();
          overflow += sort_compact(cand, n2, dst, F, scan, scan2);
        }
      }
      __syncthreads();   // n_match and m_* are rewritten next position
    }

    // write-back: row i+1 is complete (rule ends are > i), expand it
    overflow += expand_row(t, nxt, F, E, BW, cand, scan, scan2);
  }

  // finalize the row at the query's own length
  int ql = qlens[b];
  ql = ql < 0 ? 0 : (ql > L ? L : ql);
  const int* row = buf + ql * F;
  const int n = pow2_at_least(F);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int v = j < F ? state_node(row[j], E1) : -1;   // states -> nodes
    if (v >= 0 && t.is_syn(v)) v = -1;
    cand[j] = v < 0 ? kIntMax : v;
  }
  __syncthreads();
  int* fin = buf;   // row 0 is no longer read: the row was copied to cand
  sort_compact(cand, n, fin, F, scan, scan2);
  int* fin_tout = scan;   // each locus's subtree end, read once
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    fin_tout[j] = fin[j] >= 0 ? t.tout(fin[j]) : 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    const int x = fin[j];
    int res = x;
    if (x >= 0) {
      for (int g = 0; g < F; ++g) {
        const int y = fin[g];
        if (g != j && y >= 0 && y <= x && x < fin_tout[g]) {
          res = -1;
          break;
        }
      }
    }
    loci_out[(long long)b * F + j] = res;
  }
  if (threadIdx.x == 0) overflow_out[b] = overflow;
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
            int max_terms, int cand_cap, int edit_budget, int branch_width,
            int buf_in_ws, int cand_in_ws, long long ws_stride) {
  Shape s;
  s.frontier = frontier;
  s.seq_len = seq_len;
  s.rule_matches = rule_matches;
  s.max_lhs_len = max_lhs_len;
  s.max_terms = max_terms;
  s.cand_cap = cand_cap;
  s.edit_budget = edit_budget;
  s.branch_width = branch_width;
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
    int branch_width, int buf_in_ws, int cand_in_ws, long long ws_stride,
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
                      max_terms, cand_cap, edit_budget, branch_width,
                      buf_in_ws, cand_in_ws, ws_stride),
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
    int edit_budget, int branch_width, int buf_in_ws, int cand_in_ws,
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
                      max_terms, cand_cap, edit_budget, branch_width,
                      buf_in_ws, cand_in_ws, ws_stride),
                threads, shared_bytes, queries, qlens, batch, workspace,
                loci_out, overflow_out, stream);
}

extern "C" const char* locus_dp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
