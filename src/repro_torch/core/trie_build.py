"""Host-side construction of array-encoded tries (numpy).

The paper's pointer tries become structure-of-arrays tries:

- child lookup CSR sorted by char within each node (binary-searchable),
- per-node *emission lists* sorted by max-descendant-score descending
  (the paper orders children by highest descendant score; we additionally
  interleave the node's own leaf so the beam engine emits in exact score
  order),
- synonym teleports (ET/HT expanded rules): CSR node -> dictionary target,
- rule-link store (TT/HT unexpanded rules): sorted (anchor, rule) -> target.

Construction is offline/host-side (like data loading in a training job);
lookup runs on device from these arrays alone.

A copy of ``repro.core.trie_build``: the arrays it builds, dense and
compressed (``pack_compressed``), are bit-identical to the JAX package's,
which keeps node ids — and so every locus, overflow count and result —
comparable across the two.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core.alphabet import SIGMA

ROOT = 0

# p_flags bits of the compressed layout (see pack_compressed)
PACK_DICT_UNARY = 1   # exactly one dict child, and it is v + 1
PACK_SYN_UNARY = 2    # exactly one syn child, and it is v + 1
PACK_IS_SYN = 4       # pure synonym node (== syn_mask)
PACK_HAS_LEAF = 8     # terminal node (leaf_score >= 0)

# fields that exist only in the compressed layout / that a packed (format
# v4) container keeps from the uncompressed layout
PACKED_ONLY_FIELDS = (
    "p_labels", "p_flags",
    "c_ids", "c_tout", "c_maxscore", "c_eptr", "c_enode", "c_escore",
    "c_eleaf",
    "b_ids", "b_ptr", "b_char", "b_child",
    "sb_ids", "sb_ptr", "sb_char", "sb_child",
    "l_ids", "l_sid", "t_ids", "t_plane", "la_ids", "la_ptr",
    "pc_score", "pc_base", "pc_sid",
)
PACKED_KEEP_FIELDS = ("link_rule", "link_target")


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SynonymRule:
    """A rule ``lhs -> rhs``: applying it to a *query* replaces an occurrence
    of ``lhs`` with ``rhs`` (the dictionary-side form)."""

    lhs: bytes
    rhs: bytes

    def __post_init__(self):
        if len(self.lhs) == 0 or len(self.rhs) == 0:
            raise ValueError("synonym rule sides must be non-empty")


def make_rules(pairs) -> list[SynonymRule]:
    out = []
    for lhs, rhs in pairs:
        lhs = lhs.encode() if isinstance(lhs, str) else bytes(lhs)
        rhs = rhs.encode() if isinstance(rhs, str) else bytes(rhs)
        out.append(SynonymRule(lhs, rhs))
    return out


# ---------------------------------------------------------------------------
# Array tries
# ---------------------------------------------------------------------------


@dataclass
class DictTrie:
    """Array-encoded dictionary trie (+ synonym structures).

    Every field is optional with a ``None`` default so that a
    ``compression="packed"`` container (format v4) — which persists only
    the compressed side tables plus the link store — can round-trip
    through ``DictTrie(**saved_arrays)``; builders always populate the
    uncompressed fields.
    """

    # per-node
    parent: np.ndarray | None = None      # int32[N]
    depth: np.ndarray | None = None       # int32[N]
    chr_: np.ndarray | None = None        # int32[N]  incoming edge (-1 root)
    max_score: np.ndarray | None = None   # int32[N]  max leaf score in subtree
    leaf_score: np.ndarray | None = None  # int32[N]  score if terminal else -1
    leaf_sid: np.ndarray | None = None    # int32[N]  sorted string id or -1
    syn_mask: np.ndarray | None = None    # bool [N]  True for syn nodes
    tout: np.ndarray | None = None        # int32[N]  subtree range [id, tout)

    # dictionary-child lookup CSR (within-node sorted by char)
    first_child: np.ndarray | None = None  # int32[N+1]
    edge_char: np.ndarray | None = None    # int32[E]
    edge_child: np.ndarray | None = None   # int32[E]

    # synonym-child lookup CSR (branches live in their own edge set so that
    # a dictionary node and a synonym branch may both continue with the same
    # character, and so that teleports can only be reached by literally typed
    # variant characters — rule output never participates in a later rule)
    s_first_child: np.ndarray | None = None  # int32[N+1]
    s_edge_char: np.ndarray | None = None    # int32[Es]
    s_edge_child: np.ndarray | None = None   # int32[Es]

    # emission lists (within-node sorted by score desc; excludes syn children)
    emit_ptr: np.ndarray | None = None     # int32[N+1]
    emit_node: np.ndarray | None = None    # int32[M]
    emit_score: np.ndarray | None = None   # int32[M]
    emit_is_leaf: np.ndarray | None = None  # bool[M] True => leaf of emit_node

    # synonym teleports (node -> dict target), CSR
    syn_ptr: np.ndarray | None = None      # int32[N+1]
    syn_tgt: np.ndarray | None = None      # int32[S]

    # unexpanded-rule link store, sorted by (anchor, rule)
    link_anchor: np.ndarray | None = None  # int32[L]
    link_rule: np.ndarray | None = None    # int32[L]
    link_target: np.ndarray | None = None  # int32[L]

    # packed rule plane (see pack_rule_planes): dense, padded relayouts of
    # the rule-side CSRs that the device engine and the fused locus-DP
    # kernel consume directly
    tele_plane: np.ndarray | None = None  # int32[N, Tw] teleports, -1 pad
    link_ptr: np.ndarray | None = None    # int32[N+1] anchor -> link rows

    # tile-aligned stream layout (see pack_stream_tiles): static window
    # widths for the DMA-streamed kernel tier; 0 until packed
    walk_tile: int = 0
    emit_tile: int = 0
    link_tile: int = 0

    # optional materialized per-node top-K (dict leaves only)
    topk_score: np.ndarray | None = None  # int32[N, K]
    topk_sid: np.ndarray | None = None    # int32[N, K]

    # compressed on-device layout (see pack_compressed): logical node ids
    # unchanged, per-node data chain-collapsed into sparse side tables at
    # the stored (chain-representative) nodes; None until packed
    p_labels: np.ndarray | None = None    # u8[N]  incoming-edge byte (root 0)
    p_flags: np.ndarray | None = None     # u8[N]  PACK_* bits
    c_ids: np.ndarray | None = None       # i32[C] stored dict nodes, sorted
    c_tout: np.ndarray | None = None      # i32[C]
    c_maxscore: np.ndarray | None = None  # u16/i32[C]
    c_eptr: np.ndarray | None = None      # i32[C+1] emission spans
    c_enode: np.ndarray | None = None     # i32[Me]
    c_escore: np.ndarray | None = None    # u16/i32[Me]
    c_eleaf: np.ndarray | None = None     # u8[Me]
    b_ids: np.ndarray | None = None       # i32[B]  dict fanout >= 2, sorted
    b_ptr: np.ndarray | None = None       # i32[B+1]
    b_char: np.ndarray | None = None      # u8[Eb]
    b_child: np.ndarray | None = None     # i32[Eb]
    sb_ids: np.ndarray | None = None      # i32[Sb] non-unary syn rows, sorted
    sb_ptr: np.ndarray | None = None      # i32[Sb+1]
    sb_char: np.ndarray | None = None     # u8[Esb]
    sb_child: np.ndarray | None = None    # i32[Esb]
    l_ids: np.ndarray | None = None       # i32[S]  terminal nodes, sorted
    l_sid: np.ndarray | None = None       # u16/i32[S]
    t_ids: np.ndarray | None = None       # i32[Tn] teleport-bearing, sorted
    t_plane: np.ndarray | None = None     # i32[Tn, tele_width], -1 pad
    la_ids: np.ndarray | None = None      # i32[La] link anchors, sorted
    la_ptr: np.ndarray | None = None      # i32[La+1] spans into link_rule
    pc_score: np.ndarray | None = None    # u16/i32[C, K] (+1-biased if u16)
    pc_base: np.ndarray | None = None     # i32[C] per-row score base
    pc_sid: np.ndarray | None = None      # u16/i32[C, K] (+1-biased if u16)

    # static metadata
    max_depth: int = 0
    max_syn_targets: int = 0

    @property
    def has_packed(self) -> bool:
        return self.p_labels is not None

    @property
    def n_nodes(self) -> int:
        if self.parent is not None:
            return len(self.parent)
        return len(self.p_labels)

    @property
    def n_edges(self) -> int:
        return len(self.edge_char)

    def nbytes(self, include_cache: bool = True) -> int:
        total = 0
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                if not include_cache and f.name.startswith("topk_"):
                    continue
                total += v.nbytes
        return total

    def packed_nbytes(self, include_cache: bool = True) -> int:
        """Device bytes of the compressed layout alone (what a packed
        container persists and what the device holds)."""
        total = 0
        for name in PACKED_ONLY_FIELDS + PACKED_KEEP_FIELDS:
            v = getattr(self, name)
            if isinstance(v, np.ndarray):
                if not include_cache and name.startswith("pc_"):
                    continue
                total += v.nbytes
        return total


@dataclass
class RuleTrie:
    """Array-encoded trie over the query-side (lhs) strings of rules."""

    first_child: np.ndarray  # int32[N+1]
    edge_char: np.ndarray    # int32[E]
    edge_child: np.ndarray   # int32[E]
    depth: np.ndarray        # int32[N]
    term_ptr: np.ndarray     # int32[N+1]  node -> rule ids terminating here
    term_rule: np.ndarray    # int32[T]
    rule_len: np.ndarray     # int32[R]    lhs length per rule id
    # packed rule plane (see pack_rule_planes): term lists as a dense,
    # -1-padded [N, term_width] plane (term_width >= 1 even when empty,
    # so device gathers never need a degenerate-shape guard)
    term_plane: np.ndarray | None = None  # int32[N, Tw]
    max_lhs_len: int = 0
    max_matches_per_pos: int = 0  # max #terminals on any root path
    max_terms_per_node: int = 1   # max #rules terminating at one node

    @property
    def n_nodes(self) -> int:
        return len(self.depth)

    def nbytes(self) -> int:
        total = 0
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                total += v.nbytes
        return total


# ---------------------------------------------------------------------------
# Dictionary trie construction (sorted-strings + LCP sweep)
# ---------------------------------------------------------------------------


def _sorted_unique(strings: list[bytes], scores: np.ndarray):
    order = sorted(range(len(strings)), key=lambda i: strings[i])
    sorted_strings: list[bytes] = []
    sorted_scores: list[int] = []
    for i in order:
        s = strings[i]
        if sorted_strings and sorted_strings[-1] == s:
            sorted_scores[-1] = max(sorted_scores[-1], int(scores[i]))
        else:
            sorted_strings.append(s)
            sorted_scores.append(int(scores[i]))
    return sorted_strings, np.asarray(sorted_scores, dtype=np.int32)


def _lcp(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def build_dict_trie(strings: list[bytes | str], scores) -> tuple[DictTrie, list[bytes], np.ndarray]:
    """Build the dictionary trie. Returns (trie, sorted_strings, sorted_scores).

    String ids (leaf_sid) index into the *sorted* string list.
    """
    raw = [s.encode() if isinstance(s, str) else bytes(s) for s in strings]
    scores = np.asarray(scores)
    assert len(raw) == len(scores)
    ss, sc = _sorted_unique(raw, scores)
    n_str = len(ss)

    # --- node creation sweep (nodes are created in DFS preorder) ---
    parent_chunks: list[np.ndarray] = [np.array([-1], dtype=np.int32)]
    char_chunks: list[np.ndarray] = [np.array([-1], dtype=np.int32)]
    depth_chunks: list[np.ndarray] = [np.array([0], dtype=np.int32)]
    next_id = 1
    max_len = max((len(s) for s in ss), default=0)
    path = np.zeros(max_len + 1, dtype=np.int64)  # node id at each depth
    leaf_nodes = np.zeros(n_str, dtype=np.int32)
    prev = b""
    for i, s in enumerate(ss):
        d0 = _lcp(prev, s)
        cnt = len(s) - d0
        if cnt > 0:
            ids = np.arange(next_id, next_id + cnt, dtype=np.int32)
            parents = np.empty(cnt, dtype=np.int32)
            parents[0] = path[d0]
            parents[1:] = ids[:-1]
            chars = np.frombuffer(s[d0:], dtype=np.uint8).astype(np.int32)
            depths = np.arange(d0 + 1, len(s) + 1, dtype=np.int32)
            parent_chunks.append(parents)
            char_chunks.append(chars)
            depth_chunks.append(depths)
            path[d0 + 1 : len(s) + 1] = ids
            next_id += cnt
        leaf_nodes[i] = path[len(s)]
        prev = s

    parent = np.concatenate(parent_chunks)
    chr_ = np.concatenate(char_chunks)
    depth = np.concatenate(depth_chunks)
    n = next_id

    leaf_score = np.full(n, -1, dtype=np.int32)
    leaf_sid = np.full(n, -1, dtype=np.int32)
    leaf_score[leaf_nodes] = sc
    leaf_sid[leaf_nodes] = np.arange(n_str, dtype=np.int32)

    syn_mask = np.zeros(n, dtype=bool)
    max_score = _propagate_max_scores(parent, depth, leaf_score)
    tout = _compute_tout(parent, depth)

    trie = DictTrie(
        parent=parent,
        depth=depth,
        chr_=chr_,
        max_score=max_score,
        leaf_score=leaf_score,
        leaf_sid=leaf_sid,
        syn_mask=syn_mask,
        tout=tout,
        first_child=np.zeros(n + 1, np.int32),
        edge_char=np.zeros(0, np.int32),
        edge_child=np.zeros(0, np.int32),
        s_first_child=np.zeros(n + 1, np.int32),
        s_edge_char=np.zeros(0, np.int32),
        s_edge_child=np.zeros(0, np.int32),
        emit_ptr=np.zeros(n + 1, np.int32),
        emit_node=np.zeros(0, np.int32),
        emit_score=np.zeros(0, np.int32),
        emit_is_leaf=np.zeros(0, bool),
        syn_ptr=np.zeros(n + 1, np.int32),
        syn_tgt=np.zeros(0, np.int32),
        link_anchor=np.zeros(0, np.int32),
        link_rule=np.zeros(0, np.int32),
        link_target=np.zeros(0, np.int32),
        max_depth=int(depth.max(initial=0)),
    )
    rebuild_edges(trie)
    return trie, ss, sc


def _compute_tout(parent, depth) -> np.ndarray:
    """Dictionary nodes are created in DFS preorder, so subtree(v) is the
    contiguous id range [v, tout[v]). Enables O(1) ancestor tests (used to
    reduce locus sets to an antichain so top-k never double-counts)."""
    n = len(parent)
    tout = np.arange(1, n + 1, dtype=np.int32)
    if n == 0:
        return tout
    order = np.argsort(depth, kind="stable")
    max_d = int(depth.max(initial=0))
    bounds = np.searchsorted(depth[order], np.arange(max_d + 2))
    for d in range(max_d, 0, -1):
        ids = order[bounds[d] : bounds[d + 1]]
        if len(ids) == 0:
            continue
        np.maximum.at(tout, parent[ids], tout[ids])
    return tout


def _propagate_max_scores(parent, depth, leaf_score) -> np.ndarray:
    """max_score[v] = max leaf_score over v's subtree (dict leaves only)."""
    n = len(parent)
    max_score = leaf_score.copy()
    if n == 0:
        return max_score
    max_d = int(depth.max(initial=0))
    # group node ids by depth once
    order = np.argsort(depth, kind="stable")
    bounds = np.searchsorted(depth[order], np.arange(max_d + 2))
    for d in range(max_d, 0, -1):
        ids = order[bounds[d] : bounds[d + 1]]
        if len(ids) == 0:
            continue
        np.maximum.at(max_score, parent[ids], max_score[ids])
    return max_score


def _order2(major: np.ndarray, minor: np.ndarray) -> np.ndarray:
    """``np.lexsort((minor, major))`` for non-negative int32 ``major`` and
    int32 ``minor``: one stable argsort of a combined int64 key, the same
    permutation (a tie keeps its input order either way), ~4x faster."""
    key = (major.astype(np.int64) << 32) | (minor.astype(np.int64) + 2**31)
    return np.argsort(key, kind="stable")


def rebuild_edges(trie: DictTrie) -> None:
    """(Re)build dict/syn child CSRs + emission lists from parent/chr arrays."""
    n = trie.n_nodes
    all_ids = np.arange(n, dtype=np.int32)
    is_child = all_ids != ROOT

    for syn in (False, True):
        sel = is_child & (trie.syn_mask == syn)
        ids = all_ids[sel]
        p = trie.parent[ids]
        c = trie.chr_[ids]
        order = _order2(p, c)
        ids, p, c = ids[order], p[order], c[order]
        counts = np.bincount(p, minlength=n).astype(np.int32)
        ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        if syn:
            trie.s_first_child = ptr
            trie.s_edge_char = c.astype(np.int32)
            trie.s_edge_child = ids.astype(np.int32)
        else:
            trie.first_child = ptr
            trie.edge_char = c.astype(np.int32)
            trie.edge_child = ids.astype(np.int32)
            dict_ids, dict_par = ids, p

    # emission lists: dictionary children (ranked by max_score) + own leaf;
    # the children in the dictionary CSR's (parent, char) order
    e_par = dict_par
    e_node = dict_ids
    e_score = trie.max_score[e_node]
    e_leaf = np.zeros(len(e_node), dtype=bool)
    term = np.nonzero(trie.leaf_score >= 0)[0].astype(np.int32)
    e_par = np.concatenate([e_par, term])
    e_node = np.concatenate([e_node, term])
    e_score = np.concatenate([e_score, trie.leaf_score[term]])
    e_leaf = np.concatenate([e_leaf, np.ones(len(term), dtype=bool)])
    order = _order2(e_par, -e_score)
    e_par, e_node, e_score, e_leaf = (
        e_par[order], e_node[order], e_score[order], e_leaf[order])
    counts = np.bincount(e_par, minlength=n).astype(np.int32)
    trie.emit_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    trie.emit_node = e_node.astype(np.int32)
    trie.emit_score = e_score.astype(np.int32)
    trie.emit_is_leaf = e_leaf


# ---------------------------------------------------------------------------
# Host-side edge lookup (int64 keys, vectorized)
# ---------------------------------------------------------------------------


class _EdgeIndex:
    def __init__(self, trie: DictTrie):
        key = trie.edge_child  # children ids
        self.keys = trie.parent[key].astype(np.int64) * SIGMA + trie.chr_[key]
        order = np.argsort(self.keys, kind="stable")
        self.keys = self.keys[order]
        self.children = key[order].astype(np.int32)

    def lookup(self, nodes: np.ndarray, char: int) -> np.ndarray:
        k = nodes.astype(np.int64) * SIGMA + char
        i = np.searchsorted(self.keys, k)
        i = np.minimum(i, len(self.keys) - 1) if len(self.keys) else i * 0
        ok = (len(self.keys) > 0) & (self.keys[i] == k) if len(self.keys) else np.zeros(len(k), bool)
        return np.where(ok, self.children[i] if len(self.keys) else -1, -1).astype(np.int32)


# ---------------------------------------------------------------------------
# Rule trie + links
# ---------------------------------------------------------------------------


def build_rule_trie(rules: list[SynonymRule], active: np.ndarray | None = None) -> RuleTrie:
    """Trie over lhs strings of *active* rules (rule ids are global)."""
    n_rules = len(rules)
    if active is None:
        active = np.ones(n_rules, dtype=bool)
    items = sorted((rules[i].lhs, i) for i in range(n_rules) if active[i])

    parent = [np.array([-1], np.int32)]
    chr_ = [np.array([-1], np.int32)]
    depth = [np.array([0], np.int32)]
    next_id = 1
    max_len = max((len(s) for s, _ in items), default=0)
    path = np.zeros(max_len + 1, dtype=np.int64)
    terms: list[tuple[int, int]] = []  # (node, rule)
    prev = b""
    for s, rid in items:
        d0 = _lcp(prev, s)
        cnt = len(s) - d0
        if cnt > 0:
            ids = np.arange(next_id, next_id + cnt, dtype=np.int32)
            pp = np.empty(cnt, np.int32)
            pp[0] = path[d0]
            pp[1:] = ids[:-1]
            parent.append(pp)
            chr_.append(np.frombuffer(s[d0:], np.uint8).astype(np.int32))
            depth.append(np.arange(d0 + 1, len(s) + 1, dtype=np.int32))
            path[d0 + 1 : len(s) + 1] = ids
            next_id += cnt
        terms.append((int(path[len(s)]), rid))
        prev = s

    parent = np.concatenate(parent)
    chr_ = np.concatenate(chr_)
    depth = np.concatenate(depth)
    n = next_id

    ids = np.arange(1, n, dtype=np.int32)
    order = np.lexsort((chr_[ids], parent[ids]))
    ids = ids[order]
    counts = np.bincount(parent[ids], minlength=n).astype(np.int32)
    first_child = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    term_node = np.array([t for t, _ in terms], dtype=np.int32)
    term_rid = np.array([r for _, r in terms], dtype=np.int32)
    t_order = np.argsort(term_node, kind="stable")
    term_node, term_rid = term_node[t_order], term_rid[t_order]
    t_counts = np.bincount(term_node, minlength=n).astype(np.int32)
    term_ptr = np.concatenate([[0], np.cumsum(t_counts)]).astype(np.int32)

    # max #terminals along any root path = max over terminal nodes of
    # (#ancestors incl. self that are terminal); bounded by walking parents
    is_term = t_counts > 0
    max_matches = 0
    for t in term_node:
        cnt, v = 0, int(t)
        while v != -1:
            if is_term[v]:
                cnt += int(t_counts[v])
            v = int(parent[v]) if v != ROOT else -1
        max_matches = max(max_matches, cnt)

    rule_len = np.array([len(r.lhs) for r in rules], dtype=np.int32)
    return RuleTrie(
        first_child=first_child,
        edge_char=chr_[ids].astype(np.int32),
        edge_child=ids.astype(np.int32),
        depth=depth,
        term_ptr=term_ptr,
        term_rule=term_rid,
        rule_len=rule_len,
        max_lhs_len=int(max((len(s) for s, _ in items), default=0)),
        max_matches_per_pos=max_matches,
        max_terms_per_node=int(t_counts.max(initial=1)),
    )


def find_links(trie: DictTrie, rules: list[SynonymRule]):
    """All (anchor, rule, target) with target = walk(anchor, rule.rhs).

    Must be called on the pure dictionary trie (pre-expansion): rule
    applications may not anchor inside generated synonym text.
    """
    idx = _EdgeIndex(trie)
    anchors, rids, targets = [], [], []
    # group candidate starts by first char of rhs
    child_ids = trie.edge_child
    by_char: dict[int, np.ndarray] = {}
    for ch in np.unique(trie.edge_char):
        sel = trie.edge_char == ch
        by_char[int(ch)] = child_ids[sel]
    for rid, rule in enumerate(rules):
        rhs = np.frombuffer(rule.rhs, np.uint8).astype(np.int32)
        first = by_char.get(int(rhs[0]))
        if first is None:
            continue
        anchor = trie.parent[first]
        cur = first.copy()
        ok = np.ones(len(cur), dtype=bool)
        for c in rhs[1:]:
            nxt = idx.lookup(cur, int(c))
            ok &= nxt >= 0
            cur = np.where(ok, nxt, 0)
            if not ok.any():
                break
        if not ok.any():
            continue
        anchors.append(anchor[ok])
        targets.append(cur[ok])
        rids.append(np.full(int(ok.sum()), rid, dtype=np.int32))
    if anchors:
        return (np.concatenate(anchors).astype(np.int32),
                np.concatenate(rids).astype(np.int32),
                np.concatenate(targets).astype(np.int32))
    z = np.zeros(0, np.int32)
    return z, z, z


def set_link_store(trie: DictTrie, anchors, rids, targets) -> None:
    order = np.lexsort((rids, anchors))
    trie.link_anchor = anchors[order].astype(np.int32)
    trie.link_rule = rids[order].astype(np.int32)
    trie.link_target = targets[order].astype(np.int32)


def _csr_to_plane(ptr: np.ndarray, data: np.ndarray, width: int) -> np.ndarray:
    """Dense [len(ptr)-1, width] plane of a CSR, -1 padded, row order kept."""
    n = len(ptr) - 1
    plane = np.full((n, max(width, 1)), -1, dtype=np.int32)
    counts = np.diff(ptr)
    if len(data):
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        cols = np.arange(len(data), dtype=np.int64) - np.repeat(
            ptr[:-1].astype(np.int64), counts)
        plane[rows, cols] = data
    return plane


def pack_rule_planes(trie: DictTrie, rule_trie: RuleTrie) -> None:
    """Relayout the rule-side structures into the packed *rule plane*.

    The frontier sweep's three rule-side lookups each pay for CSR
    indirection in the sweep's hot loop; this packs them into the dense,
    padded forms the device engine (and the fused locus-DP kernel) consume
    with one vectorized gather / one binary search each:

    - ``trie.tele_plane`` int32[N, tele_width]: teleport targets per node,
      -1 padded (replaces the syn_ptr/syn_tgt gather chain);
    - ``trie.link_ptr`` int32[N+1]: per-anchor CSR over the (rule-sorted)
      ``link_rule``/``link_target`` rows (replaces two binary searches over
      ``link_anchor`` with one pointer load);
    - ``rule_trie.term_plane`` int32[Nr, term_width]: rule ids terminating
      at each rule-trie node, -1 padded.  Width >= 1 always, so gathers
      need no degenerate-shape clamp even for rule-free builds.

    Plane widths are static (recorded as ``EngineConfig.tele_width`` /
    ``term_width`` at build time) and ride the npz container from format
    version 2 on; loading an older container rebuilds them here.
    Must run after ``set_link_store`` / the final ``rebuild_edges``.
    """
    n = trie.n_nodes
    trie.tele_plane = _csr_to_plane(trie.syn_ptr, trie.syn_tgt,
                                    trie.max_syn_targets)
    trie.link_ptr = np.searchsorted(
        trie.link_anchor, np.arange(n + 1, dtype=np.int64)).astype(np.int32)
    rule_trie.term_plane = _csr_to_plane(rule_trie.term_ptr,
                                         rule_trie.term_rule,
                                         rule_trie.max_terms_per_node)


def _tile_width(max_row: int, minimum: int = 8) -> int:
    """Smallest power-of-two window >= the longest CSR row (min 8): one
    DMA of this width always covers a whole row."""
    w = minimum
    while w < max_row:
        w *= 2
    return w


def _tiled_len(real: int, tile: int) -> int:
    """Padded flat length for a ``real``-row table under ``tile``-wide
    windows: a multiple of ``tile`` that is >= real + tile, so a window
    starting at any in-range offset (including ``real`` itself, the empty
    row at the very end) stays in bounds."""
    return (real + 2 * tile - 1) // tile * tile


def _pad_tiled(arr: np.ndarray, real: int, tile: int, fill) -> np.ndarray:
    """Pad ``arr[:real]`` to ``_tiled_len(real, tile)`` with ``fill``.
    Re-slicing from ``real`` (the CSR ptr total) makes re-packing
    idempotent.  Empty tables stay empty: every ``shape[0] > 0``
    feature probe in the engine keeps its meaning."""
    if real == 0:
        return arr[:0]
    out = np.full(_tiled_len(real, tile), fill, dtype=arr.dtype)
    out[:real] = arr[:real]
    return out


def pack_stream_tiles(trie: DictTrie, rule_trie: RuleTrie) -> None:
    """Relayout the flat tables into the tile-aligned *stream layout*.

    The DMA-streamed kernel tier (``kernels/stream.py``) reads CSR child
    rows, emission rows and link-store rows with fixed-width windowed
    ``make_async_copy`` slices ``[start, start + tile)`` instead of
    holding the whole table in VMEM.  For those windows to be legal the
    layout must guarantee two statics, both recorded on the trie (and in
    ``EngineConfig`` at build time):

    - a *tile width* per table family — a power of two covering the
      longest row, so one window always spans a whole CSR row;
    - a *tail pad* — each flat array grows to a tile multiple at least
      one tile past its real length, so a window anchored at any row
      start (even the empty row at the very end) stays in bounds.

    Pad values are inert by construction (chars -1 never match a query
    byte, scores -1 never beat a live emission, child/target ids 0 are
    only read masked-off), and the real lengths stay recoverable from the
    CSR ptr totals, which makes re-packing idempotent.  Empty tables are
    left empty so ``shape[0] > 0`` feature probes keep working.  The
    resident kernels and the jnp reference engine confine every search to
    ``[ptr[n], ptr[n+1])`` and so return bit-identical results on the
    padded layout.  Must run after ``pack_rule_planes`` (needs
    ``link_ptr``) and any final ``rebuild_edges``.  Persisted as npz
    format v3; older containers re-pack here on load.
    """
    assert trie.link_ptr is not None, \
        "pack_stream_tiles requires pack_rule_planes to have run"
    fanout = int(np.diff(trie.first_child).max(initial=0))
    s_fanout = int(np.diff(trie.s_first_child).max(initial=0))
    trie.walk_tile = _tile_width(max(fanout, s_fanout))
    trie.emit_tile = _tile_width(int(np.diff(trie.emit_ptr).max(initial=0)))
    trie.link_tile = _tile_width(int(np.diff(trie.link_ptr).max(initial=0)))

    e = int(trie.first_child[-1])
    trie.edge_char = _pad_tiled(trie.edge_char, e, trie.walk_tile, -1)
    trie.edge_child = _pad_tiled(trie.edge_child, e, trie.walk_tile, 0)
    es = int(trie.s_first_child[-1])
    trie.s_edge_char = _pad_tiled(trie.s_edge_char, es, trie.walk_tile, -1)
    trie.s_edge_child = _pad_tiled(trie.s_edge_child, es, trie.walk_tile, 0)
    m = int(trie.emit_ptr[-1])
    trie.emit_node = _pad_tiled(trie.emit_node, m, trie.emit_tile, 0)
    trie.emit_score = _pad_tiled(trie.emit_score, m, trie.emit_tile, -1)
    trie.emit_is_leaf = _pad_tiled(trie.emit_is_leaf, m, trie.emit_tile,
                                   False)
    lk = int(trie.link_ptr[-1])
    trie.link_rule = _pad_tiled(trie.link_rule, lk, trie.link_tile, -1)
    trie.link_target = _pad_tiled(trie.link_target, lk, trie.link_tile, 0)


# ---------------------------------------------------------------------------
# Synonym expansion (ET / HT)
# ---------------------------------------------------------------------------


def expand_synonyms(trie: DictTrie, rules: list[SynonymRule],
                    anchors: np.ndarray, rids: np.ndarray, targets: np.ndarray,
                    expand_mask: np.ndarray) -> int:
    """Expand the links of rules selected by ``expand_mask`` into the trie as
    zero-score synonym branches; terminal branch nodes teleport to the link
    target. Mutates ``trie`` in place; returns #new nodes created.

    Branch nodes are always fresh synonym nodes (never reused dictionary
    nodes): a teleport may only be reached by literally typing the variant,
    which enforces the paper's rule that generated text cannot participate
    in a subsequent rule application. Branches with a shared anchor and a
    shared lhs prefix share nodes (the knapsack "item interaction").
    """
    sel = expand_mask[rids]
    items = sorted(
        (int(a), rules[int(r)].lhs, int(t))
        for a, r, t in zip(anchors[sel], rids[sel], targets[sel])
    )
    new_parent: list[int] = []
    new_char: list[int] = []
    new_depth: list[int] = []
    syn_edges: dict[tuple[int, int], int] = {}
    tele: dict[int, list[int]] = {}
    next_id = trie.n_nodes
    n0 = next_id

    def depth_of(v: int) -> int:
        return int(trie.depth[v]) if v < n0 else new_depth[v - n0]

    for anchor, lhs, target in items:
        cur = anchor
        cur_depth = depth_of(anchor)
        for c in lhs:
            nxt = syn_edges.get((cur, c), -1)
            if nxt < 0:
                nxt = next_id
                next_id += 1
                new_parent.append(cur)
                new_char.append(c)
                new_depth.append(cur_depth + 1)
                syn_edges[(cur, c)] = nxt
            cur = nxt
            cur_depth += 1
        tele.setdefault(cur, []).append(target)

    n_new = next_id - n0
    if n_new:
        trie.parent = np.concatenate([trie.parent, np.array(new_parent, np.int32)])
        trie.chr_ = np.concatenate([trie.chr_, np.array(new_char, np.int32)])
        trie.depth = np.concatenate([trie.depth, np.array(new_depth, np.int32)])
        trie.max_score = np.concatenate([trie.max_score, np.zeros(n_new, np.int32)])
        trie.leaf_score = np.concatenate([trie.leaf_score, np.full(n_new, -1, np.int32)])
        trie.leaf_sid = np.concatenate([trie.leaf_sid, np.full(n_new, -1, np.int32)])
        trie.syn_mask = np.concatenate([trie.syn_mask, np.ones(n_new, bool)])
        trie.tout = np.concatenate(
            [trie.tout, np.arange(n0 + 1, next_id + 1, dtype=np.int32)])
        if trie.topk_score is not None:
            k = trie.topk_score.shape[1]
            trie.topk_score = np.concatenate(
                [trie.topk_score, np.full((n_new, k), -1, np.int32)])
            trie.topk_sid = np.concatenate(
                [trie.topk_sid, np.full((n_new, k), -1, np.int32)])
        trie.max_depth = int(trie.depth.max(initial=0))

    # teleports CSR (merge with any existing)
    n = trie.n_nodes
    old_nodes = np.repeat(np.arange(len(trie.syn_ptr) - 1, dtype=np.int32),
                          np.diff(trie.syn_ptr))
    old_tgt = trie.syn_tgt
    add_nodes = np.array([v for v, ts in tele.items() for _ in ts], np.int32)
    add_tgt = np.array([t for ts in tele.values() for t in ts], np.int32)
    nodes = np.concatenate([old_nodes, add_nodes])
    tgts = np.concatenate([old_tgt, add_tgt])
    # dedup (node, target)
    if len(nodes):
        key = nodes.astype(np.int64) * n + tgts
        _, uniq = np.unique(key, return_index=True)
        nodes, tgts = nodes[uniq], tgts[uniq]
    order = np.argsort(nodes, kind="stable")
    nodes, tgts = nodes[order], tgts[order]
    counts = np.bincount(nodes, minlength=n).astype(np.int32)
    trie.syn_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    trie.syn_tgt = tgts.astype(np.int32)
    trie.max_syn_targets = int(counts.max(initial=0))

    rebuild_edges(trie)
    return n_new


# ---------------------------------------------------------------------------
# Materialized per-node top-K cache (beyond-paper optimization, cf. Li[9])
# ---------------------------------------------------------------------------


def build_topk_cache(trie: DictTrie, k: int) -> None:
    """Bottom-up merge of per-node top-k dictionary leaves.

    A row is score-descending with its (-1, -1) slots last.  A parent row
    nothing has been written to yet is all (-1, -1), and merging a child
    into it gives the child's row unchanged, so that fold is a copy: most
    nodes of a large trie are unary, and only branching and terminal
    parents are sorted."""
    n = trie.n_nodes
    score = np.full((n, k), -1, dtype=np.int32)
    sid = np.full((n, k), -1, dtype=np.int32)
    term = trie.leaf_score >= 0
    score[term, 0] = trie.leaf_score[term]
    sid[term, 0] = trie.leaf_sid[term]
    written = term.copy()
    # whole rows as one element each: a copy moves 4*k bytes a row
    row = np.dtype((np.void, 4 * k))
    score_rows, sid_rows = score.view(row).ravel(), sid.view(row).ravel()

    order = np.argsort(trie.depth, kind="stable")
    max_d = int(trie.depth.max(initial=0))
    bounds = np.searchsorted(trie.depth[order], np.arange(max_d + 2))
    for d in range(max_d, 0, -1):
        ids = order[bounds[d] : bounds[d + 1]]
        if len(ids) == 0:
            continue
        ids = ids[~trie.syn_mask[ids]]
        if len(ids) == 0:
            continue
        par = trie.parent[ids]
        # merge children into parents slot-group by slot-group: group children
        # of the same parent and fold them in chunks
        o = np.argsort(par, kind="stable")
        ids, par = ids[o], par[o]
        grp_start = np.concatenate([[True], par[1:] != par[:-1]])
        slot = np.arange(len(ids)) - np.maximum.accumulate(
            np.where(grp_start, np.arange(len(ids)), 0))
        max_slot = int(slot.max(initial=0))
        for j in range(max_slot + 1):
            m = slot == j
            pj, cj = par[m], ids[m]
            bare = ~written[pj]   # a slot's parents are distinct
            written[pj] = True
            copy_p, copy_c = pj[bare], cj[bare]
            score_rows[copy_p] = score_rows[copy_c]
            sid_rows[copy_p] = sid_rows[copy_c]
            pj, cj = pj[~bare], cj[~bare]
            if len(pj) == 0:
                continue
            cat_score = np.concatenate([score[pj], score[cj]], axis=1)
            cat_sid = np.concatenate([sid[pj], sid[cj]], axis=1)
            top = np.argsort(-cat_score, axis=1, kind="stable")[:, :k]
            rows = np.arange(len(pj))[:, None]
            score[pj] = cat_score[rows, top]
            sid[pj] = cat_sid[rows, top]
    trie.topk_score = score
    trie.topk_sid = sid


# ---------------------------------------------------------------------------
# Compressed on-device layout (format v4, IndexSpec.compression="packed")
# ---------------------------------------------------------------------------


def _tier_u16(arr: np.ndarray) -> np.ndarray:
    """Narrowest dtype tier for a non-negative value table: u16 when every
    value fits, i32 otherwise (the device widens back to i32 in-register,
    so the choice is lossless either way)."""
    a = np.asarray(arr)
    if a.size == 0 or (int(a.min()) >= 0 and int(a.max()) <= 0xFFFF):
        return a.astype(np.uint16)
    return a.astype(np.int32)


def _csr_select(ptr: np.ndarray, rows: np.ndarray):
    """Compact the CSR rows ``rows`` (ascending) of a ``ptr``-indexed flat
    table: returns (new_ptr int32[len(rows)+1], take int64[...]) where
    ``take`` indexes the surviving entries of the flat arrays."""
    lo = ptr[rows].astype(np.int64)
    cnt = (ptr[rows + 1] - ptr[rows]).astype(np.int64)
    new_ptr = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    total = int(cnt.sum())
    take = np.repeat(lo, cnt) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(new_ptr[:-1].astype(np.int64), cnt))
    return new_ptr, take


def pack_compressed(trie: DictTrie) -> dict[str, str]:
    """Build the compressed on-device layout (persisted as format v4).

    Logical node ids are *unchanged* — loci, overflow counts and every
    downstream result stay bit-identical to the uncompressed layout.  The
    space comes from three sources:

    - **chain collapse**: dictionary nodes are created in DFS preorder,
      so a unary non-terminal node ``v`` has its single child at
      ``v + 1``, and its ``tout`` / ``max_score`` / emission list / top-K
      cache row are all equal to that child's (verified below, not
      assumed).  Per-node data is therefore stored only at *stored*
      nodes (fanout != 1, terminals, plus any verification stragglers);
      everything else derives from the next stored id — one binary
      search over ``c_ids``.  The only dense [N] arrays left are the u8
      ``p_labels`` / ``p_flags``.
    - **empty-plane elision**: teleports and link anchors become sparse
      id-keyed tables (``t_ids``/``t_plane``, ``la_ids``/``la_ptr``)
      that vanish for rule-free tries instead of dense [N]-row planes.
    - **narrow dtype tiers**: labels/flags/chars are u8; scores, string
      ids and the quantized top-K cache drop to u16 when every value
      fits (cache scores as ``base + enc - 1`` with a per-row i32 base,
      ``enc == 0`` meaning empty — lossless by the tier condition).

    Returns the ``{table: dtype}`` width map for the tier-variable tables
    (recorded as ``EngineConfig.table_widths`` so compiled entry points
    re-key when a rebuild lands in a different tier).  Requires
    ``pack_rule_planes`` (for ``link_ptr``).
    """
    assert trie.link_ptr is not None, \
        "pack_compressed requires pack_rule_planes to have run"
    n = trie.n_nodes
    ids = np.arange(n, dtype=np.int64)
    syn = trie.syn_mask
    leaf = trie.leaf_score >= 0
    d_cnt = np.diff(trie.first_child)
    s_cnt = np.diff(trie.s_first_child)

    # labels / flags: the two dense per-node arrays of the layout
    labels = trie.chr_.copy()
    labels[ROOT] = 0                  # no incoming edge; slot never read
    trie.p_labels = labels.astype(np.uint8)

    d_unary = d_cnt == 1
    if d_unary.any():
        first = trie.edge_child[trie.first_child[:-1][d_unary]]
        assert (first == ids[d_unary] + 1).all(), \
            "preorder invariant broken: unary dict child is not v+1"
    s_child0 = np.full(n, -1, np.int64)
    if len(trie.s_edge_child):
        has_s = s_cnt > 0
        s_child0[has_s] = trie.s_edge_child[trie.s_first_child[:-1][has_s]]
    s_unary = (s_cnt == 1) & (s_child0 == ids + 1)
    trie.p_flags = (
        d_unary.astype(np.uint8) * PACK_DICT_UNARY
        | s_unary.astype(np.uint8) * PACK_SYN_UNARY
        | syn.astype(np.uint8) * PACK_IS_SYN
        | leaf.astype(np.uint8) * PACK_HAS_LEAF)

    # stored (chain-representative) dict nodes.  An unstored node derives
    # every per-node value from the next stored id; the loop *verifies*
    # the chain-constancy invariants and promotes any node that breaks
    # them, so correctness never rests on the preorder argument alone.
    is_dict = ~syn
    stored = is_dict & (~d_unary | leaf)
    e_size = max(len(trie.emit_node), 1)
    while True:
        stored_ids = np.nonzero(stored)[0]
        u = ids[is_dict & ~stored]
        if len(u) == 0:
            break
        rep = stored_ids[np.searchsorted(stored_ids, u)]
        e0 = np.minimum(trie.emit_ptr[u].astype(np.int64), e_size - 1)
        ok = ((trie.tout[u] == trie.tout[rep])
              & (trie.max_score[u] == trie.max_score[rep])
              & ((trie.emit_ptr[u + 1] - trie.emit_ptr[u]) == 1)
              & (trie.emit_node[e0] == u + 1)
              & (trie.emit_score[e0] == trie.max_score[u])
              & ~trie.emit_is_leaf[e0])
        if trie.topk_score is not None:
            ok &= (trie.topk_score[u] == trie.topk_score[rep]).all(axis=1)
            ok &= (trie.topk_sid[u] == trie.topk_sid[rep]).all(axis=1)
        if ok.all():
            break
        stored[u[~ok]] = True

    c_ids = np.nonzero(stored)[0].astype(np.int64)
    trie.c_ids = c_ids.astype(np.int32)
    trie.c_tout = trie.tout[c_ids].astype(np.int32)
    trie.c_maxscore = _tier_u16(trie.max_score[c_ids])
    trie.c_eptr, take = _csr_select(trie.emit_ptr, c_ids)
    trie.c_enode = trie.emit_node[take].astype(np.int32)
    trie.c_escore = _tier_u16(trie.emit_score[take])
    trie.c_eleaf = trie.emit_is_leaf[take].astype(np.uint8)

    # dict branch rows (fanout >= 2) and non-unary syn rows as sparse CSRs
    b_ids = np.nonzero(d_cnt >= 2)[0]
    trie.b_ids = b_ids.astype(np.int32)
    trie.b_ptr, take = _csr_select(trie.first_child, b_ids)
    trie.b_char = trie.edge_char[take].astype(np.uint8)
    trie.b_child = trie.edge_child[take].astype(np.int32)
    sb_ids = np.nonzero((s_cnt >= 2) | ((s_cnt == 1) & ~s_unary))[0]
    trie.sb_ids = sb_ids.astype(np.int32)
    trie.sb_ptr, take = _csr_select(trie.s_first_child, sb_ids)
    trie.sb_char = trie.s_edge_char[take].astype(np.uint8)
    trie.sb_child = trie.s_edge_child[take].astype(np.int32)

    # terminal data: exact binary search over l_ids at query time
    l_ids = np.nonzero(leaf)[0]
    trie.l_ids = l_ids.astype(np.int32)
    trie.l_sid = _tier_u16(trie.leaf_sid[l_ids])

    # sparse teleport plane and link-anchor spans (empty-plane elision)
    t_ids = np.nonzero(np.diff(trie.syn_ptr) > 0)[0]
    trie.t_ids = t_ids.astype(np.int32)
    tw = max(trie.max_syn_targets, 1)
    t_ptr, take = _csr_select(trie.syn_ptr, t_ids)
    plane = np.full((len(t_ids), tw), -1, np.int32)
    if len(take):
        rows = np.repeat(np.arange(len(t_ids), dtype=np.int64),
                         np.diff(t_ptr))
        cols = np.arange(len(take), dtype=np.int64) - np.repeat(
            t_ptr[:-1].astype(np.int64), np.diff(t_ptr))
        plane[rows, cols] = trie.syn_tgt[take]
    trie.t_plane = plane
    la_ids = np.nonzero(np.diff(trie.link_ptr) > 0)[0]
    trie.la_ids = la_ids.astype(np.int32)
    trie.la_ptr = np.append(trie.link_ptr[la_ids],
                            trie.link_ptr[-1]).astype(np.int32)

    # quantized top-K cache: u16 (base + enc - 1, enc 0 = empty) when the
    # whole table fits the tier, raw i32 rows otherwise
    if trie.topk_score is not None:
        cs = trie.topk_score[c_ids]
        ci = trie.topk_sid[c_ids]
        real = cs >= 0
        row_min = np.where(real, cs, np.iinfo(np.int32).max).min(
            axis=1, initial=np.iinfo(np.int32).max)
        base = np.where(real.any(axis=1), row_min, 0).astype(np.int32)
        enc = np.where(real, cs.astype(np.int64) - base[:, None] + 1, 0)
        trie.pc_score = (enc.astype(np.uint16)
                         if enc.size == 0 or int(enc.max()) <= 0xFFFF
                         else cs.astype(np.int32))
        trie.pc_base = base
        enc_i = np.where(ci >= 0, ci.astype(np.int64) + 1, 0)
        trie.pc_sid = (enc_i.astype(np.uint16)
                       if enc_i.size == 0 or int(enc_i.max()) <= 0xFFFF
                       else ci.astype(np.int32))

    widths = {name: str(getattr(trie, name).dtype)
              for name in ("c_maxscore", "c_escore", "l_sid")}
    if trie.pc_score is not None:
        widths["pc_score"] = str(trie.pc_score.dtype)
        widths["pc_sid"] = str(trie.pc_sid.dtype)
    return widths
