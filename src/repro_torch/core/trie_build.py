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

A copy of ``repro.core.trie_build`` (the dense layout only): the arrays it
builds are bit-identical to the JAX package's, which keeps node ids — and
so every locus, overflow count and result — comparable across the two.
The compressed layout (``pack_compressed``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core.alphabet import SIGMA

ROOT = 0

# fields of the compressed layout; a container holding any of them was
# saved with compression="packed", which the port does not read yet
PACKED_ONLY_FIELDS = (
    "p_labels", "p_flags",
    "c_ids", "c_tout", "c_maxscore", "c_eptr", "c_enode", "c_escore",
    "c_eleaf",
    "b_ids", "b_ptr", "b_char", "b_child",
    "sb_ids", "sb_ptr", "sb_char", "sb_child",
    "l_ids", "l_sid", "t_ids", "t_plane", "la_ids", "la_ptr",
    "pc_score", "pc_base", "pc_sid",
)


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
    """Array-encoded dictionary trie (+ synonym structures), dense layout.

    Every field defaults to ``None`` so a container's arrays round-trip
    through ``DictTrie(**saved_arrays)``; builders populate them all.
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

    # static metadata
    max_depth: int = 0
    max_syn_targets: int = 0

    @property
    def n_nodes(self) -> int:
        return len(self.parent)

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
        order = np.lexsort((c, p))
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

    # emission lists: dictionary children (ranked by max_score) + own leaf
    ids = all_ids[is_child & ~trie.syn_mask]
    p = trie.parent[ids]
    order = np.lexsort((trie.chr_[ids], p))
    ids, p = ids[order], p[order]
    e_par = p
    e_node = ids
    e_score = trie.max_score[e_node]
    e_leaf = np.zeros(len(e_node), dtype=bool)
    term = np.nonzero(trie.leaf_score >= 0)[0].astype(np.int32)
    e_par = np.concatenate([e_par, term])
    e_node = np.concatenate([e_node, term])
    e_score = np.concatenate([e_score, trie.leaf_score[term]])
    e_leaf = np.concatenate([e_leaf, np.ones(len(term), dtype=bool)])
    order = np.lexsort((-e_score, e_par))
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
    """Bottom-up merge of per-node top-k dictionary leaves."""
    n = trie.n_nodes
    score = np.full((n, k), -1, dtype=np.int32)
    sid = np.full((n, k), -1, dtype=np.int32)
    term = trie.leaf_score >= 0
    score[term, 0] = trie.leaf_score[term]
    sid[term, 0] = trie.leaf_sid[term]

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
            cat_score = np.concatenate([score[pj], score[cj]], axis=1)
            cat_sid = np.concatenate([sid[pj], sid[cj]], axis=1)
            top = np.argsort(-cat_score, axis=1, kind="stable")[:, :k]
            rows = np.arange(len(pj))[:, None]
            score[pj] = cat_score[rows, top]
            sid[pj] = cat_sid[rows, top]
    trie.topk_score = score
    trie.topk_sid = sid
