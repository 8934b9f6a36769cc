"""Accessors for the compressed (packed) on-device layout (plain PyTorch).

The packed layout (:func:`repro_torch.core.trie_build.pack_compressed`)
keeps logical node ids unchanged and replaces the dense per-node arrays
with u8 labels/flags plus sparse side tables keyed by sorted node id.
Each accessor here mirrors one uncompressed engine read bit for bit — the
counterpart of ``repro.core.engine.packed``, with the batch dimension
written out:

- child lookup: a unary node's single child is ``v + 1`` (DFS preorder),
  read straight off the flag + label; branching rows binary-search
  ``b_ids``/``sb_ids`` and then the row, exactly like
  ``primitives.csr_child_lookup`` over the dense CSR;
- per-node data (``tout``, ``max_score``, emission lists, cache rows) of
  an unstored node equals its chain representative's — the first stored
  id at or after it, one ``lower_bound`` over ``c_ids`` (the CUDA merge
  reads it through :func:`rank_tree`, a search tree over ``c_ids``);
- narrow (u8/u16) values widen to int32 at the read (:func:`widen`), so
  every comparison and merge downstream sees the same int32 values as
  the uncompressed path.

The CUDA kernels read the same forms behind their table-accessor types
(``kernels/csrc/locus_dp.cu``, ``kernels/csrc/beam_topk.cu``,
``kernels/csrc/locus_merge.cu``).
"""

from __future__ import annotations

import torch

from repro_torch.core.engine.primitives import iters_for, lower_bound
from repro_torch.core.engine.structs import NEG_ONE

# p_flags bits (mirror trie_build.PACK_*)
DICT_UNARY = 1
SYN_UNARY = 2
IS_SYN = 4


def is_packed(t) -> bool:
    """True when the DeviceTrie carries the packed layout (the dense
    arrays are 0-size dummies then)."""
    return t.p_labels is not None and int(t.p_labels.shape[0]) > 0


def has_syn_edges(t) -> bool:
    """Synonym nodes exist iff teleports do (every expanded branch ends in
    one) or a non-unary syn row was stored."""
    return int(t.t_ids.shape[0]) > 0 or int(t.sb_child.shape[0]) > 0


def widen(table: torch.Tensor, idx) -> torch.Tensor:
    """``table[idx]`` as int32: the u8, u16 and i32 tiers widen at the
    read.  A u16 table is read through its int16 view (indexing works for
    that dtype on every device) and masked back to 0..65535."""
    if table.dtype == torch.uint16:
        return table.view(torch.int16)[idx].to(torch.int32) & 0xFFFF
    return table[idx].to(torch.int32)


def _rank(ids: torch.Tensor, nodes: torch.Tensor):
    """Position of each node in a sorted id table: (clipped rank int64,
    exact bool).  An empty table matches nothing.  The lower bound is one
    ``torch.searchsorted`` (the fixed-iteration ``lower_bound`` would
    launch a handful of kernels per halving)."""
    size = int(ids.shape[0])
    if size == 0:
        return (torch.zeros(nodes.shape, dtype=torch.int64,
                            device=nodes.device),
                torch.zeros(nodes.shape, dtype=torch.bool,
                            device=nodes.device))
    pos = torch.searchsorted(ids, nodes.to(ids.dtype).contiguous())
    rc = pos.clamp(0, size - 1)
    return rc, (pos < size) & (ids[rc] == nodes)


#: keys a node of :func:`rank_tree`: 64 bytes, four 16-byte loads
TREE_FANOUT = 16


def rank_tree_size(n: int) -> int:
    """Keys of :func:`rank_tree` over ``n`` ids."""
    size, keys = 0, n
    while keys > TREE_FANOUT:
        keys = -(-keys // TREE_FANOUT)
        size += TREE_FANOUT * -(-keys // TREE_FANOUT)
    return size


def rank_tree(ids: torch.Tensor) -> torch.Tensor:
    """A static 16-ary search tree over sorted int32 ``ids``, for the
    CUDA merge's chain-representative rank (``tables.cuh`` ``tree_rank``).

    Level m >= 1 holds ``ceil(n / 16**m)`` keys: key i is the largest id
    of window i (entries ``[16 i, 16 i + 16)``) of the level below (level
    0 being ``ids``), padded with INT_MAX to a multiple of 16.  Levels are
    added while the one below has more than 16 keys, and stored top level
    first, so the top level is one window.  A search reads one window a
    level: ~log16(n) dependent 64-byte reads, where a binary search over
    ``ids`` makes ~log2(n) dependent loads.  About n/15 keys; none for
    n <= 16."""
    levels = []
    below = ids
    while below.numel() > TREE_FANOUT:
        n = below.numel()
        keys = -(-n // TREE_FANOUT)
        last = torch.arange(keys, device=ids.device) * TREE_FANOUT + \
            (TREE_FANOUT - 1)
        level = torch.full((TREE_FANOUT * -(-keys // TREE_FANOUT),),
                           2**31 - 1, dtype=torch.int32, device=ids.device)
        level[:keys] = below[last.clamp(max=n - 1)]
        levels.append(level)
        below = level[:keys]
    if not levels:
        return torch.zeros(0, dtype=torch.int32, device=ids.device)
    return torch.cat(levels[::-1])


def _children(t, ids, ptr, chars, children, unary_bit, nodes, ch):
    """Shared unary-flag + sparse-row child lookup (dict and syn forms);
    the same semantics as ``csr_child_lookup`` over the dense CSR."""
    n_nodes = int(t.p_labels.shape[0])
    valid = nodes >= 0
    n = torch.where(valid, nodes, 0).long()
    fl = widen(t.p_flags, n)
    lbl = widen(t.p_labels, (n + 1).clamp(0, n_nodes - 1))
    ok_u = ((fl & unary_bit) != 0) & (lbl == ch) & valid & (ch >= 0)
    u_child = torch.where(ok_u, n + 1, NEG_ONE).to(torch.int32)
    if int(ids.shape[0]) == 0 or int(chars.shape[0]) == 0:
        return u_child
    rc, isrow = _rank(ids, n)
    lo = ptr[rc].long()
    hi = torch.where(isrow, ptr[rc + 1].long(), lo)
    n_chars = int(chars.shape[0])
    pos = lower_bound(chars, lo, hi, ch, iters_for(n_chars))
    posc = pos.clamp(0, n_chars - 1)
    found = (pos < hi) & (widen(chars, posc) == ch) & valid & (ch >= 0)
    row_child = torch.where(found, children[posc], NEG_ONE).to(torch.int32)
    return torch.where(isrow, row_child, u_child)


def dict_children(t, nodes, ch):
    return _children(t, t.b_ids, t.b_ptr, t.b_char, t.b_child, DICT_UNARY,
                     nodes, ch)


def syn_children(t, nodes, ch):
    return _children(t, t.sb_ids, t.sb_ptr, t.sb_char, t.sb_child,
                     SYN_UNARY, nodes, ch)


def dict_child_window(t, nodes, width: int):
    """All dict children of each node: (chars, children) [..., width],
    -1 padded — the packed mirror of the dense ``first_child`` row window
    that feeds the substitute and delete transitions.  A unary node's
    window is its single (label, v+1) pair in column 0; a branching node
    reads its ``b_*`` row, found by a rank lookup in ``b_ids``."""
    n_nodes = int(t.p_labels.shape[0])
    valid = nodes >= 0
    n = torch.where(valid, nodes, 0).long()
    fl = widen(t.p_flags, n)
    lbl = widen(t.p_labels, (n + 1).clamp(0, n_nodes - 1))
    js = torch.arange(width, device=nodes.device)
    u_ok = (((fl & DICT_UNARY) != 0) & valid)[..., None] & (js == 0)
    chars = torch.where(u_ok, lbl[..., None], NEG_ONE).to(torch.int32)
    children = torch.where(u_ok, (n + 1)[..., None], NEG_ONE).to(torch.int32)
    n_edges = int(t.b_char.shape[0])
    if int(t.b_ids.shape[0]) == 0 or n_edges == 0:
        return chars, children
    rc, isrow = _rank(t.b_ids, n)
    lo = t.b_ptr[rc].long()
    cnt = torch.where(isrow & valid, t.b_ptr[rc + 1].long() - lo, 0)
    idx = (lo[..., None] + js).clamp(0, n_edges - 1)
    m = js < cnt[..., None]
    chars = torch.where(m, widen(t.b_char, idx), chars)
    children = torch.where(m, t.b_child[idx].to(torch.int32), children)
    return chars, children


def tele_rows(t, nodes):
    """Teleport-target rows [..., tele_width]; all -1 for nodes without
    teleports and for -1 slots (== the dense ``tele_plane`` gather)."""
    tw = int(t.t_plane.shape[1])
    if int(t.t_ids.shape[0]) == 0:
        return torch.full(tuple(nodes.shape) + (tw,), NEG_ONE,
                          dtype=torch.int32, device=nodes.device)
    valid = nodes >= 0
    rc, exact = _rank(t.t_ids, torch.where(valid, nodes, 0))
    return torch.where((exact & valid)[..., None], t.t_plane[rc], NEG_ONE)


def syn_mask_of(t, nodes):
    """bool syn mask gather (callers pre-clamp nodes to >= 0)."""
    return (widen(t.p_flags, nodes.long()) & IS_SYN) != 0


def tout_of(t, nodes):
    """Preorder subtree end (callers pre-clamp nodes to >= 0).  Synonym
    nodes are their own chains (tout == v + 1); dict nodes read their
    chain representative's stored value."""
    rc, _ = _rank(t.c_ids, nodes)
    return torch.where(syn_mask_of(t, nodes), nodes + 1,
                       t.c_tout[rc]).to(torch.int32)


def link_lookup(t, anchors, rid):
    """(anchor, rule) -> target or -1 via the sparse anchor spans
    (``la_ids``/``la_ptr``).  anchors [B, F], rid [B]."""
    n_link = int(t.link_rule.shape[0])
    if n_link == 0 or int(t.la_ids.shape[0]) == 0:
        return torch.full_like(anchors, NEG_ONE)
    valid = anchors >= 0
    rc, isrow = _rank(t.la_ids, torch.where(valid, anchors, 0))
    lo = t.la_ptr[rc].long()
    hi = torch.where(isrow, t.la_ptr[rc + 1].long(), lo)
    r = rid[:, None]
    pos = lower_bound(t.link_rule, lo, hi, r, iters_for(n_link))
    posc = pos.clamp(0, n_link - 1)
    found = (pos < hi) & (t.link_rule[posc] == r) & valid
    return torch.where(found, t.link_target[posc], NEG_ONE).to(torch.int32)


# ---------------------------------------------------------------------------
# beam-phase emission accessors
# ---------------------------------------------------------------------------


def emit_bound(t, nodes, cursors):
    """Admissible bound of each generator's current emission.  Stored
    nodes read their compacted emission row; an unstored (unary
    non-terminal dict) node's list is exactly ``[(v+1, max_score, not
    leaf)]``, so cursor 0 yields the representative's ``max_score`` and
    anything past it is exhausted."""
    valid = nodes >= 0
    n = torch.where(valid, nodes, 0).long()
    rc, stored = _rank(t.c_ids, n)
    e = t.c_eptr[rc].long() + cursors
    e_size = max(int(t.c_enode.shape[0]), 1)
    ok_s = stored & (e < t.c_eptr[rc + 1])
    sc_s = widen(t.c_escore, e.clamp(0, e_size - 1))
    derived = ~stored & ~syn_mask_of(t, n) & (cursors == 0)
    ms = widen(t.c_maxscore, rc)
    bound = torch.where(ok_s, sc_s, torch.where(derived, ms, NEG_ONE))
    return torch.where(valid, bound, NEG_ONE)


def pop_emissions(t, nodes, cursors):
    """(node, score, is_leaf) of each generator's current emission
    (callers mask invalid lanes; a popped lane's cursor is in-row)."""
    nodes = nodes.long()
    rc, stored = _rank(t.c_ids, nodes)
    e_size = max(int(t.c_enode.shape[0]), 1)
    e = (t.c_eptr[rc].long() + cursors).clamp(0, e_size - 1)
    node = torch.where(stored, t.c_enode[e].long(), nodes + 1)
    score = torch.where(stored, widen(t.c_escore, e),
                        widen(t.c_maxscore, rc))
    leaf = stored & (t.c_eleaf[e] != 0)
    return node.to(torch.int32), score, leaf


def leaf_sid_of(t, nodes):
    """String id of terminal nodes via exact search over ``l_ids``
    (callers only use lanes where the node is a real leaf)."""
    if int(t.l_ids.shape[0]) == 0:
        return torch.full(nodes.shape, NEG_ONE, dtype=torch.int32,
                          device=nodes.device)
    rc, _ = _rank(t.l_ids, nodes.long())
    return widen(t.l_sid, rc)


# ---------------------------------------------------------------------------
# cached-phase accessors
# ---------------------------------------------------------------------------


def gather_cached(t, loci):
    """Packed mirror of ``cached.gather_cached``: decode the quantized
    per-representative cache rows back to raw int32 scores/sids."""
    valid = loci >= 0
    rc, _ = _rank(t.c_ids, torch.where(valid, loci, 0).long())
    sc = decode_cache_scores(widen(t.pc_score, rc), t.pc_base[rc],
                             t.pc_score.dtype == torch.uint16)
    si = decode_cache_sids(widen(t.pc_sid, rc),
                           t.pc_sid.dtype == torch.uint16)
    sc = torch.where(valid[..., None], sc, NEG_ONE)
    si = torch.where(valid[..., None], si, NEG_ONE)
    flat = tuple(loci.shape[:-1]) + (-1,)
    return sc.reshape(flat), si.reshape(flat)


def decode_cache_scores(enc, base, u16: bool):
    """u16 rows hold ``score - base + 1`` (0 = empty slot); i32 rows are
    raw.  ``enc`` is already widened to int32."""
    if u16:
        return torch.where(enc == 0, NEG_ONE,
                           base[..., None] + enc - 1).to(torch.int32)
    return enc


def decode_cache_sids(enc, u16: bool):
    if u16:
        return torch.where(enc == 0, NEG_ONE, enc - 1).to(torch.int32)
    return enc
