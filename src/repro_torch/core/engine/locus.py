"""Phase 1 — locus DP: a fixed-width frontier sweep over query positions.

reach[pos] = set of trie nodes reachable by consuming p[:pos] under some
rewriting.  Transitions: literal char step (dict + synonym-branch
children), synonym teleports (ET/HT expanded rules), and rule steps
through the link store (TT/HT unexpanded rules).  The plain PyTorch
counterpart of ``repro.core.engine.locus`` at ``edit_budget=0``, with the
batch dimension written out in place of ``vmap``: every function takes
``[B, ...]`` tensors and loops only over positions.

Overflow counts follow the reference merge for merge: each dedup that
drops unique ids past the frontier width adds the number dropped.

Every dictionary-side read goes through the dense tables or, on a packed
index, through the accessors of :mod:`~repro_torch.core.engine.packed`;
node ids are the same in both layouts, so are the loci and the counts.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.primitives import (csr_child_lookup, dedup_pad,
                                                iters_for, lower_bound)
from repro_torch.core.engine.structs import DeviceTrie, EngineConfig, NEG_ONE
from repro_torch.not_ported import not_ported

#: calls of :func:`locus_dp` (the plain version of the locus-DP kernel)
calls = 0


def _no_edits(cfg: EngineConfig) -> None:
    if cfg.edit_budget:
        raise not_ported("edits")


def _syn_mask(t: DeviceTrie, nodes: torch.Tensor) -> torch.Tensor:
    """bool syn mask of nodes (pre-clamped to >= 0), either layout."""
    return pk.syn_mask_of(t, nodes) if pk.is_packed(t) else t.syn_mask[nodes]


def _tout(t: DeviceTrie, nodes: torch.Tensor) -> torch.Tensor:
    """Preorder subtree end of nodes (pre-clamped to >= 0), either
    layout."""
    return pk.tout_of(t, nodes) if pk.is_packed(t) else t.tout[nodes]


def match_table(t: DeviceTrie, cfg: EngineConfig, qs: torch.Tensor):
    """All full-lhs rule matches per query position.

    qs int32[B, L] -> (rule[B, L, M], end[B, L, M]) with -1 padding;
    end = pos + len(lhs).  Slots fill in discovery order (lhs length
    ascending, then term-plane column)."""
    B, L = qs.shape
    M = cfg.rule_matches
    dev = qs.device
    if M == 0:
        z = torch.full((B, L, 1), NEG_ONE, dtype=torch.int32, device=dev)
        return z, z
    iters = iters_for(int(t.r_edge_char.shape[0]))
    qx = torch.cat([qs, torch.full((B, cfg.max_lhs_len), NEG_ONE,
                                   dtype=torch.int32, device=dev)], dim=1)
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    slots = torch.arange(M, dtype=torch.int32, device=dev)
    rules = torch.full((B, L, M), NEG_ONE, dtype=torch.int32, device=dev)
    ends = torch.full((B, L, M), NEG_ONE, dtype=torch.int32, device=dev)
    node = torch.zeros((B, L), dtype=torch.int32, device=dev)
    cnt = torch.zeros((B, L), dtype=torch.int32, device=dev)
    for j in range(cfg.max_lhs_len):
        c = qx[:, j:j + L]
        node = csr_child_lookup(t.r_first_child, t.r_edge_char,
                                t.r_edge_child, node, c, iters)
        ok = node >= 0
        terms = t.r_term_plane[torch.where(ok, node, 0).long()]
        for j2 in range(cfg.max_terms_per_node):
            rid = terms[..., j2]
            has = ok & (rid >= 0) & (cnt < M)
            put = has[..., None] & (slots == cnt[..., None])
            rules = torch.where(put, rid[..., None], rules)
            ends = torch.where(put, (pos + j + 1)[None, :, None], ends)
            cnt = torch.where(has, cnt + 1, cnt)
    return rules, ends


def teleport_expand(t: DeviceTrie, cfg: EngineConfig, row: torch.Tensor):
    """row [B, F] -> row plus teleport targets, dedup'd back to [B, F]."""
    if cfg.teleports == 0:
        return row, torch.zeros(row.shape[0], dtype=torch.int32,
                                device=row.device)
    B, F = row.shape
    valid = row >= 0
    if pk.is_packed(t):
        tgt = pk.tele_rows(t, row)
    else:
        tgt = t.tele_plane[torch.where(valid, row, 0).long()]
        tgt = torch.where(valid[..., None], tgt, NEG_ONE)
    return dedup_pad(torch.cat([row, tgt.reshape(B, -1)], dim=1), F)


def expand_frontier(t: DeviceTrie, cfg: EngineConfig, row: torch.Tensor):
    """The fixpoint a completed row needs: at edit_budget=0, the teleport
    expansion alone."""
    _no_edits(cfg)
    return teleport_expand(t, cfg, row)


def link_lookup(t: DeviceTrie, anchors: torch.Tensor, rid: torch.Tensor):
    """Link-store search: (anchor, rule) -> target or -1.  anchors [B, F],
    rid [B]."""
    if pk.is_packed(t):
        return pk.link_lookup(t, anchors, rid)
    n_link = int(t.link_rule.shape[0])
    if n_link == 0:
        return torch.full_like(anchors, NEG_ONE)
    valid = anchors >= 0
    a = torch.where(valid, anchors, 0).long()
    lo = t.link_ptr[a]
    hi = t.link_ptr[a + 1]
    r = rid[:, None]
    pos = lower_bound(t.link_rule, lo, hi, r, iters_for(n_link))
    posc = pos.clamp(0, n_link - 1)
    found = (pos < hi) & (t.link_rule[posc] == r) & valid
    return torch.where(found, t.link_target[posc], NEG_ONE).to(torch.int32)


def finalize_loci(t: DeviceTrie, row: torch.Tensor) -> torch.Tensor:
    """Turn expanded frontier rows [B, F] into locus antichains: drop
    mid-variant synonym nodes, dedup, and remove covered descendants."""
    F = row.shape[1]
    is_syn = _syn_mask(t, torch.where(row >= 0, row, 0).long())
    row = torch.where((row >= 0) & ~is_syn, row, NEG_ONE)
    row, _ = dedup_pad(row, F)
    live = row >= 0
    to = _tout(t, torch.where(live, row, 0).long())
    tin_i, tin_j = row[:, :, None], row[:, None, :]
    eye = torch.eye(F, dtype=torch.bool, device=row.device)
    covered = ((tin_j <= tin_i) & (tin_i < to[:, None, :]) & ~eye
               & live[:, None, :] & live[:, :, None]).any(dim=2)
    return torch.where(covered, NEG_ONE, row)


def locus_dp(t: DeviceTrie, cfg: EngineConfig, qs: torch.Tensor,
             qlens: torch.Tensor):
    """Locus sets after consuming each whole query under all rewritings.

    qs int32[B, L] (-1 padded), qlens int32[B].
    Returns (loci[B, F] dict-node ids, -1 padded; overflow[B] int32)."""
    global calls
    calls += 1
    _no_edits(cfg)
    B, L = qs.shape
    F = cfg.frontier
    M = cfg.rule_matches
    dev = qs.device
    packed = pk.is_packed(t)
    d_iters = iters_for(int(t.edge_char.shape[0]))
    s_iters = iters_for(int(t.s_edge_char.shape[0]))
    has_syn_edges = (pk.has_syn_edges(t) if packed
                     else int(t.s_edge_child.shape[0]) > 0)
    mrule, mend = match_table(t, cfg, qs)
    rows_b = torch.arange(B, device=dev)

    # write-back sweep: each completed row is expanded exactly once, as
    # the last write of the step that completes it
    buf = torch.full((B, L + 1, F), NEG_ONE, dtype=torch.int32, device=dev)
    buf[:, 0, 0] = 0
    buf[:, 0], overflow = expand_frontier(t, cfg, buf[:, 0])

    for i in range(L):
        nodes = buf[:, i]
        c = qs[:, i:i + 1]
        if packed:
            parts = [buf[:, i + 1], pk.dict_children(t, nodes, c)]
        else:
            parts = [buf[:, i + 1],
                     csr_child_lookup(t.first_child, t.edge_char,
                                      t.edge_child, nodes, c, d_iters)]
        if has_syn_edges:
            parts.append(pk.syn_children(t, nodes, c) if packed else
                         csr_child_lookup(t.s_first_child, t.s_edge_char,
                                          t.s_edge_child, nodes, c, s_iters))
        buf[:, i + 1], drop = dedup_pad(torch.cat(parts, dim=1), F)
        overflow = overflow + drop

        # rule steps through the link store (anchors must be dict nodes)
        if M > 0:
            anchor_ok = (nodes >= 0) & \
                ~_syn_mask(t, torch.where(nodes >= 0, nodes, 0).long())
            anchors = torch.where(anchor_ok, nodes, NEG_ONE)
            for m in range(M):
                rid = mrule[:, i, m]
                end = mend[:, i, m]
                tgt = link_lookup(t, anchors, rid)
                tgt = torch.where((rid >= 0)[:, None], tgt, NEG_ONE)
                j = torch.where(end >= 0, end, 0).clamp(0, L).long()
                dst = buf[rows_b, j]
                merged, drop = dedup_pad(torch.cat([dst, tgt], dim=1), F)
                any_tgt = (tgt >= 0).any(dim=1)
                buf[rows_b, j] = torch.where(any_tgt[:, None], merged, dst)
                overflow = overflow + torch.where(any_tgt, drop, 0)

        # write-back: row i+1 is complete (rule ends are > i), expand it
        buf[:, i + 1], drop = expand_frontier(t, cfg, buf[:, i + 1])
        overflow = overflow + drop

    row = buf[rows_b, qlens.clamp(0, L).long()]
    return finalize_loci(t, row), overflow.to(torch.int32)
