"""Phase 1 — locus DP: a fixed-width frontier sweep over query positions.

reach[pos] = set of trie nodes reachable by consuming p[:pos] under some
rewriting.  Transitions: literal char step (dict + synonym-branch
children), synonym teleports (ET/HT expanded rules), and rule steps
through the link store (TT/HT unexpanded rules).  The plain PyTorch
counterpart of ``repro.core.engine.locus``, with the batch dimension
written out in place of ``vmap``: every function takes ``[B, ...]``
tensors and loops only over positions.

Bounded-edit mode (``cfg.edit_budget`` = E > 0): each frontier entry is
the int32 state ``node * (E + 1) + edits_used``, and the sweep gains
substitute (any other dict child at d+1), insert (stay put at d+1, not at
synonym nodes) and a delete closure (any dict child at d+1 without
consuming a character, E rounds).  Teleports and rule steps carry the
edit count through.  At E = 0 the encoding is the identity and every edit
transition vanishes.

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
from repro_torch.core.engine.structs import (INT_MAX, DeviceTrie,
                                             EngineConfig, NEG_ONE)

#: calls of :func:`locus_dp` (the plain version of the locus-DP kernel)
calls = 0


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


def check_state_range(t: DeviceTrie, cfg: EngineConfig) -> None:
    """Raise unless every state node*(E+1)+d fits int32 below the INT_MAX
    sentinel."""
    n_nodes = int((t.p_labels if pk.is_packed(t) else t.syn_mask).shape[0])
    if n_nodes * (cfg.edit_budget + 1) > INT_MAX:
        raise ValueError(
            f"edit_budget={cfg.edit_budget}: {n_nodes} nodes x "
            f"{cfg.edit_budget + 1} edit counts do not fit int32 states")


def encode_states(nodes: torch.Tensor, d, E: int) -> torch.Tensor:
    """Pack (node, edits used d) into one int32 frontier entry
    node*(E+1)+d.  The identity at E=0; -1 stays -1."""
    if E == 0:
        return nodes
    return torch.where(nodes < 0, NEG_ONE, nodes * (E + 1) + d).to(
        torch.int32)


def decode_states(states: torch.Tensor, E: int):
    """Inverse of :func:`encode_states`: (nodes, d); -1 -> (-1, 0)."""
    if E == 0:
        return states, torch.zeros_like(states)
    nodes = torch.where(states < 0, NEG_ONE, states // (E + 1))
    d = torch.where(states < 0, 0, states % (E + 1))
    return nodes.to(torch.int32), d.to(torch.int32)


def dict_child_window(t: DeviceTrie, cfg: EngineConfig,
                      nodes: torch.Tensor):
    """All dict children of each node: (chars, children) [..., BW] with
    BW = cfg.branch_width (the largest dict fanout), -1 padded.  Feeds the
    substitute and delete transitions, which take every child."""
    if pk.is_packed(t):
        return pk.dict_child_window(t, nodes, cfg.branch_width)
    BW = cfg.branch_width
    n_edges = int(t.edge_char.shape[0])
    if n_edges == 0:
        z = torch.full(tuple(nodes.shape) + (BW,), NEG_ONE,
                       dtype=torch.int32, device=nodes.device)
        return z, z
    valid = nodes >= 0
    n = torch.where(valid, nodes, 0).long()
    lo = t.first_child[n].long()
    cnt = torch.where(valid, t.first_child[n + 1].long() - lo, 0)
    js = torch.arange(BW, device=nodes.device)
    idx = (lo[..., None] + js).clamp(0, n_edges - 1)
    m = js < cnt[..., None]
    chars = torch.where(m, t.edge_char[idx], NEG_ONE).to(torch.int32)
    children = torch.where(m, t.edge_child[idx], NEG_ONE).to(torch.int32)
    return chars, children


def teleport_expand(t: DeviceTrie, cfg: EngineConfig, row: torch.Tensor):
    """row [B, F] -> row plus teleport targets, dedup'd back to [B, F].
    In bounded-edit mode the targets inherit the source's edit count."""
    if cfg.teleports == 0:
        return row, torch.zeros(row.shape[0], dtype=torch.int32,
                                device=row.device)
    B, F = row.shape
    E = cfg.edit_budget
    nodes, d = decode_states(row, E)
    valid = nodes >= 0
    if pk.is_packed(t):
        tgt = pk.tele_rows(t, nodes)
    else:
        tgt = t.tele_plane[torch.where(valid, nodes, 0).long()]
        tgt = torch.where(valid[..., None], tgt, NEG_ONE)
    tgt = encode_states(tgt, d[..., None], E)
    return dedup_pad(torch.cat([row, tgt.reshape(B, -1)], dim=1), F)


def delete_close(t: DeviceTrie, cfg: EngineConfig, row: torch.Tensor):
    """Bounded-edit delete closure: E rounds of "take any dict child at
    d+1 without consuming a query character", gated by d < E (each round
    raises d, so E rounds reach the fixpoint).  Nothing at E=0."""
    E = cfg.edit_budget
    B, F = row.shape
    drop_total = torch.zeros(B, dtype=torch.int32, device=row.device)
    for _ in range(E):
        nodes, d = decode_states(row, E)
        _, children = dict_child_window(t, cfg, nodes)
        ok = (children >= 0) & (d < E)[..., None]
        tgt = encode_states(torch.where(ok, children, NEG_ONE),
                            (d + 1)[..., None], E)
        row, drop = dedup_pad(torch.cat([row, tgt.reshape(B, -1)], dim=1), F)
        drop_total = drop_total + drop
    return row, drop_total


def expand_frontier(t: DeviceTrie, cfg: EngineConfig, row: torch.Tensor):
    """The fixpoint a completed row needs: the teleport expansion, then the
    delete closure (teleports attach only to synonym nodes and deletes
    only descend dict children, so one pass of each reaches it)."""
    row, drop = teleport_expand(t, cfg, row)
    row, drop2 = delete_close(t, cfg, row)
    return row, drop + drop2


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
    check_state_range(t, cfg)
    B, L = qs.shape
    F = cfg.frontier
    E = cfg.edit_budget
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
    buf[:, 0, 0] = 0    # the root at d=0 encodes to 0 for any E
    buf[:, 0], overflow = expand_frontier(t, cfg, buf[:, 0])

    for i in range(L):
        nodes, d = decode_states(buf[:, i], E)
        c = qs[:, i:i + 1]
        if packed:
            nd = pk.dict_children(t, nodes, c)
        else:
            nd = csr_child_lookup(t.first_child, t.edge_char, t.edge_child,
                                  nodes, c, d_iters)
        parts = [buf[:, i + 1], encode_states(nd, d, E)]
        if has_syn_edges:
            ns = (pk.syn_children(t, nodes, c) if packed else
                  csr_child_lookup(t.s_first_child, t.s_edge_char,
                                   t.s_edge_child, nodes, c, s_iters))
            parts.append(encode_states(ns, d, E))
        if E > 0:
            # substitute: any dict child whose edge char differs from c,
            # at d+1 (the matching child rides the literal part)
            wchars, wchildren = dict_child_window(t, cfg, nodes)
            can = (c >= 0) & (d < E)
            s_ok = can[..., None] & (wchildren >= 0) & (wchars != c[..., None])
            parts.append(encode_states(
                torch.where(s_ok, wchildren, NEG_ONE),
                (d + 1)[..., None], E).reshape(B, -1))
            # insert: the query has an extra char; stay put at d+1.
            # Synonym-branch chars are typed exactly, so mid-variant
            # nodes absorb no inserted char
            is_syn = _syn_mask(t, torch.where(nodes >= 0, nodes, 0).long())
            i_ok = can & (nodes >= 0) & ~is_syn
            parts.append(encode_states(torch.where(i_ok, nodes, NEG_ONE),
                                       d + 1, E))
        buf[:, i + 1], drop = dedup_pad(torch.cat(parts, dim=1), F)
        overflow = overflow + drop

        # rule steps through the link store (anchors must be dict nodes;
        # the lhs is typed exactly and the edit count carries through)
        if M > 0:
            anchor_ok = (nodes >= 0) & \
                ~_syn_mask(t, torch.where(nodes >= 0, nodes, 0).long())
            anchors = torch.where(anchor_ok, nodes, NEG_ONE)
            for m in range(M):
                rid = mrule[:, i, m]
                end = mend[:, i, m]
                tgt = link_lookup(t, anchors, rid)
                tgt = torch.where((rid >= 0)[:, None], tgt, NEG_ONE)
                tgt = encode_states(tgt, d, E)
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
    return (finalize_loci(t, decode_states(row, E)[0]),
            overflow.to(torch.int32))
