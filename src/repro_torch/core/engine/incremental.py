"""Phase 1' — incremental locus DP (stateful per-keystroke sessions).

One keystroke extends the carried frontier by a single character step
instead of re-running the whole locus DP over the prefix.  The plain
PyTorch counterpart of ``repro.core.engine.incremental``, written batched
first: a :class:`LocusState` carries a leading lane dimension (rows
``[B, H, F]``), :func:`advance_loci_batch` steps every lane at once with
the batched helpers of :mod:`~repro_torch.core.engine.locus`, and the
single-state forms are its B=1 case (in place of ``jax.vmap`` and
``lax.scan``).  A lane whose character is negative is left as it was, by a
tensor mask.

The inner child lookups and the compaction thread through the substrate's
``csr_child_lookup`` / ``dedup_compact``; phase 2 of a session goes through
the substrate's batched phase 2, so on ``"cuda"`` a keystroke's top-k runs
on the same kernels as a batch.  Nothing in init or advance reads a tensor
back to the host: a keystroke's one synchronisation is the read of its
top-k.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.locus import (_syn_mask, decode_states,
                                           dict_child_window, encode_states,
                                           expand_frontier, finalize_loci,
                                           link_lookup)
from repro_torch.core.engine.primitives import iters_for, resolve_sub
from repro_torch.core.engine.structs import DeviceTrie, EngineConfig, NEG_ONE
from repro_torch.core.engine.substrate import topk_phase2_batch


class LocusState(NamedTuple):
    """Resumable locus-DP state after consuming some prefix.

    rows[0] is the teleport-expanded frontier for the full prefix; rows[j]
    (j < max_lhs_len) is the frontier j keystrokes ago — a synonym rule
    whose lhs ends at the newest char anchors at the frontier where the
    lhs *started*.  rnodes[j] is the rule-trie node for the walk over the
    last j+1 chars (-1 once the walk dies).  A batch of states carries a
    leading lane dimension on every field.
    """

    rows: torch.Tensor      # int32[(B,) H, F] frontier rows, newest first
    rnodes: torch.Tensor    # int32[(B,) H] rule-trie suffix walks
    overflow: torch.Tensor  # int32[(B,)] accumulated drops (0 => exact)
    length: torch.Tensor    # int32[(B,)] chars consumed


def _lane(state: LocusState) -> LocusState:
    return LocusState(*(x[None] for x in state))


def _unlane(state: LocusState) -> LocusState:
    return LocusState(*(x[0] for x in state))


def init_locus_batch(t: DeviceTrie, cfg: EngineConfig, batch: int,
                     sub=None) -> LocusState:
    """``batch`` empty-prefix sessions (every lane at the expanded root)."""
    F = cfg.frontier
    H = max(cfg.max_lhs_len, 1)
    dev = t.r_first_child.device
    row = torch.full((batch, F), NEG_ONE, dtype=torch.int32, device=dev)
    row[:, 0] = 0   # the root at d=0 encodes to 0 for any E
    row, drop = expand_frontier(t, cfg, row)
    rows = torch.full((batch, H, F), NEG_ONE, dtype=torch.int32, device=dev)
    rows[:, 0] = row
    return LocusState(
        rows=rows,
        rnodes=torch.full((batch, H), NEG_ONE, dtype=torch.int32, device=dev),
        overflow=drop.to(torch.int32),
        length=torch.zeros(batch, dtype=torch.int32, device=dev))


def advance_loci_batch(t: DeviceTrie, cfg: EngineConfig, states: LocusState,
                       chars, sub=None) -> LocusState:
    """One keystroke per lane: ``chars`` int32[B]; lanes with a negative
    char are left as they were.  Lanes never interact, so each equals
    :func:`advance_locus_state` on it alone.

    One step of ``locus_dp``: literal dict and synonym-branch children of
    the current frontier, the bounded-edit substitute and insert
    transitions, and link-store steps for every rule whose lhs ends
    exactly at the new char, anchored at the frontier where that lhs
    began."""
    sub = resolve_sub(cfg, sub)
    rows = states.rows
    B, H, F = rows.shape
    E = cfg.edit_budget
    c = torch.as_tensor(chars, dtype=torch.int32, device=rows.device)
    c = c.reshape(B)
    cc = c[:, None]
    nodes, d = decode_states(rows[:, 0], E)

    if pk.is_packed(t):
        parts = [encode_states(pk.dict_children(t, nodes, cc), d, E)]
        if pk.has_syn_edges(t):
            parts.append(encode_states(pk.syn_children(t, nodes, cc), d, E))
    else:
        d_iters = iters_for(int(t.edge_char.shape[0]))
        parts = [encode_states(
            sub.csr_child_lookup(t.first_child, t.edge_char, t.edge_child,
                                 nodes, cc, d_iters), d, E)]
        if int(t.s_edge_child.shape[0]) > 0:
            s_iters = iters_for(int(t.s_edge_char.shape[0]))
            parts.append(encode_states(
                sub.csr_child_lookup(t.s_first_child, t.s_edge_char,
                                     t.s_edge_child, nodes, cc, s_iters),
                d, E))
    if E > 0:
        # bounded-edit keystroke transitions (mirror locus_dp's step):
        # substitute into any non-matching dict child / insert in place,
        # both at d+1; the delete closure rides expand_frontier below
        wchars, wchildren = dict_child_window(t, cfg, nodes)
        can = (cc >= 0) & (d < E)
        s_ok = can[..., None] & (wchildren >= 0) & (wchars != cc[..., None])
        parts.append(encode_states(
            torch.where(s_ok, wchildren, NEG_ONE),
            (d + 1)[..., None], E).reshape(B, -1))
        is_syn = _syn_mask(t, torch.where(nodes >= 0, nodes, 0).long())
        i_ok = can & (nodes >= 0) & ~is_syn
        parts.append(encode_states(torch.where(i_ok, nodes, NEG_ONE),
                                   d + 1, E))

    rnodes = states.rnodes
    if cfg.rule_matches > 0 and cfg.max_lhs_len > 0:
        r_iters = iters_for(int(t.r_edge_char.shape[0]))
        starts = torch.cat([torch.zeros((B, 1), dtype=torch.int32,
                                        device=rows.device),
                            states.rnodes[:, :-1]], dim=1)
        rnodes = sub.csr_child_lookup(t.r_first_child, t.r_edge_char,
                                      t.r_edge_child, starts, cc, r_iters)
        for j in range(H):
            node = rnodes[:, j]
            ok = node >= 0
            terms = t.r_term_plane[torch.where(ok, node, 0).long()]
            # lhs of length j+1 anchors at the frontier j keystrokes back
            a_nodes, a_d = decode_states(rows[:, j], E)
            anchor_ok = a_nodes >= 0
            anchor_ok &= ~_syn_mask(t, torch.where(anchor_ok, a_nodes,
                                                   0).long())
            anchors = torch.where(anchor_ok, a_nodes, NEG_ONE)
            for j2 in range(cfg.max_terms_per_node):
                rid = terms[:, j2]
                has = ok & (rid >= 0)
                tgt = link_lookup(t, anchors, rid)
                parts.append(encode_states(
                    torch.where(has[:, None], tgt, NEG_ONE), a_d, E))

    merged, d1 = sub.dedup_compact(torch.cat(parts, dim=1), F)
    merged, d2 = expand_frontier(t, cfg, merged)
    new_rows = torch.cat([merged[:, None], rows[:, :-1]], dim=1)
    ok = c >= 0
    return LocusState(
        rows=torch.where(ok[:, None, None], new_rows, rows),
        rnodes=torch.where(ok[:, None], rnodes, states.rnodes),
        overflow=states.overflow + torch.where(ok, d1 + d2, 0),
        length=states.length + ok.to(torch.int32))


def init_locus_state(t: DeviceTrie, cfg: EngineConfig,
                     sub=None) -> LocusState:
    """State for the empty prefix (locus = expanded root)."""
    return _unlane(init_locus_batch(t, cfg, 1, sub))


def advance_locus_state(t: DeviceTrie, cfg: EngineConfig, state: LocusState,
                        c, sub=None) -> LocusState:
    """One keystroke: extend the frontier by char ``c`` (a Python int or a
    0-d tensor; a no-op when c < 0)."""
    dev = state.rows.device
    if isinstance(c, torch.Tensor):
        lane = c.to(device=dev, dtype=torch.int32).reshape(1)
    else:
        lane = torch.full((1,), int(c), dtype=torch.int32, device=dev)
    return _unlane(advance_loci_batch(t, cfg, _lane(state), lane, sub))


def advance_loci(t: DeviceTrie, cfg: EngineConfig, state: LocusState,
                 chars, sub=None) -> LocusState:
    """Extend the state by a fixed-shape char vector (-1 entries
    ignored)."""
    sub = resolve_sub(cfg, sub)
    for c in chars:
        state = advance_locus_state(t, cfg, state, c, sub)
    return state


def topk_from_loci_batch(t: DeviceTrie, cfg: EngineConfig,
                         states: LocusState, k: int, sub=None):
    """Top-k for every lane of a batch of states in one phase-2 launch:
    (scores[B, k], sids[B, k], exact[B])."""
    sub = resolve_sub(cfg, sub)
    loci = finalize_loci(t, decode_states(states.rows[:, 0],
                                          cfg.edit_budget)[0])
    scores, sids, exact = topk_phase2_batch(t, cfg, loci, k, sub)
    return scores, sids, exact & (states.overflow == 0)


def topk_from_loci(t: DeviceTrie, cfg: EngineConfig, state: LocusState,
                   k: int, sub=None):
    """Top-k for the prefix carried by ``state``: (scores[k], sids[k],
    exact[])."""
    scores, sids, exact = topk_from_loci_batch(t, cfg, _lane(state), k, sub)
    return scores[0], sids[0], exact[0]
