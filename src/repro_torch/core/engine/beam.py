"""Phase 2a — beam top-k (paper-faithful priority search), batched.

Each locus becomes a lazy generator over its score-sorted emission list;
every step pops the best P emissions across all generators and re-arms
them.  The plain PyTorch counterpart of ``repro.core.engine.beam`` with the
batch dimension written out: the reference's per-query ``while_loop``
becomes one loop whose every state write is masked by the per-query
continuation condition, ending when no query is active — each row stops
exactly where the reference's loop would stop it.

Every ``lax.top_k`` is one sort on the int64 key
``(INT_MAX - value) << 31 | column``: descending value, ties to the lower
column, which is ``lax.top_k``'s order.

Exactness uses the strict admissible bound: only a dropped candidate whose
bound strictly exceeds the final k-th score can have displaced a result.

Emissions are read from the dense emission store or, on a packed index,
through :mod:`~repro_torch.core.engine.packed` (an unstored chain node
derives its single emission); the search itself is one code.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.structs import (DeviceTrie, EngineConfig,
                                             INT_MAX, NEG_ONE)

#: calls of :func:`beam_topk` (the plain version of the beam kernel)
calls = 0


def topk_order(vals: torch.Tensor) -> torch.Tensor:
    """Column order of ``vals [B, C]`` by value descending, ties to the
    lower column (``lax.top_k`` order); int64 [B, C]."""
    # values are >= -1, so INT_MAX - value < 2**31 + 1 and the shift by 31
    # (columns < 2**31) keeps the key inside a signed int64
    cols = torch.arange(vals.shape[1], dtype=torch.int64, device=vals.device)
    key = ((INT_MAX - vals.to(torch.int64)) << 31) | cols
    return torch.sort(key, dim=1).values & INT_MAX


def is_empty(t: DeviceTrie) -> bool:
    """An empty dictionary: no emissions anywhere, in either layout."""
    store = t.c_enode if pk.is_packed(t) else t.emit_node
    return int(store.shape[0]) == 0


def check_widths(cfg: EngineConfig, f: int, k: int) -> None:
    """The search's preconditions: the pool holds the seed antichain and
    a pop is no wider than the pool."""
    if f > cfg.gens or cfg.expand > cfg.gens or k < 1:
        raise ValueError(
            f"beam needs frontier <= gens and expand <= gens and k >= 1; "
            f"got frontier={f}, gens={cfg.gens}, expand={cfg.expand}, k={k}")


def beam_topk(t: DeviceTrie, cfg: EngineConfig, loci: torch.Tensor, k: int):
    """Top-k leaves under each locus antichain.

    loci int32[B, F] -> (scores[B, k], sids[B, k] int32, exact[B] bool);
    scores are -1 padded."""
    global calls
    calls += 1
    B, F = loci.shape
    W, P = cfg.gens, cfg.expand
    dev = loci.device
    check_widths(cfg, F, k)
    packed = pk.is_packed(t)
    if is_empty(t):   # empty dictionary
        return (torch.full((B, k), NEG_ONE, dtype=torch.int32, device=dev),
                torch.full((B, k), NEG_ONE, dtype=torch.int32, device=dev),
                torch.ones(B, dtype=torch.bool, device=dev))
    e_size = int(t.emit_node.shape[0])

    def emit_bound(nodes, cursors):
        if packed:
            return pk.emit_bound(t, nodes, cursors)
        valid = nodes >= 0
        n = torch.where(valid, nodes, 0).long()
        e = t.emit_ptr[n].long() + cursors
        ok = valid & (e < t.emit_ptr[n + 1])
        return torch.where(ok, t.emit_score[e.clamp(0, e_size - 1)], NEG_ONE)

    def pop(nodes, cursors):
        if packed:
            return pk.pop_emissions(t, nodes, cursors)
        e = (t.emit_ptr[nodes].long() + cursors).clamp(0, e_size - 1)
        return t.emit_node[e], t.emit_score[e], t.emit_is_leaf[e]

    def sid_of(nodes):
        return pk.leaf_sid_of(t, nodes) if packed else t.leaf_sid[nodes]

    gn = torch.full((B, W), NEG_ONE, dtype=torch.int32, device=dev)
    gn[:, :F] = loci
    gc = torch.zeros((B, W), dtype=torch.int64, device=dev)
    gb = emit_bound(gn, gc)
    gn = torch.where(gb >= 0, gn, NEG_ONE)
    ls = torch.full((B, k), NEG_ONE, dtype=torch.int32, device=dev)
    li = torch.full((B, k), NEG_ONE, dtype=torch.int32, device=dev)
    dropped = torch.full((B,), NEG_ONE, dtype=torch.int32, device=dev)

    def running(gb, ls):
        best = gb.max(dim=1).values
        return (best >= 0) & (ls[:, k - 1] < best)

    for _ in range(cfg.max_steps):
        active = running(gb, ls)
        if not bool(active.any()):
            break
        topi = topk_order(gb)[:, :P]
        topb = gb.gather(1, topi)
        sel_valid = topb >= 0
        sel_n = torch.where(sel_valid, gn.gather(1, topi), 0).long()
        em_node, em_score, em_leaf = pop(sel_n, gc.gather(1, topi))

        # leaves -> result buffer (incumbents sit at lower columns)
        leaf_ok = sel_valid & em_leaf
        new_ls = torch.where(leaf_ok, em_score, NEG_ONE)
        new_li = torch.where(
            leaf_ok, sid_of(torch.where(leaf_ok, em_node, 0).long()),
            NEG_ONE)
        cat_s = torch.cat([ls, new_ls], dim=1)
        cat_i = torch.cat([li, new_li], dim=1)
        order = topk_order(cat_s)[:, :k]
        ls2, li2 = cat_s.gather(1, order), cat_i.gather(1, order)

        # internal emissions -> new generators
        new_n = torch.where(sel_valid & ~em_leaf, em_node, NEG_ONE)
        new_c = torch.zeros((B, P), dtype=torch.int64, device=dev)
        new_b = emit_bound(new_n, new_c)
        new_n = torch.where(new_b >= 0, new_n, NEG_ONE)

        # advance the popped generators
        gc2 = gc.scatter_add(1, topi, sel_valid.to(torch.int64))
        gb2 = emit_bound(gn, gc2)
        gn2 = torch.where(gb2 >= 0, gn, NEG_ONE)

        # merge pools, keep top-W by bound; track the best dropped bound
        pool_n = torch.cat([gn2, new_n], dim=1)
        pool_c = torch.cat([gc2, new_c], dim=1)
        pool_b = torch.cat([gb2, new_b], dim=1)
        order = topk_order(pool_b)
        keep, drop = order[:, :W], order[:, W:]
        drop_best = pool_b.gather(1, drop).max(dim=1).values
        m = active[:, None]
        gn = torch.where(m, pool_n.gather(1, keep), gn)
        gc = torch.where(m, pool_c.gather(1, keep), gc)
        gb = torch.where(m, pool_b.gather(1, keep), gb)
        ls = torch.where(m, ls2, ls)
        li = torch.where(m, li2, li)
        dropped = torch.where(active, torch.maximum(dropped, drop_best),
                              dropped)

    finished = ~running(gb, ls)
    exact = (dropped <= ls[:, k - 1]) & finished
    return ls, li, exact
