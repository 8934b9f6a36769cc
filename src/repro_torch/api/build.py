"""Index construction: shared host-side pipeline + per-kind rule policies.

``build_index(strings, scores, rules, spec, device=None)`` runs Alg. 1 /
3 / 5 of the paper (array-encoded) on the host — build the dictionary
trie, find all rule links, ask the spec's registered builder which rules
to expand (ET side) vs keep in the link store (TT side), then materialize
edges, the rule trie, the per-node top-K cache (``cache_k``), the rule
planes and tiles, the compressed layout (``compression="packed"``) and
byte accounting — and moves the result to the device.  The arrays are
bit-identical to ``repro.api.build_index``'s.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.api.spec import (BuildContext, IndexSpec, get_builder,
                                  get_synthesizer, register_builder,
                                  register_rule_synthesizer)
from repro_torch.core import knapsack as ks
from repro_torch.core import trie_build as tb
from repro_torch.core.engine.structs import EngineConfig, resolve_device
from repro_torch.core.engine.substrate import resolve_substrate


@dataclass
class BuildStats:
    kind: str
    n_strings: int
    n_nodes: int
    n_syn_nodes: int
    n_links: int
    n_rules_expanded: int
    build_seconds: float
    bytes_total: int
    bytes_dict_nodes: int
    bytes_syn_nodes: int
    bytes_rule_side: int
    bytes_cache: int

    @property
    def bytes_per_string(self) -> float:
        return self.bytes_total / max(self.n_strings, 1)


# ---------------------------------------------------------------------------
# kind-specific rule partitioning (the pluggable part)
# ---------------------------------------------------------------------------


@register_builder("plain")
def _build_plain(ctx: BuildContext):
    n = len(ctx.rules)
    return np.zeros(n, bool), np.zeros(n, bool)


@register_builder("tt")
def _build_tt(ctx: BuildContext):
    n = len(ctx.rules)
    return np.zeros(n, bool), np.ones(n, bool)


@register_builder("et")
def _build_et(ctx: BuildContext):
    n = len(ctx.rules)
    return np.ones(n, bool), np.zeros(n, bool)


@register_builder("ht")
def _build_ht(ctx: BuildContext):
    items = ks.analyze_rules(ctx.rules, ctx.anchors, ctx.rids)
    s_et = int(items.w_orig.sum())  # node-count proxy for S_ET - S_TT
    budget = int(round(ctx.spec.alpha * s_et))
    expand_mask = ks.solve_knapsack(items, budget)
    return expand_mask, ~expand_mask


@register_builder("multiterm")
def _build_multiterm(ctx: BuildContext):
    # multi-term completion = ET-style expansion of the synthesized
    # token-skip rules (plus any user rules): every rule becomes synonym
    # branches with teleports, so a typed space fans out to the
    # gram-skipping targets through the ordinary teleport plane (the
    # synthesized rules all share the one-byte lhs b" ", which in the link
    # store would make every space position match every rule)
    n = len(ctx.rules)
    return np.ones(n, bool), np.zeros(n, bool)


def multiterm_rules(strings, gap: int, existing=()) -> list[tb.SynonymRule]:
    """Token-skip rules for multi-term completion.

    For every contiguous run of 1..``gap`` interior tokens ``G`` that
    appears between spaces in some dictionary string, emit the rule
    ``b" " -> b" " + G + b" "``: typing a space may skip those tokens, so
    the *last* typed token completes conditioned on an earlier-token
    context ("the t" -> "the new york times").  Grams are deduplicated
    corpus-wide and against ``existing`` rules (so re-building from an
    index's saved rule list does not double up).
    """
    seen = {(r.lhs, r.rhs) for r in existing}
    out: list[tb.SynonymRule] = []
    for s in strings:
        s = s.encode() if isinstance(s, str) else bytes(s)
        toks = [t for t in s.split(b" ") if t]
        # a gram must sit strictly between tokens: a space precedes it and
        # a completable token follows it
        for i in range(1, len(toks)):
            for n in range(1, gap + 1):
                if i + n > len(toks) - 1:
                    break
                gram = b" ".join(toks[i:i + n])
                key = (b" ", b" " + gram + b" ")
                if key not in seen:
                    seen.add(key)
                    out.append(tb.SynonymRule(*key))
    return out


@register_rule_synthesizer("multiterm")
def _synthesize_multiterm(spec: IndexSpec, strings, rules):
    return multiterm_rules(strings, spec.multiterm_gap, existing=rules)


# ---------------------------------------------------------------------------
# shared pipeline
# ---------------------------------------------------------------------------


def build_index(strings, scores, rules, spec: IndexSpec | None = None, *,
                device=None, **spec_kwargs):
    """Build a :class:`repro_torch.api.index.CompletionIndex` on ``device``
    (CUDA unless the caller passes another, e.g. ``device="cpu"``).

    Either pass a ready ``spec`` or IndexSpec keyword fields — not both.
    """
    from repro_torch.api.index import CompletionIndex

    if spec is None:
        spec = IndexSpec(**spec_kwargs)
    elif spec_kwargs:
        raise TypeError("pass either spec= or IndexSpec kwargs, not both")
    spec.validate()
    device = resolve_device(device)
    builder = get_builder(spec.kind)

    t0 = time.perf_counter()
    rules = list(rules)
    synthesizer = get_synthesizer(spec.kind)
    if synthesizer is not None:
        rules = rules + list(synthesizer(spec, strings, rules))
    trie, ss, sc = tb.build_dict_trie(strings, scores)
    anchors, rids, targets = tb.find_links(trie, rules)
    n_rules = len(rules)
    n_links = len(anchors)

    if n_rules == 0:
        expand_mask = np.zeros(0, dtype=bool)
        keep_links = np.zeros(0, dtype=bool)
    else:
        ctx = BuildContext(spec=spec, trie=trie, rules=rules,
                           anchors=anchors, rids=rids, targets=targets)
        expand_mask, keep_links = builder(ctx)
        expand_mask = np.asarray(expand_mask, dtype=bool)
        keep_links = np.asarray(keep_links, dtype=bool)

    n_syn = 0
    if expand_mask.any():
        n_syn = tb.expand_synonyms(trie, rules, anchors, rids, targets,
                                   expand_mask)
    else:
        tb.rebuild_edges(trie)

    link_sel = keep_links[rids] if n_links else np.zeros(0, bool)
    tb.set_link_store(trie, anchors[link_sel], rids[link_sel],
                      targets[link_sel])
    # rule trie holds only rules that still live on the rule side
    active = np.zeros(n_rules, dtype=bool)
    if n_links:
        active[np.unique(rids[link_sel])] = True
    rule_trie = tb.build_rule_trie(rules, active)

    if spec.cache_k > 0:
        tb.build_topk_cache(trie, spec.cache_k)
    tb.pack_rule_planes(trie, rule_trie)
    tb.pack_stream_tiles(trie, rule_trie)
    widths = tb.pack_compressed(trie) if spec.compression == "packed" else {}

    has_rule_side = bool(active.any())
    cfg = EngineConfig(
        frontier=spec.frontier, gens=spec.gens, expand=spec.expand,
        max_steps=spec.max_steps,
        rule_matches=rule_trie.max_matches_per_pos if has_rule_side else 0,
        max_lhs_len=rule_trie.max_lhs_len if has_rule_side else 0,
        max_terms_per_node=rule_trie.max_terms_per_node,
        teleports=trie.max_syn_targets,
        tele_width=trie.tele_plane.shape[1],
        term_width=rule_trie.term_plane.shape[1],
        edit_budget=spec.edit_budget,
        branch_width=max(int(np.diff(trie.first_child).max(initial=0)), 1),
        walk_tile=trie.walk_tile, emit_tile=trie.emit_tile,
        link_tile=trie.link_tile,
        use_cache=spec.cache_k > 0, cache_k=spec.cache_k,
        substrate=resolve_substrate(spec.substrate, device),
        memory_budget=spec.memory_budget,
        compression=spec.compression,
        table_widths=tuple(sorted(widths.items())),
    )
    validate_rule_planes(trie, rule_trie, cfg)
    stats = _make_stats(spec, trie, rule_trie, n_syn, link_sel, expand_mask,
                        len(ss), time.perf_counter() - t0)
    return CompletionIndex(spec, trie, rule_trie, rules, ss, sc, cfg, stats,
                           device=device)


def validate_rule_planes(trie, rule_trie, cfg) -> None:
    """Cross-check the rule plane, the tile-aligned layout and (packed)
    the compressed side tables against the static widths the engine was
    configured with.  Runs at build time and again when a container is
    loaded, so a stale or hand-edited container fails loudly instead of
    mis-gathering on device."""
    if (cfg.compression == "packed") != trie.has_packed:
        raise ValueError(
            f"compression mismatch: cfg says {cfg.compression!r} but the "
            f"trie {'carries' if trie.has_packed else 'lacks'} the packed "
            "layout; rebuild the index (or re-save the container)")
    if cfg.compression == "packed":
        validate_packed_layout(trie, cfg)
    if trie.tele_plane is None:
        # packed container with the dense planes elided: the rule trie is
        # kept whole, so its plane is still checked; everything dict-side
        # was covered by validate_packed_layout above
        want = (rule_trie.n_nodes, cfg.term_width)
        got = (None if rule_trie.term_plane is None
               else tuple(rule_trie.term_plane.shape))
        if got != want:
            raise ValueError(
                f"rule plane 'term_plane' has shape {got}, expected {want}; "
                "rebuild the index")
        return
    n = trie.n_nodes
    checks = [
        ("tele_plane", trie.tele_plane, (n, cfg.tele_width)),
        ("link_ptr", trie.link_ptr, (n + 1,)),
        ("term_plane", rule_trie.term_plane,
         (rule_trie.n_nodes, cfg.term_width)),
    ]
    for name, arr, want in checks:
        if arr is None or tuple(arr.shape) != want:
            got = None if arr is None else tuple(arr.shape)
            raise ValueError(
                f"rule plane {name!r} has shape {got}, expected {want}; "
                "rebuild the index (or re-save the container)")
    if cfg.tele_width != max(cfg.teleports, 1):
        raise ValueError(
            f"rule plane width mismatch: tele_width={cfg.tele_width} but "
            f"teleports={cfg.teleports}")
    if cfg.term_width != max(cfg.max_terms_per_node, 1):
        raise ValueError(
            f"rule plane width mismatch: term_width={cfg.term_width} but "
            f"max_terms_per_node={cfg.max_terms_per_node}")
    if int(trie.link_ptr[-1]) > len(trie.link_rule):
        raise ValueError("link_ptr does not cover the link store rows")
    validate_stream_tiles(trie, cfg)


def validate_stream_tiles(trie, cfg) -> None:
    """Cross-check the tile-aligned flat-table layout (every flat CSR /
    emission / link array padded to a tile multiple one tile past its real
    length) against the recorded tile widths."""
    groups = [
        ("walk_tile", cfg.walk_tile, trie.walk_tile,
         [(trie.first_child, trie.edge_char), (trie.first_child,
                                               trie.edge_child),
          (trie.s_first_child, trie.s_edge_char),
          (trie.s_first_child, trie.s_edge_child)]),
        ("emit_tile", cfg.emit_tile, trie.emit_tile,
         [(trie.emit_ptr, trie.emit_node), (trie.emit_ptr, trie.emit_score),
          (trie.emit_ptr, trie.emit_is_leaf)]),
        ("link_tile", cfg.link_tile, trie.link_tile,
         [(trie.link_ptr, trie.link_rule), (trie.link_ptr,
                                            trie.link_target)]),
    ]
    for name, want, got, pairs in groups:
        if want != got:
            raise ValueError(
                f"stream tile mismatch: cfg.{name}={want} but the trie "
                f"was packed with {got}; rebuild the index")
        for ptr, arr in pairs:
            real = int(ptr[-1])
            if int(np.diff(ptr).max(initial=0)) > want:
                raise ValueError(
                    f"stream tile {name}={want} narrower than the longest "
                    "CSR row; rebuild the index")
            expect = 0 if real == 0 else tb._tiled_len(real, want)
            if len(arr) != expect:
                raise ValueError(
                    f"stream layout under {name} has flat length "
                    f"{len(arr)}, expected {expect} for {real} rows; "
                    "rebuild the index")


def validate_packed_layout(trie, cfg) -> None:
    """Cross-check the compressed layout's side tables and recorded dtype
    tiers.  A corrupt container (truncated table, non-monotone pointers)
    or one whose dtype tier disagrees with ``cfg.table_widths`` (the
    widths the kernels read them at) fails loudly here instead of mis-decoding on
    device.  Runs at build time and again on load."""
    if not trie.has_packed:
        raise ValueError(
            "compression='packed' but the trie has no packed layout; "
            "rebuild the index (or re-save the container)")
    n = trie.n_nodes
    if len(trie.p_labels) != n or len(trie.p_flags) != n:
        raise ValueError(
            f"packed label/flag planes cover {len(trie.p_labels)} nodes, "
            f"expected {n}")
    groups = [
        ("c", trie.c_ids, trie.c_eptr,
         [trie.c_enode, trie.c_escore, trie.c_eleaf],
         [trie.c_tout, trie.c_maxscore]),
        ("b", trie.b_ids, trie.b_ptr, [trie.b_char, trie.b_child], []),
        ("sb", trie.sb_ids, trie.sb_ptr, [trie.sb_char, trie.sb_child], []),
        ("la", trie.la_ids, trie.la_ptr, [], []),
    ]
    for name, ids, ptr, rows, sides in groups:
        if len(ptr) != len(ids) + 1:
            raise ValueError(
                f"packed table {name!r}: pointer length {len(ptr)} does "
                f"not fit {len(ids)} ids")
        if len(ids) and not (np.diff(ids.astype(np.int64)) > 0).all():
            raise ValueError(f"packed table {name!r}: ids not sorted")
        if len(ptr) and (np.diff(ptr.astype(np.int64)) < 0).any():
            raise ValueError(f"packed table {name!r}: pointers not "
                             "monotone")
        for arr in rows:
            if len(arr) != (int(ptr[-1]) if len(ptr) else 0):
                raise ValueError(
                    f"packed table {name!r}: flat rows length {len(arr)} "
                    f"!= pointer total {int(ptr[-1]) if len(ptr) else 0}")
        for arr in sides:
            if len(arr) != len(ids):
                raise ValueError(
                    f"packed table {name!r}: side column length "
                    f"{len(arr)} != {len(ids)} ids")
    if tuple(trie.t_plane.shape) != (len(trie.t_ids), cfg.tele_width):
        raise ValueError(
            f"packed teleport plane has shape {tuple(trie.t_plane.shape)}, "
            f"expected ({len(trie.t_ids)}, {cfg.tele_width})")
    if len(trie.la_ptr) and trie.link_rule is not None and \
            int(trie.la_ptr[-1]) > len(trie.link_rule):
        raise ValueError("packed link spans exceed the link store rows")
    if len(trie.l_ids) != len(trie.l_sid):
        raise ValueError("packed terminal table column lengths differ")
    widths = dict(cfg.table_widths)
    tiered = ["c_maxscore", "c_escore", "l_sid"]
    if cfg.use_cache:
        tiered += ["pc_score", "pc_sid"]
        want = (len(trie.c_ids), cfg.cache_k)
        for name in ("pc_score", "pc_sid"):
            arr = getattr(trie, name)
            if arr is None or tuple(arr.shape) != want:
                raise ValueError(
                    f"packed cache plane {name!r} has shape "
                    f"{None if arr is None else tuple(arr.shape)}, "
                    f"expected {want}")
        if len(trie.pc_base) != len(trie.c_ids):
            raise ValueError("packed cache base column length mismatch")
    for name in tiered:
        arr = getattr(trie, name)
        if name not in widths:
            raise ValueError(
                f"packed table {name!r} missing from the recorded dtype "
                "tiers (cfg.table_widths)")
        if arr is None or str(arr.dtype) != widths[name]:
            got = None if arr is None else str(arr.dtype)
            raise ValueError(
                f"packed table {name!r} width mismatch: stored dtype "
                f"{got} but cfg.table_widths records {widths[name]!r}; "
                "rebuild the index (or re-save the container)")


def _make_stats(spec, trie, rule_trie, n_syn, link_sel, expand_mask,
                n_strings, seconds) -> BuildStats:
    """Byte accounting (paper Table 2 / Fig. 5 breakdown)."""
    n_nodes = trie.n_nodes
    node_bytes = sum(getattr(trie, n).nbytes for n in (
        "parent", "depth", "chr_", "max_score", "leaf_score", "leaf_sid",
        "syn_mask", "tout"))
    edge_bytes = sum(getattr(trie, n).nbytes for n in (
        "first_child", "edge_char", "edge_child", "emit_ptr", "emit_node",
        "emit_score", "emit_is_leaf"))
    syn_edge_bytes = sum(getattr(trie, n).nbytes for n in (
        "s_first_child", "s_edge_char", "s_edge_child", "syn_ptr",
        "syn_tgt", "tele_plane"))
    link_bytes = sum(getattr(trie, n).nbytes for n in (
        "link_anchor", "link_rule", "link_target", "link_ptr"))
    cache_bytes = (trie.topk_score.nbytes + trie.topk_sid.nbytes
                   if trie.topk_score is not None else 0)
    syn_frac = n_syn / max(n_nodes, 1)
    if trie.has_packed:
        # what actually ships to the device is the packed layout + the
        # (kept) link store + rule trie — account those, not the host-side
        # build intermediates
        cache_bytes = sum(
            getattr(trie, f).nbytes for f in ("pc_score", "pc_base",
                                              "pc_sid")
            if getattr(trie, f) is not None)
        link_bytes = sum(
            getattr(trie, f).nbytes for f in ("link_rule", "link_target",
                                              "la_ids", "la_ptr"))
        node_edge = trie.packed_nbytes(include_cache=False) - link_bytes
        return BuildStats(
            kind=spec.kind, n_strings=n_strings, n_nodes=n_nodes,
            n_syn_nodes=n_syn,
            n_links=int(link_sel.sum()) if len(link_sel) else 0,
            n_rules_expanded=int(expand_mask.sum()),
            build_seconds=seconds,
            bytes_total=trie.packed_nbytes() + rule_trie.nbytes(),
            bytes_dict_nodes=int(node_edge * (1 - syn_frac)),
            bytes_syn_nodes=int(node_edge * syn_frac),
            bytes_rule_side=link_bytes + rule_trie.nbytes(),
            bytes_cache=cache_bytes,
        )
    return BuildStats(
        kind=spec.kind, n_strings=n_strings, n_nodes=n_nodes,
        n_syn_nodes=n_syn,
        n_links=int(link_sel.sum()) if len(link_sel) else 0,
        n_rules_expanded=int(expand_mask.sum()),
        build_seconds=seconds,
        bytes_total=node_bytes + edge_bytes + syn_edge_bytes + link_bytes
        + rule_trie.nbytes() + cache_bytes,
        bytes_dict_nodes=int((node_bytes + edge_bytes) * (1 - syn_frac)),
        bytes_syn_nodes=int((node_bytes + edge_bytes) * syn_frac)
        + syn_edge_bytes,
        bytes_rule_side=link_bytes + rule_trie.nbytes(),
        bytes_cache=cache_bytes,
    )


def derived_stats(stats: BuildStats, trie, rule_trie) -> BuildStats:
    """The BuildStats of an index whose host trie a later build step
    changed (the top-K cache, the compressed layout) after the build that
    gave ``stats``: the counts and seconds carry over, the byte accounting
    is redone for ``trie``."""
    return _make_stats(IndexSpec(kind=stats.kind), trie, rule_trie,
                       stats.n_syn_nodes, np.ones(stats.n_links, bool),
                       np.ones(stats.n_rules_expanded, bool),
                       stats.n_strings, stats.build_seconds)
