"""0/1 knapsack with item interactions (paper §6, Alg. 5) for HT construction.

Items are synonym rules; value = application frequency (number of links);
weight = synonym nodes created by expansion. Two rules *interact* when they
share an anchor node and their lhs strings share a prefix: their expansions
share branch nodes, so the marginal weight of one shrinks when the other is
already in the knapsack.

Paper-faithful pieces:
  - partition of rules into interaction groups (connected components),
  - branch & bound with a *tight upper bound* (fractional greedy over
    minimum weights, i.e. assuming every interaction is realized) and a
    *tight lower bound* (greedy over original weights, i.e. assuming no
    interaction is realized),
  - exact_weight in each branch via a scan restricted to the item's own
    partition (the paper's pairwise-min weight model).

The B&B is exact under the paper's pairwise weight model; the actual node
count of the final expansion is measured afterwards by `expand_synonyms`
(actual <= modeled, since per-anchor sharing can only help).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


@dataclass
class KnapsackItems:
    value: np.ndarray        # int64[R]  frequency
    w_orig: np.ndarray       # int64[R]  weight with no interactions
    w_min: np.ndarray        # int64[R]  weight with all interactions realized
    part: np.ndarray         # int32[R]  partition id
    pair_save: dict          # (i, j) -> nodes saved on i when j included


def analyze_rules(rules, anchors: np.ndarray, rids: np.ndarray) -> KnapsackItems:
    n_rules = len(rules)
    lhs = [r.lhs for r in rules]
    lens = np.array([len(s) for s in lhs], dtype=np.int64)

    # group anchors by rule and by anchor
    value = np.bincount(rids, minlength=n_rules).astype(np.int64)
    w_orig = value * lens

    # anchor -> rule set; interaction when two rules share an anchor and a
    # first character
    order = np.argsort(anchors, kind="stable")
    a_sorted, r_sorted = anchors[order], rids[order]
    starts = np.concatenate([[0], np.nonzero(np.diff(a_sorted))[0] + 1, [len(a_sorted)]])

    parent = np.arange(n_rules)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    # pairwise shared-anchor counts for interacting pairs
    pair_count: dict[tuple[int, int], int] = {}
    for s, e in zip(starts[:-1], starts[1:]):
        rs = np.unique(r_sorted[s:e])
        if len(rs) < 2:
            continue
        by_first: dict[int, list[int]] = {}
        for r in rs:
            by_first.setdefault(lhs[int(r)][0], []).append(int(r))
        for grp in by_first.values():
            for i in range(len(grp)):
                for j in range(i + 1, len(grp)):
                    a, b = grp[i], grp[j]
                    union(a, b)
                    pair_count[(a, b)] = pair_count.get((a, b), 0) + 1

    part = np.array([find(i) for i in range(n_rules)], dtype=np.int32)

    # per-pair savings and w_min
    pair_save: dict[tuple[int, int], int] = {}
    best_save = np.zeros(n_rules, dtype=np.int64)
    for (a, b), cnt in pair_count.items():
        cp = _common_prefix(lhs[a], lhs[b])
        if cp == 0:
            continue
        pair_save[(a, b)] = pair_save.get((a, b), 0) + cnt * cp
        pair_save[(b, a)] = pair_save.get((b, a), 0) + cnt * cp
    # aggregate identical pairs appearing from several anchors is handled by
    # cnt already; now best per rule
    for (a, _b), s in pair_save.items():
        best_save[a] = max(best_save[a], s)
    w_min = np.maximum(w_orig - best_save, 1)
    w_min = np.where(value > 0, w_min, 0)
    return KnapsackItems(value=value, w_orig=w_orig, w_min=w_min, part=part,
                         pair_save=pair_save)


def solve_knapsack(items: KnapsackItems, budget: int,
                   max_nodes: int = 200_000) -> np.ndarray:
    """Branch & bound; returns bool mask of included rules.

    Exact under the pairwise weight model unless the node cap fires, in
    which case the best incumbent found so far is returned (always valid).
    """
    n = len(items.value)
    usable = items.value > 0
    idx = np.nonzero(usable)[0]
    if len(idx) == 0 or budget <= 0:
        return np.zeros(n, dtype=bool)

    # order by density under minimum weights (tight-upper-bound ordering)
    dens = items.value[idx] / np.maximum(items.w_min[idx], 1)
    idx = idx[np.argsort(-dens, kind="stable")]
    m = len(idx)
    value = items.value[idx].astype(np.float64)
    w_min = items.w_min[idx].astype(np.float64)
    w_orig = items.w_orig[idx].astype(np.float64)
    pos_of = {int(r): p for p, r in enumerate(idx)}

    # suffix tables for bounds
    def upper_bound(p: int, cap: float) -> float:
        """Fractional greedy over minimum weights from position p."""
        total = 0.0
        for q in range(p, m):
            if w_min[q] <= cap:
                cap -= w_min[q]
                total += value[q]
            else:
                total += value[q] * (cap / max(w_min[q], 1e-9))
                break
        return total

    def greedy_value(p: int, cap: float, included: list[int]) -> tuple[float, list[int]]:
        """Integral greedy over exact weights (>= true optimum is not
        claimed; this is the lower bound / incumbent builder)."""
        total = 0.0
        inc = list(included)
        take: list[int] = []
        for q in range(p, m):
            w = exact_weight(q, inc)
            if w <= cap:
                cap -= w
                total += value[q]
                inc.append(q)
                take.append(q)
        return total, take

    def exact_weight(p: int, included: list[int]) -> float:
        """Paper's exact_weight: min over included items in same part of the
        pairwise-saved weight."""
        r = int(idx[p])
        w = w_orig[p]
        part = items.part[r]
        for q in included:
            r2 = int(idx[q])
            if items.part[r2] != part:
                continue
            s = items.pair_save.get((r, r2))
            if s:
                w = min(w, max(w_orig[p] - s, 1.0))
        return w

    best_val = -1.0
    best_set: list[int] = []

    # greedy incumbent first (ensures a feasible answer under the cap)
    v0, t0 = greedy_value(0, float(budget), [])
    best_val, best_set = v0, t0

    # DFS stack: (pos, cap, val, included tuple)
    stack = [(0, float(budget), 0.0, [])]
    explored = 0
    while stack and explored < max_nodes:
        pos, cap, val, inc = stack.pop()
        explored += 1
        if pos == m:
            if val > best_val:
                best_val, best_set = val, list(inc)
            continue
        if val + upper_bound(pos, cap) <= best_val:
            continue  # prune
        # lower bound improves incumbent opportunistically
        lbv, lbt = greedy_value(pos, cap, inc)
        if val + lbv > best_val:
            best_val, best_set = val + lbv, list(inc) + lbt
        # branch: exclude first so include is explored first (LIFO)
        stack.append((pos + 1, cap, val, inc))
        w = exact_weight(pos, inc)
        if w <= cap:
            stack.append((pos + 1, cap - w, val + value[pos], inc + [pos]))

    mask = np.zeros(n, dtype=bool)
    for p in best_set:
        mask[int(idx[p])] = True
    return mask
