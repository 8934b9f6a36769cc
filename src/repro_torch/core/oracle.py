"""Pure-Python oracle for Problem 1 (top-k completion with synonyms): the
port's copy of ``repro.core.oracle`` over the port's :class:`SynonymRule`.

Deliberately naive and independent of the array-trie engine: a dict-of-dicts
trie plus a (pos, node) DP over all rule rewritings of the query.  Used as
the ground truth in unit and hypothesis property tests.

Semantics implemented (exactly the paper's Problem 1):
  a dictionary string s matches query p iff some rewriting p' of p is a
  prefix of s, where a rewriting replaces zero or more non-overlapping
  occurrences of rule lhs in the *original* p by the rule's rhs (generated
  text never participates in a later application).

Bounded-edit extension (``edit_budget`` = e): up to e single-character
edits — substitutions, insertions into the query, deletions from the
query — may additionally be spent while consuming the literal (non-rule)
characters of the query.  Edits apply only on the dictionary side: rule
lhs occurrences must be typed exactly, and (in the array engine) synonym
branch characters must be typed exactly — which this oracle matches by
construction since its rule transitions are atomic.  e = 0 is exactly
the paper's semantics.
"""

from __future__ import annotations

from repro_torch.core.trie_build import SynonymRule


class OracleIndex:
    def __init__(self, strings, scores, rules: list[SynonymRule],
                 edit_budget: int = 0):
        self.strings = [s.encode() if isinstance(s, str) else bytes(s) for s in strings]
        self.scores = [int(x) for x in scores]
        # dedup, keep max score
        best: dict[bytes, int] = {}
        for s, r in zip(self.strings, self.scores):
            best[s] = max(best.get(s, r), r)
        self.items = sorted(best.items())
        self.rules = rules
        self.edit_budget = int(edit_budget)
        # trie: node = dict char -> node; terminals marked with key -1 -> idx
        self.root: dict = {}
        for idx, (s, _) in enumerate(self.items):
            node = self.root
            for c in s:
                node = node.setdefault(c, {})
            node[-1] = idx

    # -- helpers -----------------------------------------------------------
    def _walk(self, node: dict, seq: bytes):
        for c in seq:
            node = node.get(c)
            if node is None:
                return None
        return node

    def locus_nodes(self, p: bytes | str) -> list[dict]:
        """All trie nodes reachable by consuming the full query under some
        rewriting spending at most ``edit_budget`` edits (the DP over
        (pos, id(node), edits))."""
        if isinstance(p, str):
            p = p.encode()
        E = self.edit_budget
        # per position: insertion-ordered {(id(node), d) -> node}; smaller
        # d never hurts, so states are kept per (node, d) pair and the
        # final projection to nodes dedups
        reach: list[dict[tuple[int, int], dict]] = [
            {} for _ in range(len(p) + 1)]

        def add(pos: int, node: dict, d: int):
            reach[pos].setdefault((id(node), d), node)

        add(0, self.root, 0)
        for pos in range(len(p) + 1):
            # delete closure: consume a dictionary char without a query
            # char (iterate to fixpoint; each round raises d by one)
            frontier = list(reach[pos].items())
            while frontier:
                nxt_frontier = []
                for (_, d), node in frontier:
                    if d >= E:
                        continue
                    for c, child in node.items():
                        if c == -1:
                            continue
                        key = (id(child), d + 1)
                        if key not in reach[pos]:
                            add(pos, child, d + 1)
                            nxt_frontier.append((key, child))
                frontier = nxt_frontier
            if pos == len(p):
                break
            for (_, d), node in list(reach[pos].items()):
                # literal character
                nxt = node.get(p[pos])
                if nxt is not None:
                    add(pos + 1, nxt, d)
                if d < E:
                    # substitute: any other dictionary child
                    for c, child in node.items():
                        if c != -1 and c != p[pos]:
                            add(pos + 1, child, d + 1)
                    # insert: the query has an extra char; stay put
                    add(pos + 1, node, d + 1)
                # full-lhs rule applications starting at pos (lhs typed
                # exactly; the edit count carries through unchanged)
                for rule in self.rules:
                    L = len(rule.lhs)
                    if p[pos : pos + L] == rule.lhs:
                        tgt = self._walk(node, rule.rhs)
                        if tgt is not None:
                            add(pos + L, tgt, d)
        out: list[dict] = []
        seen: set[int] = set()
        for (nid, _), node in reach[len(p)].items():
            if nid not in seen:
                seen.add(nid)
                out.append(node)
        return out

    def _leaves(self, node: dict, out: set[int]):
        for c, child in node.items():
            if c == -1:
                out.add(child)
            else:
                self._leaves(child, out)

    def complete(self, p: bytes | str, k: int) -> list[tuple[int, bytes]]:
        """Top-k (score, string) pairs; score desc, string asc tiebreak."""
        matched: set[int] = set()
        for node in self.locus_nodes(p):
            self._leaves(node, matched)
        ranked = sorted(
            ((self.items[i][1], self.items[i][0]) for i in matched),
            key=lambda t: (-t[0], t[1]),
        )
        return ranked[:k]

    def topk_scores(self, p: bytes | str, k: int) -> list[int]:
        return [s for s, _ in self.complete(p, k)]

    def matches(self, p: bytes | str) -> set[bytes]:
        matched: set[int] = set()
        for node in self.locus_nodes(p):
            self._leaves(node, matched)
        return {self.items[i][0] for i in matched}
