"""Delta overlay: mutation without rebuild for a completion index.

The base index is immutable (its device tables, caches and packed planes
are all derived from the whole sorted dictionary), so online
``insert``/``delete``/``update_score`` land in a :class:`DeltaOverlay`:

- ``added`` maps overlay strings to scores — brand-new strings *and*
  re-scored base strings (a re-score tombstones the base entry and
  carries the new score here, so the base tables never lie);
- ``tombstones`` holds base strings masked out of query results
  (deletions and the base half of every re-score).

At query time the index answers from the base's top-(k + D) (D bounds the
tombstones a result row can lose) plus the overlay's top-k — the overlay
is itself a small index built through the normal pipeline, so synonym
rules apply to mutated entries as to the rest — and fuses the two
candidate sets with :func:`merge_overlay_topk` through the substrate's
``topk_with_payload`` (on ``"cuda"`` the ``topk_select`` kernel).

**Global ranks.** Merged results equal a from-scratch rebuild bit for
bit, score-tie order included (score descending, string ascending; sids
are lexicographic ranks because the dictionary is stored sorted).
``refresh`` therefore gives every live string its *global rank*: the sid
it would have in the rebuilt index.  Candidates enter the select sorted
by grank, so its ties-toward-the-lower-column order reproduces the
rebuilt tie order, and the returned "sids" are rebuilt-index sids (they
decode against ``live``).

``refresh`` is O(N + overlay) on the host (vectorised over the base) and
runs once per mutation batch; folding the overlay away is
``CompletionIndex.compact``.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from repro_torch.core.engine.structs import INT_MAX


def merge_overlay_topk(scores: torch.Tensor, granks: torch.Tensor, k: int,
                       sub):
    """Select the global top-k from base + overlay candidate rows.

    scores int32[B, C] / granks int32[B, C]; invalid slots carry score -1
    and grank INT_MAX.  Rows are sorted ascending by grank (stable, as
    ``lax.sort`` on one key) so the substrate's ``topk_with_payload`` —
    which breaks score ties toward the lower column — lands ties on the
    lexicographically smaller string, the rebuilt index's order.  Returns
    (scores[B, k], granks[B, k])."""
    granks_sorted, order = torch.sort(granks, dim=1, stable=True)
    scores_sorted = scores.gather(1, order)
    return sub.topk_with_payload(scores_sorted, granks_sorted.contiguous(),
                                 k)


class DeltaOverlay:
    """Mutable side state over an immutable base index (see the module
    doc).

    The mutation entry points take the base's sorted string list: the
    overlay holds no reference to its index, so a compaction simply drops
    it.
    """

    def __init__(self):
        self.added: dict[bytes, int] = {}
        self.tombstones: set[bytes] = set()
        self.mutations = 0            # monotonic; dirties refreshed state
        # refresh() products (stale until the token matches)
        self._token = None
        self.index = None             # side index over `added`, or None
        self.live: list[bytes] = []   # sorted live strings == rebuilt dict
        self.base_dead = None         # bool[N]: base sid is tombstoned
        self.base_grank = None        # int32[N]: base sid -> global rank
        self.ov_grank = None          # int32[max(Nov,1)]: overlay sid -> rank

    # -- membership --------------------------------------------------------

    @property
    def active(self) -> bool:
        return bool(self.added or self.tombstones)

    @staticmethod
    def _base_sid(base_strings: list[bytes], s: bytes) -> int:
        i = bisect.bisect_left(base_strings, s)
        if i < len(base_strings) and base_strings[i] == s:
            return i
        return -1

    def is_live(self, base_strings: list[bytes], s: bytes) -> bool:
        return s in self.added or (
            s not in self.tombstones
            and self._base_sid(base_strings, s) >= 0)

    # -- mutations ---------------------------------------------------------

    def upsert(self, base_strings: list[bytes], s: bytes,
               score: int) -> None:
        """Insert or re-score: a base entry is tombstoned and carried
        here, a pure-overlay entry just changes score."""
        if self._base_sid(base_strings, s) >= 0:
            self.tombstones.add(s)
        self.added[s] = score
        self.mutations += 1

    def remove(self, base_strings: list[bytes], s: bytes) -> None:
        """Delete a live string; raises KeyError when it is not live."""
        in_overlay = s in self.added
        in_base = self._base_sid(base_strings, s) >= 0
        if not in_overlay and (not in_base or s in self.tombstones):
            raise KeyError(f"{s!r} is not in the index")
        if in_overlay:
            del self.added[s]
        if in_base:
            self.tombstones.add(s)
        self.mutations += 1

    # -- refreshed state ---------------------------------------------------

    def refresh(self, base) -> None:
        """(Re)build the side index and the rank tables for the current
        mutation set against ``base`` (a CompletionIndex).  Idempotent
        until the next mutation, spec change or epoch.

        Every added string that is also a base string is tombstoned
        there, so the live base strings and ``added`` are disjoint, and a
        live base string's global rank is its base sid, less the dead
        sids before it, plus the overlay strings below it."""
        token = (self.mutations, base.spec, base.epoch)
        if token == self._token:
            return
        base_strings = base.strings
        n = len(base_strings)
        dead = np.zeros(max(n, 1), dtype=bool)
        for s in self.tombstones:
            sid = self._base_sid(base_strings, s)
            if sid >= 0:
                dead[sid] = True
        ov_strings = sorted(self.added)
        # where each overlay string falls among the base strings
        pos = np.asarray([bisect.bisect_left(base_strings, s)
                          for s in ov_strings], dtype=np.int64)
        dead_before = np.concatenate([[0], np.cumsum(dead[:n])])
        base_grank = np.full(max(n, 1), INT_MAX, dtype=np.int32)
        sids = np.arange(n)
        ranks = (sids - dead_before[:n]
                 + np.searchsorted(pos, sids, side="right"))
        base_grank[:n] = np.where(dead[:n], INT_MAX, ranks)
        ov_grank = (np.arange(len(ov_strings)) + pos - dead_before[pos]
                    if ov_strings else np.asarray([INT_MAX]))
        live = sorted([s for s, d in zip(base_strings, dead[:n].tolist())
                       if not d] + ov_strings)
        if ov_strings:
            # built through the normal pipeline so synonym rules apply to
            # mutated entries too; the packed layout buys nothing on a
            # dictionary this small, so the side index stays full-width
            from repro_torch.api.build import build_index

            self.index = build_index(
                ov_strings, [self.added[s] for s in ov_strings],
                base.rules, base.spec.replace(compression="none"),
                device=base.device)
        else:
            self.index = None
        self.live = live
        self.base_dead = dead
        self.base_grank = base_grank
        self.ov_grank = np.asarray(ov_grank, dtype=np.int32)
        self._token = token
