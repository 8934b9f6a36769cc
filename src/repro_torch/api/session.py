"""Stateful incremental typing sessions.

A real autocomplete workload is per-keystroke: each query extends the
previous prefix by one char.  ``Session`` carries the engine's resumable
:class:`~repro_torch.core.engine.LocusState` across keystrokes, so typing
``"Andy P"`` then ``"a"`` advances the existing locus frontier by one
char-step instead of re-running the whole locus DP over the prefix.

A state is kept per typed byte, so ``backspace()`` restores the previous
frontier without replay.  When the fixed-width frontier ever overflowed
(state inexact), or the index holds uncompacted mutations, top-k is
answered by the one-shot ``index.complete`` path, which widens the search
until exact and merges the overlay — the JAX package's contract, the same
on every substrate.  After a ``compact()`` or a ``reconfigure`` the
session migrates at its next keystroke by replaying its prefix.
"""

from __future__ import annotations

import torch


def resolve_topk(index, scores, sids, exact, prefix: bytes, k: int):
    """Decode a session's top-k (host arrays) into (score, string) pairs.

    When the result is inexact (frontier overflow or a failed beam bound)
    the widened one-shot ``index.complete`` path recovers exactness from
    the raw prefix — the one exactness contract of the sequential
    :class:`Session` and the scheduler's demux.  Pending mutations take
    the same route: the session's top-k sees only the base epoch's
    tables, so the overlay-merged one-shot path answers from the raw
    prefix until the next ``compact()``."""
    if getattr(index, "has_mutations", False) or not bool(exact):
        return index.complete([bytes(prefix)], k=k)[0]
    return index._decode_row(scores, sids)


def read_topk(scores, sids, exact):
    """A top-k result on the host in one device-to-host read (the one
    synchronisation of a keystroke): (scores[k], sids[k], exact)."""
    k = int(scores.shape[-1])
    flat = torch.cat([scores.reshape(-1).to(torch.int32),
                      sids.reshape(-1).to(torch.int32),
                      exact.reshape(-1).to(torch.int32)]).cpu().numpy()
    return flat[:k], flat[k:2 * k], bool(flat[2 * k])


class Session:
    """Per-user incremental completion session over a CompletionIndex."""

    def __init__(self, index, k: int = 10):
        self.index = index
        self.k = k
        self._init, self._advance, self._topk = index._session_fns(k)
        self._prefix = bytearray()
        self._states = [self._init()]
        self._epoch = index.epoch

    def _sync_epoch(self) -> None:
        """Migrate onto the index's current epoch.

        After a swap (``compact``) or a ``reconfigure`` the session fns
        hold closures over the previous epoch's tensors and config, so
        refetch them and re-derive the whole per-char state history by
        replaying the retained prefix."""
        if self._epoch == self.index.epoch:
            return
        self._init, self._advance, self._topk = \
            self.index._session_fns(self.k)
        states = [self._init()]
        for byte in self._prefix:
            states.append(self._advance(states[-1], byte))
        self._states = states
        self._epoch = self.index.epoch

    # -- typing ------------------------------------------------------------

    @property
    def prefix(self) -> str:
        return bytes(self._prefix).decode("utf-8", errors="replace")

    def type(self, text: str | bytes) -> list[tuple[int, str]]:
        """Append keystrokes and return the top-k for the new prefix."""
        self._sync_epoch()
        data = text.encode() if isinstance(text, str) else bytes(text)
        for byte in data:
            self._states.append(self._advance(self._states[-1], byte))
            self._prefix.append(byte)
        return self.topk()

    def backspace(self, n: int = 1) -> list[tuple[int, str]]:
        """Remove the last ``n`` *characters* (restores the saved
        frontier).

        The prefix holds one engine state per byte, but a backspace
        removes a codepoint: each character removed pops its whole UTF-8
        byte run — a continuation byte is ``0b10xxxxxx``, so scanning back
        over them finds the head."""
        self._sync_epoch()
        nbytes = 0
        for _ in range(n):
            if nbytes >= len(self._prefix):
                break
            # skip the character's continuation bytes, then its head
            while nbytes < len(self._prefix) - 1 and \
                    0x80 <= self._prefix[len(self._prefix) - 1 - nbytes] \
                    < 0xC0:
                nbytes += 1
            nbytes += 1
        if nbytes:
            del self._states[len(self._states) - nbytes:]
            del self._prefix[len(self._prefix) - nbytes:]
        return self.topk()

    def reset(self) -> None:
        del self._states[1:]
        self._prefix.clear()

    # -- lookup ------------------------------------------------------------

    def topk(self, k: int | None = None) -> list[tuple[int, str]]:
        """Top-k (score, suggestion) pairs for the current prefix."""
        if k is not None and k != self.k:
            # another k: the session's phase 2 is set up for self.k
            return self.index.complete([bytes(self._prefix)], k=k)[0]
        self._sync_epoch()
        scores, sids, exact = read_topk(*self._topk(self._states[-1]))
        return resolve_topk(self.index, scores, sids, exact,
                            bytes(self._prefix), self.k)
