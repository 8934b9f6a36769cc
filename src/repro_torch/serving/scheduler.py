"""Continuous-batching keystroke scheduler for the completion hot path.

Without it every keystroke of every session pays its own advance and its
own phase 2 — on the card, hundreds of eager launches a keystroke.  The
scheduler makes the serving layer the batcher:

- a :class:`KeystrokeScheduler` owns a fixed-shape *slab*: a
  :class:`~repro_torch.core.engine.LocusState` with ``block`` lanes.  Each
  open :class:`BatchSession` pins one lane;
- submitted keystrokes enter a bounded admission queue (per-lane FIFOs —
  a session's chars depend on each other, so one flush consumes at most
  one keystroke per lane but coalesces keystrokes *across* lanes);
- a *flush* takes one keystroke of each ready lane — chars[block] with
  ``-1`` for idle lanes and a reset mask, sent to the device as one small
  transfer — and runs one batched advance plus (when a consumed keystroke
  wants results) one batched phase 2 per distinct k, then demuxes scores
  and sids per lane.  The demux is pipelined one flush deep: a flush
  launches its own device work, packs each k-group's (scores, sids,
  exact) into one int32 tensor copied without blocking into a host buffer
  of its own (pinned, with a CUDA event recorded after the copy), and
  only then settles the *previous* flush — waiting on that flush's event
  before reading its buffer — so the host's decode overlaps the device's
  work.  Nothing in a flush's dispatch reads the device;
- flushes fire when every occupied lane has a keystroke queued (a *full*
  block), when the oldest queued keystroke would exceed its latency
  budget (``max_wait_ms`` — a *deadline* flush of a partial block), or on
  an explicit :meth:`~KeystrokeScheduler.drain`;
- the admission queue is bounded (``max_queue``): a submit beyond it
  raises :class:`SchedulerOverloaded`, so overload surfaces as
  backpressure at the edge instead of unbounded memory.

Per-lane results are bit-identical to replaying the same keystrokes
through a sequential :class:`repro_torch.api.session.Session`: lanes never
interact in the batched advance, the batched phase 2 is per row, and the
inexact-result (and pending-mutation) route goes through the same
one-shot path (:func:`repro_torch.api.session.resolve_topk`).

The scheduler is driven cooperatively (no background thread, so flush
order and latency accounting are deterministic): ``submit`` flushes full
blocks, ``pump()`` fires deadline flushes, and the blocking helpers
(``BatchSession.type``, ``Ticket.result``, ``drain``) flush until their
work resolves.  On a CPU index the same code runs on host tensors (no
pinned buffers, no events).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.api.session import resolve_topk


class SchedulerOverloaded(RuntimeError):
    """Backpressure: the admission queue (or lane table) is full."""


@dataclass
class Ticket:
    """One keystroke in flight through the batcher."""

    lane: int
    char: int                     # byte value; -1 = reset-only flush filler
    want_topk: bool
    k: int
    created: float
    prefix: bytes = b""           # lane prefix *after* this keystroke —
                                  # taken at submit because the session
                                  # may type further before the flush that
                                  # consumes this ticket lands
    reset_first: bool = False     # re-init the lane before the char step
    results: list | None = None   # (score, string) pairs once resolved
    done: bool = False
    latency_s: float | None = None

    def result(self, scheduler: "KeystrokeScheduler") -> list:
        """Block (cooperatively) until this keystroke's flush lands."""
        while not self.done:
            scheduler.flush()
        return self.results


@dataclass
class BatchStats:
    """Flush accounting for one scheduler."""

    n_keystrokes: int = 0
    n_flushes: int = 0
    full_flushes: int = 0          # every occupied lane advanced
    deadline_flushes: int = 0      # fired by the latency budget
    forced_flushes: int = 0        # drain()/result() forced a partial block
    rejected: int = 0              # submits refused by backpressure
    fallbacks: int = 0             # inexact lanes resolved via one-shot path
    sum_occupancy: int = 0         # lanes consumed across all flushes
    migrations: int = 0            # slab rebuilds onto a new index epoch

    @property
    def mean_occupancy(self) -> float:
        return self.sum_occupancy / max(self.n_flushes, 1)


class BatchSession:
    """One typing stream riding the scheduler's shared micro-batches.

    The ``type``/``backspace``/``reset``/``topk``/``prefix`` surface of
    :class:`repro_torch.api.session.Session`, plus the non-blocking
    ``submit`` that lets keystrokes of many sessions coalesce.
    """

    def __init__(self, scheduler: "KeystrokeScheduler", lane: int, k: int):
        self.scheduler = scheduler
        self.lane = lane
        self.k = k
        self._prefix = bytearray()
        self._reset_pending = False
        self._closed = False

    @property
    def prefix(self) -> str:
        return bytes(self._prefix).decode("utf-8", errors="replace")

    @property
    def prefix_bytes(self) -> bytes:
        return bytes(self._prefix)

    # -- non-blocking path -------------------------------------------------

    def submit(self, char: int | bytes | str, want_topk: bool = True
               ) -> Ticket:
        """Enqueue one keystroke; returns its :class:`Ticket`.

        Raises :class:`SchedulerOverloaded` when the admission queue is
        full — callers shed load or flush and retry."""
        if self._closed:
            raise RuntimeError("session is closed")
        if isinstance(char, str):
            char = char.encode()
        if isinstance(char, (bytes, bytearray)):
            if len(char) != 1:
                raise ValueError("submit takes exactly one keystroke")
            char = char[0]
        # change the session only after admission: a rejection leaves its
        # prefix and reset flag as they were
        prefix = bytes(self._prefix) + bytes([int(char)])
        ticket = self.scheduler._enqueue(
            self, int(char), want_topk, self._reset_pending, prefix)
        self._reset_pending = False
        self._prefix.append(int(char))
        return ticket

    # -- blocking Session-like surface -------------------------------------

    def type(self, text: str | bytes) -> list[tuple[int, str]]:
        """Feed keystrokes and return the top-k for the new prefix.

        Each char is one ticket (a session's chars ride consecutive
        flushes); the call blocks until the last one resolves."""
        data = text.encode() if isinstance(text, str) else bytes(text)
        if not data:
            return self.topk()
        tickets = [self.submit(bytes([b])) for b in data]
        return tickets[-1].result(self.scheduler)

    def topk(self, k: int | None = None) -> list[tuple[int, str]]:
        """Top-k for the current prefix (a reset-only or no-op flush when
        nothing is pending on this lane)."""
        if k is not None and k != self.k:
            return self.scheduler.index.complete(
                [bytes(self._prefix)], k=k)[0]
        ticket = self.scheduler._enqueue(self, -1, True,
                                         self._reset_pending,
                                         bytes(self._prefix))
        self._reset_pending = False
        return ticket.result(self.scheduler)

    def backspace(self, n: int = 1) -> list[tuple[int, str]]:
        """Remove the last ``n`` keystrokes.

        The slab holds only the newest frontier of a lane (no history —
        the memory price of packing sessions into a fixed slab), so a
        backspace replays the shortened prefix through the batch path."""
        kept = bytes(self._prefix[:max(len(self._prefix) - n, 0)])
        self.reset()
        if not kept:
            return self.topk()
        return self.type(kept)

    def reset(self) -> None:
        """Restart at the empty prefix.

        Free at submit time: the reset rides the next ticket's flush as a
        lane re-init mask applied in the same batched advance."""
        self._prefix.clear()
        self._reset_pending = True

    def close(self) -> None:
        """Release the lane back to the scheduler."""
        if not self._closed:
            self.scheduler._release(self)
            self._closed = True


class KeystrokeScheduler:
    """Admission queue + fixed-shape slab + micro-batch flush loop."""

    def __init__(self, index, *, block: int = 8, max_wait_ms: float = 2.0,
                 max_queue: int | None = None, on_keystroke=None,
                 clock=time.perf_counter):
        """index: a CompletionIndex (needs the slab entry points).
        block: lanes per slab = the batch of every flush = the most
            concurrent sessions.
        max_wait_ms: latency budget; a queued keystroke older than this
            triggers a partial-block deadline flush on the next
            submit/pump.
        max_queue: admission-queue bound across all lanes (default
            ``4 * block``); beyond it submits raise SchedulerOverloaded.
        on_keystroke: optional callable(latency_seconds) invoked per
            resolved result-bearing keystroke (the service's stats hook).
        clock: injectable monotonic clock (tests drive deadlines with a
            fake one)."""
        if block < 1:
            raise ValueError("block must be >= 1")
        self.index = index
        self.block = block
        self.max_wait_ms = max_wait_ms
        self.max_queue = 4 * block if max_queue is None else max_queue
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.on_keystroke = on_keystroke
        self.clock = clock
        self.stats = BatchStats()
        self._init_fn, self._advance_fn = index._slab_fns(block)
        self._slab = self._init_fn()
        self._topk_fns: dict[int, object] = {}   # k -> slab top-k
        # one stashed flush of un-demuxed results: [(k, tickets, (device
        # tensor, host buffer, event), dictionary)] — settled after the
        # NEXT flush's dispatch so the host's decode overlaps the device
        # (see _flush)
        self._unsettled: list | None = None
        self._lanes: list[BatchSession | None] = [None] * block
        self._queues: list[collections.deque[Ticket]] = [
            collections.deque() for _ in range(block)]
        self._draining = [False] * block
        # per-lane prefix as of the last *consumed* ticket (what the
        # slab's frontier encodes — the session's own _prefix runs ahead
        # of it by whatever is still queued); the replay source of an
        # epoch migration
        self._consumed: list[bytes] = [b""] * block
        self._epoch = index.epoch
        self._pending = 0
        # O(1) mirrors of _ready_lanes()/_occupied() for the per-submit
        # pump
        self._n_ready = 0
        self._n_occupied = 0

    # -- sessions ----------------------------------------------------------

    def open(self, k: int = 10) -> BatchSession:
        """Pin a free lane to a new session (its state starts at the
        slab's empty-prefix init, so no device work is needed here)."""
        for lane, owner in enumerate(self._lanes):
            if owner is None:
                session = BatchSession(self, lane, k)
                # a recycled lane may carry the previous owner's frontier;
                # the re-init rides the first ticket's flush like reset()
                session._reset_pending = True
                self._lanes[lane] = session
                self._consumed[lane] = b""
                self._n_occupied += 1
                return session
        raise SchedulerOverloaded(
            f"all {self.block} lanes are held by open sessions; close "
            f"one or build the scheduler with a larger block")

    def _release(self, session: BatchSession) -> None:
        # deferred release: keystrokes in flight keep riding normal
        # flushes (forcing partial flushes here would collapse occupancy
        # every time a session ends); the lane frees once its queue
        # empties, and meanwhile it stops counting toward the full-flush
        # condition
        if self._queues[session.lane]:
            self._draining[session.lane] = True
        else:
            self._lanes[session.lane] = None
            self._consumed[session.lane] = b""
            self._n_occupied -= 1

    # -- admission ---------------------------------------------------------

    def _enqueue(self, session: BatchSession, char: int, want_topk: bool,
                 reset_first: bool, prefix: bytes) -> Ticket:
        if self._lanes[session.lane] is not session:
            raise RuntimeError("session does not own its lane (closed?)")
        if self._pending >= self.max_queue:
            self.stats.rejected += 1
            raise SchedulerOverloaded(
                f"admission queue full ({self._pending} pending >= "
                f"max_queue={self.max_queue}); drain or shed load")
        ticket = Ticket(lane=session.lane, char=char, want_topk=want_topk,
                        k=session.k, created=self.clock(), prefix=prefix,
                        reset_first=reset_first)
        self._queues[session.lane].append(ticket)
        if len(self._queues[session.lane]) == 1:
            self._n_ready += 1
        self._pending += 1
        self.pump()
        return ticket

    # -- flush machinery ---------------------------------------------------

    @property
    def pending(self) -> int:
        """Queued keystrokes not yet consumed by a flush."""
        return self._pending

    def _occupied(self) -> int:
        return sum(o is not None for o in self._lanes)

    def _ready_lanes(self) -> list[int]:
        return [i for i, q in enumerate(self._queues) if q]

    def _oldest_age_ms(self, now: float) -> float:
        heads = [q[0].created for q in self._queues if q]
        return (now - min(heads)) * 1e3 if heads else 0.0

    def pump(self, now: float | None = None) -> int:
        """Fire due flushes: full blocks immediately, partial blocks once
        the oldest queued keystroke ages past ``max_wait_ms``.  Returns
        the number of flushes fired.  Event loops interleaving many sessions
        call this; ``submit`` calls it itself."""
        fired = 0
        while self._pending:
            # "full" = every occupied lane has a keystroke queued: waiting
            # longer cannot raise this flush's occupancy (each lane gives
            # at most one char), so fire now
            if self._n_ready > 0 and self._n_ready == self._n_occupied:
                self._flush(kind="full")
                fired += 1
                continue
            now_ = self.clock() if now is None else now
            if self._oldest_age_ms(now_) >= self.max_wait_ms:
                self._flush(kind="deadline")
                fired += 1
                continue
            break
        return fired

    def poll(self, now: float | None = None) -> int:
        """Non-blocking event-loop tick: :meth:`pump`, plus idle settling.

        ``pump`` alone starves the pipeline's tail — the last flush's
        results stay stashed until another flush or an explicit
        ``flush()``/``drain()``, so a loop calling ``pump()`` and
        checking ``ticket.done`` would spin forever once the queue
        empties.  ``poll`` settles the stash as soon as nothing is
        queued, making it the one call an event loop needs."""
        fired = self.pump(now)
        if not self._pending:
            self._settle()
        return fired

    def flush(self) -> None:
        """Force one partial-block flush (drain/result paths); settles
        stashed results when nothing is queued."""
        if self._pending:
            self._flush(kind="forced")
        else:
            self._settle()

    def drain(self) -> None:
        """Flush until no keystroke is queued or awaiting demux."""
        while self._pending:
            self._flush(kind="forced")
        self._settle()

    def _flush(self, kind: str) -> None:
        if self._epoch != self.index.epoch:
            self._migrate()
        prev = self._dispatch(kind)
        if prev:
            self._settle_handles(prev)

    def _to_device(self, chars: np.ndarray, resets: np.ndarray):
        """(chars int32[block], resets bool[block]) on the index's device
        in one host-to-device copy, from a pinned buffer on a CUDA index
        (the caching host allocator keeps the buffer until the copy has
        run)."""
        dev = self.index.device
        host = torch.empty((2, self.block), dtype=torch.int32,
                           pin_memory=dev.type == "cuda")
        buf = host.numpy()
        buf[0] = chars
        buf[1] = resets
        lanes = host.to(dev, non_blocking=True)
        return lanes[0], lanes[1] != 0

    def _stash(self, k: int, tickets: list[Ticket], topk_out):
        """One k-group's (scores, sids, exact) packed into one int32
        tensor and copied, without blocking, into a host buffer of its
        own; on a CUDA index an event marks the copy's end.  The entry
        keeps the device tensor alive until its settle, and carries the
        base dictionary (``index.strings``) its sids index."""
        scores, sids, exact = topk_out
        packed = torch.cat([scores.reshape(-1).to(torch.int32),
                            sids.reshape(-1).to(torch.int32),
                            exact.reshape(-1).to(torch.int32)])
        if packed.device.type != "cuda":
            return k, tickets, (packed, packed, None), self.index.strings
        host = torch.empty(packed.shape, dtype=torch.int32,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(packed.device))
        return k, tickets, (packed, host, ready), self.index.strings

    def _dispatch(self, kind: str):
        """Take one ticket of each ready lane, launch the flush's advance
        and phase 2 and stash their results; returns the previous
        flush's stash.  No read of the device happens here."""
        taken: list[Ticket] = []
        chars = np.full((self.block,), -1, np.int32)
        resets = np.zeros((self.block,), bool)
        for lane in self._ready_lanes():
            t = self._queues[lane].popleft()
            taken.append(t)
            chars[lane] = t.char
            resets[lane] = t.reset_first
            # t.prefix is the lane prefix after this keystroke (resets
            # included), which is what the slab encodes once this flush's
            # advance lands
            self._consumed[lane] = t.prefix
            if not self._queues[lane]:
                self._n_ready -= 1
                if self._draining[lane]:
                    self._lanes[lane] = None   # deferred close completes
                    self._draining[lane] = False
                    self._consumed[lane] = b""
                    self._n_occupied -= 1
        self._pending -= len(taken)
        self._slab = self._advance_fn(self._slab, *self._to_device(chars,
                                                                   resets))
        st = self.stats
        st.n_flushes += 1
        st.sum_occupancy += len(taken)
        st.n_keystrokes += sum(t.char >= 0 for t in taken)
        if kind == "full":
            st.full_flushes += 1
        elif kind == "deadline":
            st.deadline_flushes += 1
        else:
            st.forced_flushes += 1
        now = self.clock()
        for t in taken:
            if not t.want_topk:     # advance-only keystrokes resolve here
                t.done = True
                t.latency_s = now - t.created
        # pipeline: launch this flush's top-k (one batched call per
        # distinct k — usually one), stash it, and hand back the previous
        # flush for settling while this one runs on the device
        prev = self._unsettled
        self._unsettled = None
        wanting = [t for t in taken if t.want_topk]
        if wanting:
            by_k: dict[int, list[Ticket]] = {}
            for t in wanting:
                by_k.setdefault(t.k, []).append(t)
            stash = []
            for k, tickets in sorted(by_k.items()):
                topk_fn = self._topk_fns.get(k)
                if topk_fn is None:
                    topk_fn = self._topk_fns[k] = \
                        self.index._slab_topk_fn(self.block, k)
                stash.append(self._stash(k, tickets, topk_fn(self._slab)))
            self._unsettled = stash
        return prev

    def _migrate(self) -> None:
        """Rebuild the slab on the index's current epoch (a compaction
        swap or a reconfigure, at the flush boundary).

        The stashed flush settles first: its results were computed on the
        old tables (after a compaction its sids name the old dictionary,
        and :meth:`_settle_handles` answers it through ``complete`` on the
        new one).  Then the slab fns
        are refetched (they close over the old tensors and config) and
        every lane's *consumed* prefix is replayed column-wise: one
        batched advance per step of the longest prefix, idle lanes riding
        as -1 no-ops.  Queued keystrokes are untouched — they consume from
        the rebuilt slab on the flushes that follow, so nothing is lost or
        reordered."""
        self._settle()
        self._init_fn, self._advance_fn = self.index._slab_fns(self.block)
        self._topk_fns = {}
        slab = self._init_fn()
        no_reset = np.zeros((self.block,), bool)
        for step in range(max(map(len, self._consumed), default=0)):
            chars = np.full((self.block,), -1, np.int32)
            for lane, p in enumerate(self._consumed):
                if step < len(p):
                    chars[lane] = p[step]
            slab = self._advance_fn(slab, *self._to_device(chars, no_reset))
        self._slab = slab
        self._epoch = self.index.epoch
        self.stats.migrations += 1

    def _settle(self) -> None:
        """Resolve the stashed flush, if any (the pipeline's tail)."""
        prev = self._unsettled
        self._unsettled = None
        if prev:
            self._settle_handles(prev)

    def _settle_handles(self, stash) -> None:
        # each entry holds the whole [block, k] slab result; the lanes
        # wanting that k are picked out once its copy has landed.  An
        # entry dispatched before a compaction swapped the base dictionary
        # holds sids of the old one (every delete before the swap shifts
        # the later sids): its lanes are answered by complete() on the
        # current index, as a session's next keystroke would be
        B = self.block
        for k, tickets, (_, host, ready), dictionary in stash:
            if ready is not None:
                ready.synchronize()
            if dictionary is not self.index.strings:
                for t, row in zip(tickets, self.index.complete(
                        [t.prefix for t in tickets], k=k)):
                    self._resolve(t, row)
                continue
            flat = host.numpy()
            scores = flat[:B * k].reshape(B, k)
            sids = flat[B * k:2 * B * k].reshape(B, k)
            exact = flat[2 * B * k:]
            for t in tickets:
                if not exact[t.lane]:
                    self.stats.fallbacks += 1
                self._resolve(t, resolve_topk(
                    self.index, scores[t.lane], sids[t.lane],
                    exact[t.lane], t.prefix, k))

    def _resolve(self, t: Ticket, results: list) -> None:
        t.results = results
        t.done = True
        t.latency_s = self.clock() - t.created
        if self.on_keystroke is not None:
            self.on_keystroke(t.latency_s)
