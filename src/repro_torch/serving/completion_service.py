"""CompletionService: the paper's technique as the serving front-end.

Wraps a (sharded or local) completion index and answers batches of
queries through :meth:`CompletionService.complete`, keeping per-request
latency stats; optionally re-ranks the trie's candidates with any
callable (a model's log-prob, a user affinity) — the trie proposes
``overfetch * k`` cheaply, the reranker spends its work on those alone.

``open_session`` exposes the incremental per-keystroke path: a
:class:`ServiceSession` advances the index's resumable locus frontier one
char at a time and folds per-keystroke latency into the service stats.
With ``batching=True`` the service owns a
:class:`~repro_torch.serving.scheduler.KeystrokeScheduler` and sessions
ride shared fixed-shape micro-batches instead of paying one advance and
one phase 2 per keystroke — the same results, one batched advance and
top-k per coalesced block.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

LATENCY_WINDOW = 4096  # bound per-request/per-keystroke latency history


def _percentile(xs: list, q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(int(len(s) * q), len(s) - 1)]


def _record(xs: list, value_ms: float) -> None:
    """Append keeping only the trailing LATENCY_WINDOW samples."""
    xs.append(value_ms)
    if len(xs) > LATENCY_WINDOW:
        del xs[:len(xs) - LATENCY_WINDOW]


@dataclass
class ServiceStats:
    n_queries: int = 0
    total_seconds: float = 0.0
    batches: int = 0
    latencies_ms: list = field(default_factory=list)
    # incremental (per-keystroke) accounting
    n_keystrokes: int = 0
    keystroke_seconds: float = 0.0
    keystroke_latencies_ms: list = field(default_factory=list)

    @property
    def mean_latency_ms(self) -> float:
        return (self.total_seconds / max(self.n_queries, 1)) * 1e3

    @property
    def mean_keystroke_ms(self) -> float:
        return (self.keystroke_seconds / max(self.n_keystrokes, 1)) * 1e3

    @property
    def p50_latency_ms(self) -> float:
        return _percentile(self.latencies_ms, 0.50)

    @property
    def p99_latency_ms(self) -> float:
        return _percentile(self.latencies_ms, 0.99)

    def p99_ms(self) -> float:
        return self.p99_latency_ms

    def p50_keystroke_ms(self) -> float:
        return _percentile(self.keystroke_latencies_ms, 0.50)

    def p99_keystroke_ms(self) -> float:
        return _percentile(self.keystroke_latencies_ms, 0.99)

    def record_keystroke(self, seconds: float) -> None:
        """Fold one per-keystroke latency sample in."""
        self.n_keystrokes += 1
        self.keystroke_seconds += seconds
        _record(self.keystroke_latencies_ms, seconds * 1e3)

    def reset_keystrokes(self) -> None:
        """Discard keystroke accounting (e.g. after a warm-up query)."""
        self.n_keystrokes = 0
        self.keystroke_seconds = 0.0
        self.keystroke_latencies_ms.clear()


class ServiceSession:
    """One user's typing stream through the service (stats + reranking)."""

    def __init__(self, service: "CompletionService", k: int):
        self.service = service
        self.k = k
        fetch_k = k * (service.overfetch if service.reranker else 1)
        if service.batching:
            # batched sessions share the scheduler's slab; a keystroke's
            # latency (queue wait + flush + demux) is recorded by the
            # scheduler's demux hook, not a wall timer here
            self._session = service._scheduler().open(k=fetch_k)
            self._timed = False
        else:
            self._session = service.index.session(k=fetch_k)
            self._timed = True

    @property
    def prefix(self) -> str:
        return self._session.prefix

    def submit(self, char: int | bytes | str, want_topk: bool = True):
        """Non-blocking enqueue of one keystroke (batching mode only);
        returns the scheduler's Ticket.  Callers use it to keep many
        sessions in flight so their keystrokes coalesce."""
        if not self.service.batching:
            raise RuntimeError(
                "submit() needs a batching service; construct "
                "CompletionService(..., batching=True) or use type()")
        return self._session.submit(char, want_topk=want_topk)

    def type(self, text: str | bytes) -> list[tuple[int, str]]:
        """Feed keystrokes one at a time (unbatched: each timed until its
        top-k is on the host); returns the (re-ranked) top-k for the new
        prefix."""
        data = text.encode() if isinstance(text, str) else bytes(text)
        if not data:
            results = self._session.topk()
        for i in range(len(data)):
            t0 = time.perf_counter()
            results = self._session.type(data[i:i + 1])
            if self._timed:
                self.service.stats.record_keystroke(
                    time.perf_counter() - t0)
        if self.service.reranker is not None:
            results = self.service.reranker(self.prefix, results)
        return results[:self.k]

    def backspace(self, n: int = 1) -> list[tuple[int, str]]:
        results = self._session.backspace(n)
        if self.service.reranker is not None:
            results = self.service.reranker(self.prefix, results)
        return results[:self.k]

    def reset(self) -> None:
        self._session.reset()

    def close(self) -> None:
        """Release the session's scheduler lane (no-op when unbatched)."""
        close = getattr(self._session, "close", None)
        if close is not None:
            close()


class CompletionService:
    def __init__(self, index, reranker=None, overfetch: int = 4, *,
                 batching: bool = False, block: int = 8,
                 max_wait_ms: float = 2.0, max_queue: int | None = None):
        """index: a :class:`repro_torch.api.index.CompletionIndex` (or a
            :class:`~repro_torch.core.distributed.ShardedCompletionIndex`,
            which serves batches only).
        reranker: callable(query, [(score, string)]) -> [(score, string)].
        overfetch: fetch overfetch*k trie candidates before reranking.
        batching: route per-keystroke sessions through the continuous-
            batching scheduler (block/max_wait_ms/max_queue are its
            micro-batch width, latency budget and admission bound)."""
        self.index = index
        self.reranker = reranker
        self.overfetch = overfetch
        self.batching = batching
        self.block = block
        self.max_wait_ms = max_wait_ms
        self.max_queue = max_queue
        self.stats = ServiceStats()
        self.scheduler = None

    def complete(self, queries: list[str], k: int = 10):
        """Top-k (score, string) pairs per query (re-ranked from an
        over-fetch when the service has a reranker).  Every request of a
        synchronous batch waits the whole batch, so each records the batch
        wall time (which ends after the results are back on the host)."""
        t0 = time.perf_counter()
        fetch_k = k * (self.overfetch if self.reranker else 1)
        results = self.index.complete(queries, k=fetch_k)
        if self.reranker is not None:
            results = [self.reranker(q, r)[:k]
                       for q, r in zip(queries, results)]
        else:
            results = [r[:k] for r in results]
        dt = time.perf_counter() - t0
        self.stats.n_queries += len(queries)
        self.stats.total_seconds += dt
        self.stats.batches += 1
        for _ in queries:
            _record(self.stats.latencies_ms, dt * 1e3)
        return results

    def reset_stats(self) -> None:
        """Discard the accounting (e.g. after a warm-up batch)."""
        self.stats = ServiceStats()
        if self.scheduler is not None:
            self.scheduler.on_keystroke = self.stats.record_keystroke

    def _scheduler(self):
        if self.scheduler is None:
            from repro_torch.serving.scheduler import KeystrokeScheduler

            self.scheduler = KeystrokeScheduler(
                self.index, block=self.block, max_wait_ms=self.max_wait_ms,
                max_queue=self.max_queue,
                on_keystroke=self.stats.record_keystroke)
        return self.scheduler

    def pump(self) -> int:
        """Fire due scheduler flushes (batching-mode event loops call
        this); returns the number of flushes fired."""
        return self._scheduler().pump() if self.batching else 0

    def poll(self) -> int:
        """Like :meth:`pump`, and also settles the scheduler's pipelined
        result stash once the queue is empty, so the last flush's tickets
        resolve even when no further keystroke arrives.  Event loops
        should prefer it to ``pump``."""
        return self._scheduler().poll() if self.batching else 0

    def flush(self) -> None:
        """Force one partial-block flush (e.g. to make room after a
        SchedulerOverloaded rejection without collapsing the queue)."""
        if self.batching and self.scheduler is not None:
            self.scheduler.flush()

    def drain(self) -> None:
        """Flush the scheduler until no keystroke is in flight."""
        if self.batching and self.scheduler is not None:
            self.scheduler.drain()

    def compact(self, handoff_path: str | None = None
                ) -> "CompletionService":
        """Fold the index's pending mutations into a fresh index and swap
        it in under the live sessions.

        The swap bumps the index epoch; sequential sessions and the
        scheduler's slab migrate at their next keystroke boundary by
        replaying their retained prefixes, so no open session drops a
        keystroke or loses its prefix.  ``handoff_path`` routes the swap
        through the npz container (the restart-without-downtime shape)."""
        compact = getattr(self.index, "compact", None)
        if not callable(compact):
            from repro_torch.core.distributed import UnsupportedOnShardedIndex
            raise UnsupportedOnShardedIndex(
                f"compact() needs a local CompletionIndex; "
                f"{type(self.index).__name__} has no mutation overlay — "
                f"mutate and compact the per-shard indexes instead")
        compact(handoff_path)
        return self

    def open_session(self, k: int = 10) -> ServiceSession:
        """Start a stateful per-keystroke session; with ``batching=True``
        it rides the service's shared micro-batches.  Needs an index with
        the session entry points (a local
        :class:`~repro_torch.api.index.CompletionIndex`)."""
        if not callable(getattr(self.index, "session", None)) or \
                not callable(getattr(self.index, "_slab_fns", None)):
            from repro_torch.core.distributed import UnsupportedOnShardedIndex
            raise UnsupportedOnShardedIndex(
                f"per-keystroke sessions need a local CompletionIndex; "
                f"{type(self.index).__name__} does not support them yet "
                f"(sharded sessions would need a resumable cross-shard "
                f"frontier — use complete() for batch lookups instead)")
        return ServiceSession(self, k)
