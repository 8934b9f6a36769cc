"""CompletionService: the paper's technique as the serving front-end.

Wraps a local completion index and answers batches of queries through
:meth:`CompletionService.complete`, keeping per-request latency stats.
``open_session`` exposes the incremental per-keystroke path: a
:class:`ServiceSession` advances the index's resumable locus frontier one
char at a time and folds per-keystroke latency into the service stats.
The continuous-batching scheduler (``batching=True``, ``submit``) and
reranking are not ported yet (ROADMAP.md §1 item 5) and raise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.not_ported import not_ported

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
    """One user's typing stream through the service (keystroke stats)."""

    def __init__(self, service: "CompletionService", k: int):
        self.service = service
        self.k = k
        self._session = service.index.session(k=k)

    @property
    def prefix(self) -> str:
        return self._session.prefix

    def submit(self, char, want_topk: bool = True):
        raise not_ported("scheduler")

    def type(self, text: str | bytes) -> list[tuple[int, str]]:
        """Feed keystrokes one at a time, each timed until its top-k is on
        the host; returns the top-k for the new prefix."""
        data = text.encode() if isinstance(text, str) else bytes(text)
        if not data:
            results = self._session.topk()
        for i in range(len(data)):
            t0 = time.perf_counter()
            results = self._session.type(data[i:i + 1])
            self.service.stats.record_keystroke(time.perf_counter() - t0)
        return results[:self.k]

    def backspace(self, n: int = 1) -> list[tuple[int, str]]:
        return self._session.backspace(n)[:self.k]

    def reset(self) -> None:
        self._session.reset()

    def close(self) -> None:
        """Release the session (nothing to release without a scheduler)."""


class CompletionService:
    def __init__(self, index, reranker=None, *, batching: bool = False):
        """index: a :class:`repro_torch.api.index.CompletionIndex`."""
        if reranker is not None:
            raise not_ported("reranking")
        if batching:
            raise not_ported("scheduler")
        self.index = index
        self.stats = ServiceStats()

    def complete(self, queries: list[str], k: int = 10):
        """Top-k (score, string) pairs per query.  Every request of a
        synchronous batch waits the whole batch, so each records the batch
        wall time (which ends after the results are back on the host)."""
        t0 = time.perf_counter()
        results = self.index.complete(queries, k=k)
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

    def open_session(self, k: int = 10) -> ServiceSession:
        """Start a stateful per-keystroke session."""
        return ServiceSession(self, k)
