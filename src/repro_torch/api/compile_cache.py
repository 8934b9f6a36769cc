"""Bounded, bucketed cache of prepared engine entry points.

``repro``'s cache holds jit-compiled executables.  PyTorch runs eagerly,
so here an entry is the prepared callable for one key: the substrate's
entry point with the index's tensors, its config and k bound.  The
contract is ``repro``'s (``repro/api/compile_cache.py``): shapes are
bucketed (batch and query length rounded up to powers of two), the
entries live in an LRU of fixed capacity, and ``hits``/``misses``/
``evictions`` count what happened, so a call sequence gives both
packages the same counts.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable


def bucket_size(n: int, minimum: int = 8) -> int:
    """Round ``n`` up to the next power of two (at least ``minimum``)."""
    n = max(int(n), 1)
    return max(minimum, 1 << (n - 1).bit_length())


class CompileCache:
    """LRU over prepared callables, keyed by hashable shape/config keys."""

    def __init__(self, maxsize: int = 32):
        if maxsize <= 0:
            raise ValueError("maxsize must be positive")
        self.maxsize = maxsize
        self._entries: OrderedDict[Hashable, object] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable, factory: Callable[[], object]):
        """Return the cached value for ``key``, building it with
        ``factory`` on a miss (evicting the least recently used entry
        when full)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            return self._entries[key]
        self.misses += 1
        value = factory()
        self._entries[key] = value
        if len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
            self.evictions += 1
        return value

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def clear(self) -> None:
        self._entries.clear()

    def stats(self) -> dict:
        return {"size": len(self._entries), "maxsize": self.maxsize,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}
