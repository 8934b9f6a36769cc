"""Byte-alphabet helpers for the completion engine.

Strings are handled as uint8 byte sequences (|sigma| = 256).  Device-side
queries are padded int32 matrices with -1 padding.
"""

from __future__ import annotations

import numpy as np

SIGMA = 256
PAD = -1


def encode(s: str | bytes) -> np.ndarray:
    """Encode a string to a uint8 numpy array."""
    if isinstance(s, str):
        s = s.encode("utf-8")
    return np.frombuffer(bytes(s), dtype=np.uint8)


def decode(a: np.ndarray) -> str:
    return bytes(a[a >= 0].astype(np.uint8)).decode("utf-8", errors="replace")


def pad_queries(queries: list[str | bytes], max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Encode and pad a batch of queries.

    Returns (chars[B, max_len] int32 with PAD fill, lengths[B] int32).
    Queries longer than max_len are truncated (and reported via length).
    """
    batch = len(queries)
    out = np.full((batch, max_len), PAD, dtype=np.int32)
    lens = np.zeros((batch,), dtype=np.int32)
    for i, q in enumerate(queries):
        e = encode(q)[:max_len]
        out[i, : len(e)] = e.astype(np.int32)
        lens[i] = len(e)
    return out, lens
