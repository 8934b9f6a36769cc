"""Synthetic-but-structured LM token pipeline (a copy of ``repro``'s
``data/lm.py``: equal batches bit for bit).

Deterministic, seekable (state = step index), so checkpoint/restart resumes
the exact stream. The generator is a char-level Markov-ish mixture so the
loss actually decreases during the examples' short training runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class LMDataConfig:
    vocab: int = 256
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0


class TokenStream:
    """Yields {tokens, targets, mask} batches; `state` is the step index."""

    def __init__(self, cfg: LMDataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        # fixed bigram transition structure (low-entropy => learnable)
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        self._hot = rng.integers(0, v, size=(v, 4))

    def state(self) -> int:
        return self.step

    def next_batch(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, self.step]))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, b)
        noise = rng.random((b, s))
        choice = rng.integers(0, 4, (b, s))
        uni = rng.integers(0, cfg.vocab, (b, s))
        for t in range(s):
            follow = self._hot[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.85, follow, uni[:, t])
        self.step += 1
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:].copy(),
            "mask": np.ones((b, s), bool),
        }

    def __iter__(self):
        while True:
            yield self.next_batch()
