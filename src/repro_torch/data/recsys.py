"""RecSys click-log generator: zipf item popularity, per-user taste vectors,
deterministic + seekable like the LM stream.

A copy of ``repro``'s ``data/recsys.py`` (numpy only): for the same seed
and step its batches equal ``repro``'s bit for bit."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RecsysDataConfig:
    n_items: int = 1_000_000
    n_dense: int = 13
    n_sparse: int = 26
    seq_len: int = 50
    batch: int = 256
    seed: int = 0


class ClickStream:
    def __init__(self, cfg: RecsysDataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def state(self) -> int:
        return self.step

    def _rng(self):
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, self.step]))

    def _zipf_items(self, rng, shape):
        z = rng.zipf(1.3, shape).astype(np.int64)
        return (z % self.cfg.n_items).astype(np.int32)

    def next_dlrm(self) -> dict:
        cfg = self.cfg
        rng = self._rng()
        self.step += 1
        dense = rng.normal(size=(cfg.batch, cfg.n_dense)).astype(np.float32)
        sparse = self._zipf_items(rng, (cfg.batch, cfg.n_sparse))
        # label correlated with features so training can learn
        w = np.linspace(-1, 1, cfg.n_dense, dtype=np.float32)
        logit = dense @ w + 0.001 * (sparse.sum(1) % 97 - 48)
        label = (logit + rng.normal(size=cfg.batch) > 0).astype(np.float32)
        return {"dense": dense, "sparse": sparse, "label": label}

    def next_seq(self, with_negatives: int = 0) -> dict:
        """For DIN / SASRec / MIND: histories + target (+ negatives)."""
        cfg = self.cfg
        rng = self._rng()
        self.step += 1
        hist = self._zipf_items(rng, (cfg.batch, cfg.seq_len))
        lens = rng.integers(cfg.seq_len // 4, cfg.seq_len + 1, cfg.batch)
        pad = np.arange(cfg.seq_len)[None, :] >= lens[:, None]
        hist = np.where(pad, -1, hist)
        target = self._zipf_items(rng, (cfg.batch,))
        label = rng.integers(0, 2, cfg.batch).astype(np.float32)
        out = {"hist": hist, "target": target, "label": label}
        if with_negatives:
            out["neg"] = self._zipf_items(rng, (cfg.batch, with_negatives))
        # sasrec-style per-position next-item targets
        out["pos"] = np.where(pad, -1, np.roll(hist, -1, axis=1))
        out["neg_seq"] = self._zipf_items(rng, (cfg.batch, cfg.seq_len))
        return out
