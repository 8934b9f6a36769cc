"""Serving engine: request batcher + continuous-batching LM decode loop.

SlotScheduler keeps a fixed decode batch and swaps finished requests for
queued ones between steps (vLLM-style continuous batching): per-slot KV
caches live in one stacked cache, positions are a per-slot vector, and a
slot is recycled by prefilling the new prompt into its cache lane.
Every decode step runs all ``n_slots`` lanes, the empty ones on the token
they last held, as ``repro``'s does.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import transformer as tf


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # int32[prompt_len]
    max_new_tokens: int = 16
    created: float = field(default_factory=time.perf_counter)
    tokens: list = field(default_factory=list)
    done: bool = False
    first_token_at: float | None = None
    finished_at: float | None = None


class SlotScheduler:
    """Continuous batching over `n_slots` decode lanes."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Request | None] = [None] * n_slots
        self.completed: list[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def admit(self) -> list[tuple[int, Request]]:
        new = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                r = self.queue.popleft()
                self.slots[i] = r
                new.append((i, r))
        return new

    def record(self, slot_tokens: np.ndarray, eos_id: int | None = None):
        now = time.perf_counter()
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            tok = int(slot_tokens[i])
            if r.first_token_at is None:
                r.first_token_at = now
            r.tokens.append(tok)
            if len(r.tokens) >= r.max_new_tokens or \
                    (eos_id is not None and tok == eos_id):
                r.done = True
                r.finished_at = now
                self.completed.append(r)
                self.slots[i] = None

    @property
    def active(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)


class LMServer:
    """Batched prefill + continuous-batching greedy decode on the model's
    device, with a float32 cache of ``n_slots`` lanes of ``max_len``
    positions (the window where that is shorter)."""

    def __init__(self, params: tf.TransformerLM, cfg: tf.TransformerConfig,
                 *, n_slots: int, max_len: int):
        if cfg.cache_dtype == "int8":
            # repro's server writes the int8 prefill cache into its float
            # cache without the scales and decodes from the raw integers
            raise ValueError(
                "LMServer keeps a float32 cache: a config with "
                "cache_dtype='int8' would decode from int8 values without "
                "their scales")
        self.params = params
        self.cfg = cfg
        self.scheduler = SlotScheduler(n_slots)
        self.max_len = max_len
        self.device = params.embed.device
        self.cache = tf.init_cache(cfg, n_slots, max_len, torch.float32,
                                   device=self.device)
        self.cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                                        device=self.device)
        self.cur = np.zeros((n_slots,), np.int32)
        self.live = np.zeros((n_slots,), bool)

    def _prefill(self, tokens: torch.Tensor, slot: int) -> torch.Tensor:
        """Prefill one prompt into lane ``slot``; its last logits."""
        logits, new = tf.prefill(self.params, tokens[None], self.cfg,
                                 self.max_len, cache_dtype=torch.float32)
        self.cache["k"][:, slot] = new["k"][:, 0]
        self.cache["v"][:, slot] = new["v"][:, 0]
        self.cache["pos"][slot] = tokens.shape[0]
        return logits[0]

    def run(self, eos_id: int | None = None, max_steps: int = 100_000):
        sched = self.scheduler
        steps = 0
        with torch.no_grad():
            while sched.active and steps < max_steps:
                for slot, req in sched.admit():
                    logits = self._prefill(
                        torch.as_tensor(req.prompt, device=self.device), slot)
                    self.cur[slot] = int(logits.argmax())
                    self.live[slot] = True
                if not self.live.any():
                    break
                logits, self.cache = tf.decode_step(
                    self.params, self.cache,
                    torch.as_tensor(self.cur, device=self.device), self.cfg)
                emitted = self.cur.copy()
                nxt = logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
                sched.record(emitted, eos_id)
                self.cur = nxt
                for i, r in enumerate(sched.slots):
                    if r is None:
                        self.live[i] = False
                steps += 1
        return sched.completed
