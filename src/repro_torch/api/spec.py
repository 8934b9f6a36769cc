"""Declarative index specification + pluggable builder registry.

An :class:`IndexSpec` captures *what* index to build (kind, HT space budget,
cache depth, on-device layout) and the static engine widths.  The per-kind
rule-partitioning policies (``tt`` / ``et`` / ``ht`` / ``plain`` /
``multiterm``) register themselves in a builder registry, and a kind that
derives rules from the corpus registers a rule synthesizer beside it
(:mod:`repro_torch.api.build`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.core import trie_build as tb


@dataclass(frozen=True)
class IndexSpec:
    """Everything needed to (re)build a completion index, minus the data.

    kind: "tt" (twin tries), "et" (expansion trie), "ht" (hybrid),
        "plain" (prefix-only, no synonym support) or "multiterm" (the last
        typed token completes after up to ``multiterm_gap`` skipped
        tokens).
    alpha: HT space ratio in [0, 1] (paper Fig. 8); ignored by other kinds.
    cache_k: materialize per-node top-K lists (0 = off; phase 2 then
        merges them when k <= cache_k).
    frontier/gens/expand/max_steps: static engine widths.
    substrate: "torch" (plain PyTorch versions), "cuda" (hand-written
        kernels) or "auto" (cuda on a CUDA device, torch on the CPU).
    compression: on-device layout — "none" keeps the uniform-int32
        tables, "packed" the compressed layout (chain-collapsed sparse
        side tables, u8/u16 tiers, a quantized cache); answers are
        bit-identical.
    memory_budget: the JAX package's VMEM byte budget, which picks
        between a Pallas kernel's VMEM-resident and DMA-streamed tiers.
        Validated (>= 0) and carried into ``EngineConfig`` as the JAX
        package does, but it has no effect here: on the card every table
        sits in device memory and one CUDA kernel covers both tiers.  A
        runtime knob (``CompletionIndex.reconfigure(memory_budget=...)``).
    edit_budget: bounded-edit (typo-tolerant) matching: up to this many
        single-character edits (substitute, insert, delete) on the
        dictionary side of a match, 0-2; a runtime knob
        (``CompletionIndex.reconfigure(edit_budget=...)``).  0 = exact.
    multiterm_gap: kind="multiterm": the most dictionary tokens a typed
        space may skip.  Ignored by other kinds.
    """

    kind: str = "et"
    alpha: float = 0.5
    cache_k: int = 0
    frontier: int = 32
    gens: int = 48
    expand: int = 8
    max_steps: int = 512
    substrate: str = "auto"
    memory_budget: int = 0
    compression: str = "none"
    edit_budget: int = 0
    multiterm_gap: int = 2

    def validate(self) -> "IndexSpec":
        if self.kind not in _BUILDERS:
            raise ValueError(
                f"unknown index kind {self.kind!r}; registered kinds: "
                f"{registered_kinds()}")
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {self.alpha}")
        from repro_torch.core.engine.substrate import available_substrates
        if self.substrate != "auto" and \
                self.substrate not in available_substrates():
            raise ValueError(
                f"unknown substrate {self.substrate!r}; expected 'auto' or "
                f"one of {available_substrates()}")
        if self.compression not in ("none", "packed"):
            raise ValueError(
                f"unknown compression {self.compression!r}; expected "
                "'none' or 'packed'")
        for name in ("cache_k", "memory_budget"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        for name in ("frontier", "gens", "expand", "max_steps",
                     "multiterm_gap"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if not 0 <= self.edit_budget <= 2:
            raise ValueError(
                f"edit_budget must be in [0, 2], got {self.edit_budget}")
        return self

    def validate_sharded(self) -> "IndexSpec":
        """Validate for use across ``ShardedCompletionIndex`` shards.

        The packed layout cannot be stacked: shard stacking pads every
        table to the widest shard, which breaks the packed side tables'
        sorted-rank invariants.  Rejecting the spec here surfaces the
        problem at construction time with the workaround, instead of a
        ``NotImplementedError`` deep in ``stack_shards``."""
        self.validate()
        if self.compression != "none":
            raise ValueError(
                f"compression={self.compression!r} is unsupported on "
                f"sharded indexes: stacking pads the packed side tables "
                f"and breaks their sorted-rank invariants. Build shards "
                f"with compression='none'")
        return self

    def replace(self, **kw) -> "IndexSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "IndexSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known}).validate()


@dataclass
class BuildContext:
    """What a kind-specific builder sees: the pure dictionary trie plus the
    full link candidate set (anchor, rule, target) found on it."""

    spec: IndexSpec
    trie: tb.DictTrie
    rules: list[tb.SynonymRule]
    anchors: np.ndarray  # int32[L]
    rids: np.ndarray     # int32[L]
    targets: np.ndarray  # int32[L]


# A builder decides, per rule, whether it is expanded into synonym branches
# (ET side) and/or kept in the link store (TT side).
Builder = Callable[[BuildContext], tuple[np.ndarray, np.ndarray]]

_BUILDERS: dict[str, Builder] = {}


def register_builder(kind: str):
    """Register a rule-partitioning policy for an index kind.

    The decorated function maps a :class:`BuildContext` to boolean masks
    ``(expand_mask[R], keep_links[R])`` over rule ids.
    """

    def deco(fn: Builder) -> Builder:
        if kind in _BUILDERS:
            raise ValueError(f"index kind {kind!r} already registered")
        _BUILDERS[kind] = fn
        return fn

    return deco


# Optional per-kind rule synthesizers: run before link finding, they map
# (spec, strings, user rules) to extra SynonymRules the kind derives from
# the corpus itself (e.g. the multiterm token-skip rules).
Synthesizer = Callable[[IndexSpec, list, list], list]

_SYNTHESIZERS: dict[str, Synthesizer] = {}


def register_rule_synthesizer(kind: str):
    """Register a corpus-driven rule synthesizer for an index kind."""

    def deco(fn: Synthesizer) -> Synthesizer:
        if kind in _SYNTHESIZERS:
            raise ValueError(f"synthesizer for kind {kind!r} already "
                             "registered")
        _SYNTHESIZERS[kind] = fn
        return fn

    return deco


def get_synthesizer(kind: str) -> Synthesizer | None:
    return _SYNTHESIZERS.get(kind)


def get_builder(kind: str) -> Builder:
    try:
        return _BUILDERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown index kind {kind!r}; registered kinds: "
            f"{registered_kinds()}") from None


def registered_kinds() -> list[str]:
    return sorted(_BUILDERS)
