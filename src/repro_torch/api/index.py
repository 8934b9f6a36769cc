"""CompletionIndex: the queryable, persistable completion index on one
device.

Construction lives in :mod:`repro_torch.api.build` (driven by an
:class:`~repro_torch.api.spec.IndexSpec`) and the container in
:mod:`repro_torch.api.persist`; this module owns the device tensors,
batched lookup with the exactness-retry guard, ``save``/``load`` and the
session entry points.  PyTorch runs eagerly, so there is no compile cache;
batch and query length are still bucketed to powers of two, as in the JAX
package, so both packages run every query at the same shapes.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import replace

import numpy as np
import torch

from repro_torch.api.build import BuildStats
from repro_torch.api.spec import IndexSpec
from repro_torch.core import engine as eng
from repro_torch.core import trie_build as tb
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine import substrate as subs
from repro_torch.core.engine.structs import (DeviceTrie, EngineConfig,
                                             resolve_device)
from repro_torch.not_ported import not_ported

#: IndexSpec fields :meth:`CompletionIndex.reconfigure` may change
RUNTIME_FIELDS = ("substrate", "memory_budget", "frontier", "gens",
                  "expand", "max_steps", "edit_budget")
#: fields baked into the built structures; changing them means a rebuild
BUILD_FIELDS = ("kind", "alpha", "cache_k", "compression", "multiterm_gap")


def bucket_size(n: int, minimum: int = 8) -> int:
    """Round ``n`` up to the next power of two (at least ``minimum``)."""
    n = max(int(n), 1)
    return max(minimum, 1 << (n - 1).bit_length())


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, its dtype kept (u16 tiers travel as
    their int16 bits and are viewed back, which every device copies)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device).view(
            torch.uint16)
    return torch.from_numpy(a).to(device)


def _to_device(trie: tb.DictTrie, rule_trie: tb.RuleTrie,
               device: torch.device) -> DeviceTrie:
    def j(a):
        return _tensor(a, device)

    dummy = np.full((1, 1), -1, np.int32)
    rule = dict(
        r_first_child=j(rule_trie.first_child),
        r_edge_char=j(rule_trie.edge_char),
        r_edge_child=j(rule_trie.edge_child),
        r_term_plane=j(rule_trie.term_plane),
        r_rule_len=j(rule_trie.rule_len))
    if trie.has_packed:
        # compressed layout: only the packed side tables (their narrow
        # dtypes kept), the link store and the rule trie go to the device;
        # the dense tables are 0-size dummies
        z1 = j(np.zeros(0, np.int32))
        packed = {f: j(getattr(trie, f)) for f in tb.PACKED_ONLY_FIELDS
                  if getattr(trie, f) is not None}
        packed["c_tree"] = pk.rank_tree(packed["c_ids"])
        return DeviceTrie(
            depth=z1, max_score=z1, leaf_score=z1, leaf_sid=z1,
            syn_mask=j(np.zeros(0, bool)), tout=z1,
            first_child=z1, edge_char=z1, edge_child=z1,
            s_first_child=z1, s_edge_char=z1, s_edge_child=z1,
            emit_ptr=z1, emit_node=z1, emit_score=z1, emit_is_leaf=z1,
            tele_plane=j(np.zeros((0, 1), np.int32)), link_ptr=z1,
            link_rule=j(trie.link_rule), link_target=j(trie.link_target),
            topk_score=j(dummy), topk_sid=j(dummy), **rule, **packed)
    has_cache = trie.topk_score is not None
    return DeviceTrie(
        depth=j(trie.depth), max_score=j(trie.max_score),
        leaf_score=j(trie.leaf_score), leaf_sid=j(trie.leaf_sid),
        syn_mask=j(trie.syn_mask), tout=j(trie.tout),
        first_child=j(trie.first_child), edge_char=j(trie.edge_char),
        edge_child=j(trie.edge_child),
        s_first_child=j(trie.s_first_child), s_edge_char=j(trie.s_edge_char),
        s_edge_child=j(trie.s_edge_child),
        emit_ptr=j(trie.emit_ptr), emit_node=j(trie.emit_node),
        emit_score=j(trie.emit_score), emit_is_leaf=j(trie.emit_is_leaf),
        tele_plane=j(trie.tele_plane),
        link_ptr=j(trie.link_ptr), link_rule=j(trie.link_rule),
        link_target=j(trie.link_target),
        topk_score=j(trie.topk_score if has_cache else dummy),
        topk_sid=j(trie.topk_sid if has_cache else dummy),
        **rule,
    )


def _as_port(cls, obj):
    """A port DictTrie/RuleTrie from one of the same field names (such as
    the JAX package's numpy structures, dense or packed)."""
    if isinstance(obj, cls):
        return obj
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)})


class CompletionIndex:
    """A synonym-aware top-k completion index (TT, ET, HT or plain)."""

    def __init__(self, spec: IndexSpec, trie, rule_trie, rules, strings,
                 scores, cfg: EngineConfig, stats: BuildStats | None, *,
                 device, epoch: int = 0):
        self.spec = spec
        self.trie = trie
        self.rule_trie = rule_trie
        self.rules = rules
        self.strings = strings          # sorted; leaf_sid indexes this
        self.scores = scores
        self.cfg = cfg
        self.stats = stats
        self.device = torch.device(device)
        self.tensors = _to_device(trie, rule_trie, self.device)
        #: queries re-run by each widened retry round (1st, 2nd, 3rd),
        #: summed over every lookup since the index was made
        self.retried = [0, 0, 0]
        #: bumped by every :meth:`reconfigure` that changes something;
        #: sessions compare against it to know when to migrate
        self.epoch = epoch

    @classmethod
    def from_parts(cls, trie, rule_trie, rules, strings, scores, cfg,
                   device=None, spec: IndexSpec | None = None,
                   stats: BuildStats | None = None):
        """An index from host arrays built elsewhere — the numpy
        structures of a ``repro`` build (``index.trie``,
        ``index.rule_trie``, ``index.cfg``, ...) — on ``device``.  Only an
        index given its ``stats`` can be saved."""
        from repro_torch.api.build import validate_rule_planes
        from repro_torch.api.persist import engine_config

        device = resolve_device(device)
        trie = _as_port(tb.DictTrie, trie)
        rule_trie = _as_port(tb.RuleTrie, rule_trie)
        cfg = engine_config(cfg, trie, rule_trie,
                            spec.substrate if spec else "auto", device)
        if spec is None:
            spec = IndexSpec(frontier=cfg.frontier, gens=cfg.gens,
                             expand=cfg.expand, max_steps=cfg.max_steps,
                             cache_k=cfg.cache_k,
                             memory_budget=cfg.memory_budget,
                             compression=cfg.compression)
        validate_rule_planes(trie, rule_trie, cfg)
        return cls(spec, trie, rule_trie, list(rules), list(strings),
                   np.asarray(scores), cfg, stats, device=device)

    @property
    def kind(self) -> str:
        return self.spec.kind

    @property
    def substrate(self) -> str:
        """The resolved execution substrate lookups run on."""
        return self.cfg.substrate

    @property
    def compression(self) -> str:
        """On-device layout: "none" (full-width) or "packed" (format v4)."""
        return self.cfg.compression

    @property
    def memory_budget(self) -> int:
        """The JAX package's VMEM budget, carried without effect on the
        card (see :class:`~repro_torch.api.spec.IndexSpec`)."""
        return self.cfg.memory_budget

    def reconfigure(self, **changes) -> "CompletionIndex":
        """Change runtime knobs (:data:`RUNTIME_FIELDS`) in one validated
        step; returns ``self``.  Build-time fields (:data:`BUILD_FIELDS`)
        raise, changes equal to the current spec are dropped, and any
        real change bumps :attr:`epoch`."""
        build_time = set(changes) & set(BUILD_FIELDS)
        if build_time:
            raise ValueError(
                f"{sorted(build_time)} are build-time fields baked into "
                "the index structures; rebuild with build_index(...)")
        unknown = set(changes) - set(RUNTIME_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown reconfigure field(s) {sorted(unknown)}; "
                f"runtime knobs are {RUNTIME_FIELDS}")
        changes = {k: v for k, v in changes.items()
                   if getattr(self.spec, k) != v}
        if not changes:
            return self
        spec = self.spec.replace(**changes).validate()
        if "substrate" in changes:
            changes["substrate"] = subs.resolve_substrate(
                changes["substrate"], self.device)
        self.spec = spec
        self.cfg = replace(self.cfg, **changes)
        self.epoch += 1
        return self

    def set_substrate(self, name: str) -> "CompletionIndex":
        """Deprecated alias of ``reconfigure(substrate=...)``."""
        warnings.warn(
            "CompletionIndex.set_substrate() is deprecated; use "
            "reconfigure(substrate=...)", DeprecationWarning, stacklevel=2)
        return self.reconfigure(substrate=name)

    def set_memory_budget(self, n: int) -> "CompletionIndex":
        """Deprecated alias of ``reconfigure(memory_budget=...)``."""
        warnings.warn(
            "CompletionIndex.set_memory_budget() is deprecated; use "
            "reconfigure(memory_budget=...)", DeprecationWarning,
            stacklevel=2)
        return self.reconfigure(memory_budget=n)

    # -- construction ------------------------------------------------------

    @staticmethod
    def build(strings, scores, rules, kind: str = "et", *,
              alpha: float = 0.5, cache_k: int = 0,
              frontier: int = 32, gens: int = 48, expand: int = 8,
              max_steps: int = 512, compression: str = "none",
              edit_budget: int = 0, multiterm_gap: int = 2,
              device=None) -> "CompletionIndex":
        """Keyword constructor; equivalent to ``build_index(strings,
        scores, rules, IndexSpec(...), device=device)``."""
        from repro_torch.api.build import build_index

        spec = IndexSpec(kind=kind, alpha=alpha, cache_k=cache_k,
                         frontier=frontier, gens=gens, expand=expand,
                         max_steps=max_steps, compression=compression,
                         edit_budget=edit_budget,
                         multiterm_gap=multiterm_gap)
        return build_index(strings, scores, rules, spec, device=device)

    @staticmethod
    def from_spec(strings, scores, rules, spec: IndexSpec,
                  device=None) -> "CompletionIndex":
        """``build_index(strings, scores, rules, spec, device=device)``."""
        from repro_torch.api.build import build_index

        return build_index(strings, scores, rules, spec, device=device)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the versioned npz container (format 4, the JAX package's
        names); ``CompletionIndex.load(path)`` in either package restores
        it without re-running trie construction."""
        from repro_torch.api.persist import save_index

        save_index(self, path)

    @classmethod
    def load(cls, path: str, device=None) -> "CompletionIndex":
        """Load a container saved by either package onto ``device`` (CUDA
        unless the caller passes another), its ``epoch`` resumed."""
        from repro_torch.api.persist import load_index_parts

        device = resolve_device(device)
        p = load_index_parts(path, device)
        return cls(p["spec"], p["trie"], p["rule_trie"], p["rules"],
                   p["strings"], p["scores"], p["cfg"], p["stats"],
                   device=device, epoch=p["epoch"])

    # -- sessions ----------------------------------------------------------

    def _session_fns(self, k: int):
        """(init, advance-one-char, topk) over this index's tensors and
        its current config (a :class:`~repro_torch.api.session.Session`
        refetches them when :attr:`epoch` moves)."""
        dev, cfg = self.tensors, self.cfg
        sub = subs.get_substrate(cfg.substrate)

        def init():
            return eng.init_locus_state(dev, cfg, sub)

        def advance(state, c):
            return eng.advance_locus_state(dev, cfg, state, c, sub)

        def topk(state):
            return eng.topk_from_loci(dev, cfg, state, k, sub)

        return init, advance, topk

    def session(self, k: int = 10):
        """Open a stateful incremental-typing session (see
        :class:`repro_torch.api.session.Session`)."""
        from repro_torch.api.session import Session

        return Session(self, k=k)

    # -- out-of-slice surfaces -------------------------------------------

    def insert(self, string, score: int):
        raise not_ported("mutations")

    def delete(self, string):
        raise not_ported("mutations")

    def update_score(self, string, score: int):
        raise not_ported("mutations")

    def compact(self, handoff_path: str | None = None):
        raise not_ported("mutations")

    # -- lookup ------------------------------------------------------------

    def _run(self, qs: np.ndarray, qlens: np.ndarray, k: int,
             cfg: EngineConfig):
        q = torch.from_numpy(np.ascontiguousarray(qs, np.int32)).to(self.device)
        ql = torch.from_numpy(np.ascontiguousarray(qlens, np.int32)).to(
            self.device)
        scores, sids, exact = subs.complete_batch(self.tensors, cfg, q, ql, k)
        return scores.cpu().numpy(), sids.cpu().numpy(), exact.cpu().numpy()

    def complete_batch_padded(self, qs: np.ndarray, qlens: np.ndarray,
                              k: int):
        """Batch entry point: qs int32[B, L] (-1 padded).  Shapes are
        bucketed to powers of two; inexact queries are retried with
        widened search, up to three rounds (exactness guard of §2.2)."""
        B, L = qs.shape
        Bb, Lb = bucket_size(B, minimum=1), bucket_size(L)
        if (Bb, Lb) != (B, L):
            qs = np.pad(qs, ((0, Bb - B), (0, Lb - L)), constant_values=-1)
            qlens = np.pad(qlens, (0, Bb - B))
        cfg = self.cfg
        scores, sids, exact = self._run(qs, qlens, k, cfg)
        bad = ~exact
        bad[B:] = False
        tries = 0
        while bad.any() and tries < 3:
            cfg = replace(cfg, frontier=cfg.frontier * 2, gens=cfg.gens * 4,
                          max_steps=cfg.max_steps * 4, use_cache=False)
            sub = np.nonzero(bad)[0]
            self.retried[tries] += len(sub)
            Sb = bucket_size(len(sub), minimum=1)
            pad_sub = np.pad(sub, (0, Sb - len(sub)))  # repeat row 0: harmless
            s2, i2, e2 = self._run(qs[pad_sub], qlens[pad_sub], k, cfg)
            scores[sub], sids[sub] = s2[:len(sub)], i2[:len(sub)]
            bad2 = np.zeros_like(bad)
            bad2[sub] = ~e2[:len(sub)]
            bad = bad2
            tries += 1
        return scores[:B], sids[:B]

    def complete(self, queries: list[str | bytes], k: int = 10):
        """Top-k completions for a batch of query strings.

        Returns a list (per query) of (score, suggestion string) pairs.
        """
        max_len = max((len(q.encode() if isinstance(q, str) else q)
                       for q in queries), default=1)
        qs, qlens = pad_queries(queries, max(max_len, 1))
        scores, sids = self.complete_batch_padded(qs, qlens, k)
        return [self._decode_row(scores[b], sids[b])
                for b in range(len(queries))]

    def _decode_row(self, scores, sids) -> list[tuple[int, str]]:
        row = []
        for score, sid in zip(np.asarray(scores).tolist(),
                              np.asarray(sids).tolist()):
            if score < 0 or sid < 0:
                continue
            row.append((score, self.strings[sid].decode(
                "utf-8", errors="replace")))
        return row
