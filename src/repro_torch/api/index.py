"""CompletionIndex: the queryable, persistable, *mutable* completion index
on one device.

Construction lives in :mod:`repro_torch.api.build` (driven by an
:class:`~repro_torch.api.spec.IndexSpec`) and the container in
:mod:`repro_torch.api.persist`; this module owns the device tensors,
batched lookup with the exactness-retry guard, ``save``/``load``, the
session and scheduler-slab entry points, and the online-mutation surface:

- ``insert``/``delete``/``update_score`` land in a
  :class:`~repro_torch.core.engine.overlay.DeltaOverlay` (tombstones and a
  small side index) merged into results at top-k time — no rebuild per
  change;
- ``compact()`` folds the overlay into a freshly built index and swaps it
  in place.  The index is *epoch-versioned*: every swap (and every
  :meth:`reconfigure`) bumps ``epoch``, and live sessions and scheduler
  slabs migrate onto the new epoch at their next keystroke boundary by
  replaying their retained prefixes.

Every entry point is fetched from a bounded compile cache
(:class:`~repro_torch.api.compile_cache.CompileCache`) under the JAX
package's keys and at its call points.  PyTorch runs eagerly, so an entry
is the prepared callable (the substrate's entry point with the tensors,
the config and k bound), not an executable; batch and query length are
bucketed to powers of two, as in the JAX package, so both packages run
every query at the same shapes and count the same hits and misses.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.api.build import BuildStats
from repro_torch.api.compile_cache import CompileCache, bucket_size
from repro_torch.api.spec import IndexSpec
from repro_torch.core import engine as eng
from repro_torch.core import trie_build as tb
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine import substrate as subs
from repro_torch.core.engine.overlay import DeltaOverlay
from repro_torch.core.engine.structs import (DeviceTrie, EngineConfig,
                                             resolve_device)

#: IndexSpec fields :meth:`CompletionIndex.reconfigure` may change
RUNTIME_FIELDS = ("substrate", "memory_budget", "frontier", "gens",
                  "expand", "max_steps", "edit_budget")
#: fields baked into the built structures; changing them means a rebuild
BUILD_FIELDS = ("kind", "alpha", "cache_k", "compression", "multiterm_gap")


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


@dataclass
class PreparedCompaction:
    """A compaction ready to swap in: the freshly built index and the
    {string: score} snapshot it was built from (mutations landing after
    the snapshot are re-applied as a new overlay at apply time)."""

    index: "CompletionIndex"
    snapshot: dict


class CompletionIndex:
    """A synonym-aware top-k completion index (TT, ET, HT or plain)."""

    def __init__(self, spec: IndexSpec, trie, rule_trie, rules, strings,
                 scores, cfg: EngineConfig, stats: BuildStats | None, *,
                 device, compile_cache_size: int = 32, epoch: int = 0):
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
        self._compile_cache = CompileCache(maxsize=compile_cache_size)
        #: queries re-run by each widened retry round (1st, 2nd, 3rd),
        #: summed over every lookup since the index was made
        self.retried = [0, 0, 0]
        #: bumped by every swap (:meth:`compact`) and every
        #: :meth:`reconfigure` that changes something; sessions and
        #: scheduler slabs compare against it to know when to migrate
        self.epoch = epoch
        self._overlay: DeltaOverlay | None = None

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
        it without re-running trie construction.

        The container holds only the built base structures, so saving
        with uncompacted mutations would drop them: fold them first
        (``compact()``, or ``compact(handoff_path=...)`` to write the
        folded container in the same step)."""
        if self.has_mutations:
            raise ValueError(
                "index has uncompacted mutations that save() would drop; "
                "call compact() first — compact(handoff_path=path) writes "
                "the folded container as part of the swap")
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

    # -- mutations (delta overlay) -----------------------------------------

    @staticmethod
    def _as_key(string) -> bytes:
        b = string.encode() if isinstance(string, str) else bytes(string)
        if not b:
            raise ValueError("cannot mutate the empty string")
        return b

    def _overlay_mut(self) -> DeltaOverlay:
        if self._overlay is None:
            self._overlay = DeltaOverlay()
        return self._overlay

    @property
    def has_mutations(self) -> bool:
        """True while the overlay holds uncompacted mutations; queries
        take the merged path and sessions answer through the one-shot
        lookup until :meth:`compact` folds them away."""
        ov = self._overlay
        return ov is not None and ov.active

    @property
    def mutation_backlog(self) -> int:
        """Pending overlay entries (inserts and re-scores + tombstones):
        the serving loop's compaction trigger."""
        ov = self._overlay
        return 0 if ov is None else len(ov.added) + len(ov.tombstones)

    def insert(self, string, score: int) -> "CompletionIndex":
        """Insert (an upsert: re-score if already present) without a
        rebuild."""
        if score < 0:
            raise ValueError("scores are non-negative")
        self._overlay_mut().upsert(self.strings, self._as_key(string),
                                   int(score))
        return self

    def delete(self, string) -> "CompletionIndex":
        """Delete a live string; raises KeyError when it is not live."""
        self._overlay_mut().remove(self.strings, self._as_key(string))
        return self

    def update_score(self, string, score: int) -> "CompletionIndex":
        """Re-score a live string; raises KeyError when it is not live
        (unlike the upserting :meth:`insert`)."""
        b = self._as_key(string)
        ov = self._overlay
        live = (ov.is_live(self.strings, b) if ov is not None
                else DeltaOverlay._base_sid(self.strings, b) >= 0)
        if not live:
            raise KeyError(f"{b!r} is not in the index; use insert()")
        return self.insert(b, score)

    @property
    def live_strings(self) -> list:
        """The current dictionary (base − deletions + inserts), sorted;
        merged-path sids index this list as base sids index
        :attr:`strings`."""
        if not self.has_mutations:
            return self.strings
        self._overlay.refresh(self)
        return self._overlay.live

    def live_items(self) -> dict:
        """{string: score} of the current dictionary contents."""
        live = {s: int(r) for s, r in zip(
            self.strings, np.asarray(self.scores).tolist())}
        ov = self._overlay
        if ov is not None:
            for s in ov.tombstones:
                live.pop(s, None)
            live.update(ov.added)
        return live

    # -- compaction / hot-swap ---------------------------------------------

    def prepare_compaction(self) -> PreparedCompaction:
        """Fold the current contents into a freshly built index on this
        index's device.

        The expensive half of a compaction: it reads one consistent
        snapshot and mutates nothing; the cheap :meth:`apply_compaction`
        swaps it in at a convenient boundary."""
        from repro_torch.api.build import build_index

        snapshot = self.live_items()
        strings = sorted(snapshot)
        scores = [snapshot[s] for s in strings]
        fresh = build_index(strings, scores, self.rules, self.spec,
                            device=self.device)
        return PreparedCompaction(index=fresh, snapshot=snapshot)

    def apply_compaction(
            self, prepared: PreparedCompaction) -> "CompletionIndex":
        """Swap a prepared compaction in place (cheap, synchronous).

        Adopts every field of the fresh index — host structures, device
        tensors, config, counters — so nothing keeps answering from the
        old tables, drops the compile cache (its entries close over the
        old tensors under keys that do not name the epoch), and bumps
        :attr:`epoch` so live sessions and slabs re-derive their state
        (and refetch their entry points) at the next keystroke boundary.
        Mutations that landed after the snapshot survive: they are diffed
        against it and re-applied as a new overlay on the fresh base; a
        ``reconfigure`` that raced the prepare is re-applied on top."""
        current = self.live_items()
        desired_spec = self.spec
        for name, value in vars(prepared.index).items():
            if name not in ("epoch", "_overlay", "_compile_cache"):
                setattr(self, name, value)
        self._compile_cache = CompileCache(
            maxsize=self._compile_cache.maxsize)
        self._overlay = None
        self.epoch += 1
        snap = prepared.snapshot
        for s, sc in current.items():
            if snap.get(s) != sc:
                self.insert(s, sc)
        for s in snap:
            if s not in current:
                self.delete(s)
        if desired_spec != self.spec:
            # build-time fields cannot diverge: reconfigure rejects them
            runtime = {f: getattr(desired_spec, f) for f in RUNTIME_FIELDS
                       if getattr(desired_spec, f) != getattr(self.spec, f)}
            if runtime:
                self.reconfigure(**runtime)
        return self

    def compact(self, handoff_path: str | None = None) -> "CompletionIndex":
        """Fold the overlay into a fresh index and swap it in place.

        ``handoff_path`` routes the swap through the format-4 container
        (save + load): the folded index lands on disk as a side effect, and
        what is swapped in is what a restarting process would load."""
        prepared = self.prepare_compaction()
        if handoff_path is not None:
            prepared.index.save(handoff_path)
            prepared = PreparedCompaction(
                index=CompletionIndex.load(handoff_path, device=self.device),
                snapshot=prepared.snapshot)
        return self.apply_compaction(prepared)

    # -- sessions ----------------------------------------------------------

    def _fn(self, batch: int, length: int, k: int, cfg: EngineConfig):
        """The batch entry point for one bucketed (batch, length, k, cfg):
        (qs, qlens) on the device -> (scores, sids, exact)."""
        key = ("batch", batch, length, k, cfg)

        def factory():
            dev = self.tensors
            sub = subs.get_substrate(cfg.substrate)

            def run(qs, qlens):
                return subs.complete_batch(dev, cfg, qs, qlens, k, sub)

            return run

        return self._compile_cache.get(key, factory)

    def _session_fns(self, k: int):
        """(init, advance-one-char, topk) over this index's tensors and
        its current config (a :class:`~repro_torch.api.session.Session`
        refetches them when :attr:`epoch` moves)."""
        key = ("session", k, self.cfg)

        def factory():
            dev, cfg = self.tensors, self.cfg
            sub = subs.get_substrate(cfg.substrate)

            def init():
                return eng.init_locus_state(dev, cfg, sub)

            def advance(state, c):
                return eng.advance_locus_state(dev, cfg, state, c, sub)

            def topk(state):
                return eng.topk_from_loci(dev, cfg, state, k, sub)

            return init, advance, topk

        return self._compile_cache.get(key, factory)

    def _slab_fns(self, block: int):
        """(init, advance) over ``block`` lanes: the scheduler's pair.

        ``init()`` makes a slab of ``block`` empty-prefix states;
        ``advance(slab, chars, resets)`` (int32[block] and bool[block] on
        the index's device) re-initialises the lanes flagged in
        ``resets`` and then advances every lane whose char is >= 0, with
        no read back to the host.  The empty-prefix lane depends on the
        tensors and the config alone, so it is made here, once a
        cache entry."""
        key = ("slab", block, self.cfg)

        def factory():
            dev, cfg = self.tensors, self.cfg
            sub = subs.get_substrate(cfg.substrate)
            empty = eng.init_locus_batch(dev, cfg, 1, sub)

            def init():
                return eng.init_locus_batch(dev, cfg, block, sub)

            def advance(slab, chars, resets):
                slab = eng.LocusState(*(
                    torch.where(
                        resets.reshape((block,) + (1,) * (s.dim() - 1)),
                        z, s)
                    for s, z in zip(slab, empty)))
                return eng.advance_loci_batch(dev, cfg, slab, chars, sub)

            return init, advance

        return self._compile_cache.get(key, factory)

    def _slab_topk_fn(self, block: int, k: int):
        """The top-k of every lane of a slab in one phase-2 launch:
        slab -> (scores[block, k], sids[block, k], exact[block])."""
        key = ("slab_topk", block, k, self.cfg)

        def factory():
            dev, cfg = self.tensors, self.cfg
            sub = subs.get_substrate(cfg.substrate)

            def topk(slab):
                return eng.topk_from_loci_batch(dev, cfg, slab, k, sub)

            return topk

        return self._compile_cache.get(key, factory)

    def session(self, k: int = 10):
        """Open a stateful incremental-typing session (see
        :class:`repro_torch.api.session.Session`)."""
        from repro_torch.api.session import Session

        return Session(self, k=k)

    # -- lookup ------------------------------------------------------------

    def _run(self, qs: np.ndarray, qlens: np.ndarray, k: int,
             cfg: EngineConfig):
        q = torch.from_numpy(np.ascontiguousarray(qs, np.int32)).to(self.device)
        ql = torch.from_numpy(np.ascontiguousarray(qlens, np.int32)).to(
            self.device)
        fn = self._fn(int(qs.shape[0]), int(qs.shape[1]), k, cfg)
        scores, sids, exact = fn(q, ql)
        return scores.cpu().numpy(), sids.cpu().numpy(), exact.cpu().numpy()

    def complete_batch_padded(self, qs: np.ndarray, qlens: np.ndarray,
                              k: int):
        """Batch entry point: qs int32[B, L] (-1 padded).  Shapes are
        bucketed to powers of two; inexact queries are retried with
        widened search, up to three rounds (exactness guard of §2.2).

        With pending mutations the answer is the overlay-merged one
        (:meth:`_complete_mutated`) and the returned sids index
        :attr:`live_strings`; otherwise they index :attr:`strings` — the
        two coincide exactly when :attr:`has_mutations` is False."""
        if self.has_mutations:
            return self._complete_mutated(qs, qlens, k)
        return self._complete_base(qs, qlens, k)

    def _complete_base(self, qs: np.ndarray, qlens: np.ndarray, k: int):
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

    def _complete_mutated(self, qs: np.ndarray, qlens: np.ndarray, k: int):
        """Merged lookup under pending mutations.

        The base is over-fetched to k + D' (D' = the tombstone count
        bucketed to a power of two, so a growing backlog keeps few
        shapes) — a result row can lose at most every tombstone — then
        tombstoned hits are masked out on the host and both candidate sets
        are relabelled to *global ranks* (their sid in a from-scratch
        rebuild; see :mod:`repro_torch.core.engine.overlay`).  One
        substrate-routed select returns the top-k bit-identical to that
        rebuild, and the grank "sids" decode against
        :attr:`live_strings`."""
        ov = self._overlay
        ov.refresh(self)
        n_dead = int(ov.base_dead.sum())
        k_base = k + (bucket_size(n_dead, minimum=1) if n_dead else 0)
        b_scores, b_sids = self._complete_base(qs, qlens, k_base)
        valid = b_sids >= 0
        sid0 = np.where(valid, b_sids, 0)
        keep = valid & ~ov.base_dead[sid0]
        cand_s = np.where(keep, b_scores, -1).astype(np.int32)
        cand_g = np.where(keep, ov.base_grank[sid0],
                          eng.INT_MAX).astype(np.int32)
        if ov.index is not None:
            o_scores, o_sids = ov.index.complete_batch_padded(qs, qlens, k)
            o_valid = o_sids >= 0
            o_sid0 = np.where(o_valid, o_sids, 0)
            cand_s = np.concatenate(
                [cand_s, np.where(o_valid, o_scores, -1).astype(np.int32)],
                axis=1)
            cand_g = np.concatenate(
                [cand_g, np.where(o_valid, ov.ov_grank[o_sid0],
                                  eng.INT_MAX).astype(np.int32)], axis=1)
        fn = self._merge_fn(cand_s.shape[0], cand_s.shape[1], k)
        scores, granks = fn(_tensor(cand_s, self.device),
                            _tensor(cand_g, self.device))
        return scores.cpu().numpy(), granks.cpu().numpy()

    def _merge_fn(self, B: int, C: int, k: int):
        """The overlay merge (sort by global rank, then the substrate's
        top-k) for one candidate shape."""
        key = ("overlay_merge", B, C, k, self.cfg)

        def factory():
            sub = subs.get_substrate(self.cfg.substrate)
            return lambda s, g: eng.merge_overlay_topk(s, g, k, sub)

        return self._compile_cache.get(key, factory)

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
        strings = self.live_strings
        for score, sid in zip(np.asarray(scores).tolist(),
                              np.asarray(sids).tolist()):
            if score < 0 or sid < 0:
                continue
            row.append((score, strings[sid].decode(
                "utf-8", errors="replace")))
        return row
