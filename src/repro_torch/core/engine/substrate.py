"""Execution substrates + the public completion entry points.

A substrate bundles the engine's batched hot primitives behind one seam:

- ``csr_child_lookup`` / ``dedup_compact`` — the inner frontier ops a
  session's keystroke threads through (one character step of the locus
  DP; see :mod:`~repro_torch.core.engine.incremental`);
- ``walk_batch`` — phase 1, query batch -> locus antichains + overflow
  counts;
- ``topk_with_payload`` — top-k select with a payload, ties to the lower
  candidate index;
- ``cached_topk_batch`` — the cached phase 2 (per-node top-K gather +
  merge), when the index carries a cache and k fits it;
- ``beam_topk_batch`` — the beam phase 2 otherwise.

- :class:`Substrate` (``"torch"``; ``TorchSubstrate`` is its other name)
  is the plain PyTorch reference:
  the frontier DP of :mod:`~repro_torch.core.engine.locus` for every kind,
  the cached merge of :mod:`~repro_torch.core.engine.cached` and the
  batched priority search of :mod:`~repro_torch.core.engine.beam`.
- :class:`CudaSubstrate` (``"cuda"``) routes the same phases through the
  hand-written kernels of :mod:`repro_torch.kernels`: the longest-prefix
  walk for dense rule-free tries, the fused locus DP for everything else
  (dense tt/et/ht and every packed index), the fused beam search, the
  top-k select and the cached merge, each reading the dense or the packed
  layout.  It never falls back to the plain versions: a kernel that
  cannot take a shape raises.  (The kernel wrappers answer CPU tensors
  with their plain versions, so the routing itself runs under the CPU
  tests.)

The keystroke seams are the one place where ``"cuda"`` runs the plain
versions, by inheritance, as the JAX package's pallas substrate inherits
them from jnp: neither package has a kernel for a keystroke's advance, so
this is no fallback from a kernel.  A session's phase 2 runs on the
kernels.

``resolve_substrate("auto", device)`` picks ``cuda`` on a CUDA device and
``torch`` on the CPU.  Substrates live in a registry, as in the JAX
package: a new backend is ``register_substrate("<name>", MySubstrate())``
away, and a name registered twice raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import beam, cached, locus, primitives
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.structs import DeviceTrie, EngineConfig


class Substrate:
    """Plain PyTorch reference substrate (the analogue of ``"jnp"``), and
    the base every substrate extends."""

    name = "torch"

    # -- the keystroke's inner ops (inherited by "cuda") --------------------

    def csr_child_lookup(self, ptr, chars, children, nodes, ch, iters: int):
        return primitives.csr_child_lookup(ptr, chars, children, nodes, ch,
                                           iters)

    def dedup_compact(self, vec, width: int):
        return primitives.dedup_pad(vec, width)

    # -- phases --------------------------------------------------------------

    def walk_batch(self, t: DeviceTrie, cfg: EngineConfig, qs, qlens):
        """qs int32[B, L] (-1 padded), qlens int32[B] ->
        (loci[B, F], overflow[B])."""
        return locus.locus_dp(t, cfg, qs, qlens)

    def beam_topk_batch(self, t: DeviceTrie, cfg: EngineConfig, loci, k: int):
        """(scores[B, k], sids[B, k], exact[B])."""
        return beam.beam_topk(t, cfg, loci, k)

    def topk_with_payload(self, scores, payload, k: int):
        """scores/payload int32[B, C] -> (top_s[B, k], top_p[B, k]),
        score-descending, ties toward the lower candidate index."""
        return cached.select_topk(scores, payload, k)

    def cached_topk_batch(self, t: DeviceTrie, cfg: EngineConfig, loci,
                          k: int):
        """Cached-top-K gather + merge: loci int32[B, F] ->
        (scores[B, k], sids[B, k], exact[B])."""
        _check_cache(cfg, k)
        s, p = cached.cached_topk(t, loci, k)
        return s, p, torch.ones(loci.shape[0], dtype=torch.bool,
                                device=loci.device)


#: the name this class had before the registry came
TorchSubstrate = Substrate


class CudaSubstrate(Substrate):
    """Hand-written kernel substrate (the analogue of ``"pallas"``)."""

    name = "cuda"

    @staticmethod
    def _rule_free(t: DeviceTrie, cfg: EngineConfig) -> bool:
        """True when the walk is a pure prefix descent (plain kind, or a
        rule-free build): no link store, no teleports, no synonym edges —
        the frontier then never holds more than one node."""
        return (cfg.rule_matches == 0 and cfg.teleports == 0
                and int(t.s_edge_child.shape[0]) == 0
                and cfg.edit_budget == 0)

    def walk_batch(self, t, cfg, qs, qlens):
        from repro_torch.kernels import locus_dp, trie_walk

        # a packed index elides the dense CSR the prefix walk reads, so it
        # always takes the locus DP (as the JAX package's pallas substrate)
        if pk.is_packed(t) or not self._rule_free(t, cfg):
            return locus_dp.locus_dp_walk(t, cfg, qs, qlens)
        # the prefix walk and its loci epilogue, one launch
        return trie_walk.trie_walk_loci(t.first_child, t.edge_char,
                                        t.edge_child, qs, qlens, cfg.frontier)

    def beam_topk_batch(self, t, cfg, loci, k):
        from repro_torch.kernels import beam_topk

        return beam_topk.beam_topk_batch(t, cfg, loci, k)

    def topk_with_payload(self, scores, payload, k):
        from repro_torch.kernels import topk_select

        return topk_select.topk_select(scores, payload, k)

    def cached_topk_batch(self, t, cfg, loci, k):
        from repro_torch.kernels import locus_merge

        _check_cache(cfg, k)
        exact = torch.ones(loci.shape[0], dtype=torch.bool,
                           device=loci.device)
        if not pk.is_packed(t) and self._rule_free(t, cfg):
            # single-locus rows: merging reduces to selecting from the
            # node's own (sorted) top-K list
            sc, si = cached.gather_cached(t, loci[:, :1])
            s, p = self.topk_with_payload(sc, si, k)
            return s, p, exact
        s, p = locus_merge.locus_topk_merge(t, loci, k)
        return s, p, exact


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_SUBSTRATES: dict[str, Substrate] = {}


def register_substrate(name: str, substrate: Substrate) -> Substrate:
    """Register an execution substrate; a new backend is an additive
    ``register_substrate("<name>", MySubstrate())`` away."""
    if name in _SUBSTRATES:
        raise ValueError(f"substrate {name!r} already registered")
    _SUBSTRATES[name] = substrate
    return substrate


def get_substrate(name: str) -> Substrate:
    if name not in _SUBSTRATES:
        raise ValueError(
            f"unknown substrate {name!r}; registered: "
            f"{available_substrates()}")
    return _SUBSTRATES[name]


def available_substrates() -> list[str]:
    return sorted(_SUBSTRATES)


def resolve_substrate(name: str, device) -> str:
    """Resolve a user-facing substrate choice for tensors on ``device``:
    ``"auto"`` is ``cuda`` on a CUDA device and ``torch`` on the CPU;
    concrete names are validated and passed through."""
    if name == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    get_substrate(name)
    return name


register_substrate("torch", Substrate())
register_substrate("cuda", CudaSubstrate())


# ---------------------------------------------------------------------------
# public entry points (substrate-dispatched)
# ---------------------------------------------------------------------------


def _check_cache(cfg: EngineConfig, k: int) -> None:
    if not (cfg.use_cache and k <= cfg.cache_k):
        raise ValueError(f"cached phase 2 needs use_cache and k <= cache_k; "
                         f"got use_cache={cfg.use_cache}, k={k}, "
                         f"cache_k={cfg.cache_k}")


def _phase2_batch(t, cfg, loci, k, sub):
    """Phase-2 dispatch: the cached merge when materialized and k fits,
    else the beam."""
    if cfg.use_cache and k <= cfg.cache_k:
        return sub.cached_topk_batch(t, cfg, loci, k)
    return sub.beam_topk_batch(t, cfg, loci, k)


def topk_phase2(t: DeviceTrie, cfg: EngineConfig, loci, k: int, sub=None):
    """Single-row phase 2 (loci [F]); used by the incremental session."""
    s, p, e = topk_phase2_batch(t, cfg, loci[None], k, sub)
    return s[0], p[0], e[0]


def topk_phase2_batch(t: DeviceTrie, cfg: EngineConfig, loci, k: int,
                      sub=None):
    """Batched phase 2 (loci [B, F]) -> (scores[B, k], sids[B, k],
    exact[B]); one launch for a whole block of sessions."""
    sub = primitives.resolve_sub(cfg, sub)
    return _phase2_batch(t, cfg, loci, k, sub)


def complete_batch(t: DeviceTrie, cfg: EngineConfig, qs, qlens, k: int,
                   sub=None):
    """qs int32[B, L]; qlens int32[B] -> (scores[B, k], sids[B, k],
    exact[B])."""
    sub = primitives.resolve_sub(cfg, sub)
    loci, overflow = sub.walk_batch(t, cfg, qs, qlens)
    scores, sids, exact = _phase2_batch(t, cfg, loci, k, sub)
    return scores, sids, exact & (overflow == 0)


def complete_one(t: DeviceTrie, cfg: EngineConfig, q, qlen, k: int,
                 sub=None):
    """q int32[L], qlen int32[] -> (scores[k], sids[k], exact[])."""
    scores, sids, exact = complete_batch(
        t, cfg, q[None],
        torch.as_tensor(qlen, dtype=torch.int32, device=q.device).reshape(1),
        k, sub)
    return scores[0], sids[0], exact[0]
