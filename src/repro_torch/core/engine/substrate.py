"""Execution substrates + the public completion entry points.

A :class:`Substrate` bundles the engine's two batched phases behind one
seam: ``walk_batch`` (phase 1, query batch -> locus antichains + overflow
counts) and ``beam_topk_batch`` (phase 2, loci -> top-k + exact flags).

- :class:`TorchSubstrate` (``"torch"``) is the plain PyTorch reference:
  the frontier DP of :mod:`~repro_torch.core.engine.locus` for every kind
  and the batched priority search of :mod:`~repro_torch.core.engine.beam`.
- :class:`CudaSubstrate` (``"cuda"``) routes the same phases through the
  hand-written kernels of :mod:`repro_torch.kernels`: the longest-prefix
  walk for rule-free tries, the fused locus DP for tt/et/ht, and the fused
  beam search.  It never falls back to the plain versions: a kernel that
  cannot take a shape raises.  (The kernel wrappers answer CPU tensors
  with their plain versions, so the routing itself runs under the CPU
  tests.)

``resolve_substrate("auto", device)`` picks ``cuda`` on a CUDA device and
``torch`` on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import beam, locus
from repro_torch.core.engine.structs import DeviceTrie, EngineConfig, NEG_ONE
from repro_torch.not_ported import not_ported


def _no_cache(cfg: EngineConfig) -> None:
    if cfg.use_cache:
        raise not_ported("cache")


class TorchSubstrate:
    """Plain PyTorch reference substrate (the analogue of ``"jnp"``)."""

    name = "torch"

    def walk_batch(self, t: DeviceTrie, cfg: EngineConfig, qs, qlens):
        """qs int32[B, L] (-1 padded), qlens int32[B] ->
        (loci[B, F], overflow[B])."""
        return locus.locus_dp(t, cfg, qs, qlens)

    def beam_topk_batch(self, t: DeviceTrie, cfg: EngineConfig, loci, k: int):
        """(scores[B, k], sids[B, k], exact[B])."""
        return beam.beam_topk(t, cfg, loci, k)


class CudaSubstrate(TorchSubstrate):
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

        if not self._rule_free(t, cfg):
            return locus_dp.locus_dp_walk(t, cfg, qs, qlens)
        node, depth = trie_walk.trie_walk(t.first_child, t.edge_char,
                                          t.edge_child, qs, qlens)
        B = int(qs.shape[0])
        hit = depth == qlens    # partial walks have no completions
        loci = torch.full((B, cfg.frontier), NEG_ONE, dtype=torch.int32,
                          device=qs.device)
        loci[:, 0] = torch.where(hit, node, NEG_ONE)
        return loci, torch.zeros(B, dtype=torch.int32, device=qs.device)

    def beam_topk_batch(self, t, cfg, loci, k):
        from repro_torch.kernels import beam_topk

        return beam_topk.beam_topk_batch(t, cfg, loci, k)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_SUBSTRATES = {"torch": TorchSubstrate(), "cuda": CudaSubstrate()}


def get_substrate(name: str):
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


# ---------------------------------------------------------------------------
# public entry points (substrate-dispatched)
# ---------------------------------------------------------------------------


def _phase2_batch(t, cfg, loci, k, sub):
    """Phase-2 dispatch: the beam search (the cached merge is not ported)."""
    _no_cache(cfg)
    return sub.beam_topk_batch(t, cfg, loci, k)


def complete_batch(t: DeviceTrie, cfg: EngineConfig, qs, qlens, k: int,
                   sub=None):
    """qs int32[B, L]; qlens int32[B] -> (scores[B, k], sids[B, k],
    exact[B])."""
    sub = sub if sub is not None else get_substrate(cfg.substrate)
    loci, overflow = sub.walk_batch(t, cfg, qs, qlens)
    scores, sids, exact = _phase2_batch(t, cfg, loci, k, sub)
    return scores, sids, exact & (overflow == 0)
