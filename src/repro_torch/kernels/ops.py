"""Public wrappers around the port's kernels, under the JAX package's names
and signatures (``repro.kernels.ops``).  Each launches its kernel on CUDA
tensors and runs the kernel's plain version on CPU tensors.

The ``block_*`` arguments are the TPU kernels' tiling.  A CUDA kernel
picks its own launch shape, so they change no result on the card; they
are still checked to be positive.  ``streamed=True`` selected the
JAX package's DMA-streamed tier.  The card has no tier split, so it runs
the same kernel, and it raises where ``repro`` raises.  Where ``repro``
short-circuits a degenerate shape, the port gives the same answer,
decided by the shape: the empty dictionary's beam before any launch;
``k >= C`` in the select and ``k >= F*K`` in the cached merge inside the
kernel, which sorts the whole row and pads with -1.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import beam
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.structs import NEG_ONE
from repro_torch.kernels import beam_topk as _beam
from repro_torch.kernels import locus_dp as _locus_dp
from repro_torch.kernels import locus_merge as _merge
from repro_torch.kernels import topk_select as _select
from repro_torch.kernels import trie_walk as _walk
from repro_torch.kernels.candidate_topk import candidate_topk
from repro_torch.kernels.embedding_bag import (densify_bags,
                                               embedding_bag_dense,
                                               embedding_bag_ragged)

__all__ = ["beam_topk", "cached_topk_merge", "cached_topk_merge_packed",
           "candidate_topk", "densify_bags", "embedding_bag",
           "embedding_bag_dense", "locus_walk", "topk_select", "trie_walk"]


def _check_block(name: str, **blocks) -> None:
    for arg, value in blocks.items():
        if not isinstance(value, int) or value < 1:
            raise ValueError(f"{name}: {arg} must be a positive int, got "
                             f"{value!r}")


def trie_walk(first_child, edge_char, edge_child, queries, qlens,
              block_q: int = 128, streamed: bool = False,
              walk_tile: int | None = None):
    """Batched longest-prefix walk: queries int32[B, L] (-1 padded), qlens
    int32[B] -> (node[B], depth[B]) int32; see ``kernels/trie_walk.py``.

    ``streamed=True`` requires ``walk_tile`` (``EngineConfig.walk_tile``),
    as in ``repro``; the kernel reads any row width, so the tile does not
    change the walk."""
    _check_block("trie_walk", block_q=block_q)
    if streamed and walk_tile is None:
        raise ValueError(
            "streamed trie_walk requires walk_tile (the layout's "
            "static window width, EngineConfig.walk_tile)")
    return _walk.trie_walk(first_child, edge_char, edge_child, queries,
                           qlens)


def locus_walk(t, cfg, queries, qlens, block_q: int = 8,
               streamed: bool = False):
    """Fused synonym-aware locus DP over a dense or packed index:
    queries int32[B, L] (-1 padded), qlens int32[B] -> (loci[B, F],
    overflow[B]); see ``kernels/locus_dp.py``."""
    _check_block("locus_walk", block_q=block_q)
    return _locus_dp.locus_dp_walk(t, cfg, queries, qlens)


def beam_topk(t, cfg, loci, k: int, block_b: int = 8,
              streamed: bool = False):
    """Fused beam phase 2: loci int32[B, F] -> (scores[B, k], sids[B, k],
    exact[B] bool); see ``kernels/beam_topk.py``.  An empty dictionary
    answers -1 everywhere, exact; the packed layout has no streamed tier
    in ``repro``, so ``streamed=True`` on it raises."""
    _check_block("beam_topk", block_b=block_b)
    B = int(loci.shape[0])
    if beam.is_empty(t):
        full = torch.full((B, k), NEG_ONE, dtype=torch.int32,
                          device=loci.device)
        return full, full.clone(), torch.ones(B, dtype=torch.bool,
                                              device=loci.device)
    if streamed and pk.is_packed(t):
        raise ValueError(
            "no streamed packed beam tier — the substrate probe "
            "routes over-budget packed tries to the jnp reference")
    return _beam.beam_topk_batch(t, cfg, loci, k)


def topk_select(scores, payload, k: int, block_b: int = 8):
    """Top-k with payload: scores/payload int32[B, C] -> (top_s[B, k],
    top_p[B, k]), ties to the lower index; see ``kernels/topk_select.py``.
    ``k >= C`` is the whole row sorted, and ``k > C`` raises, as
    ``lax.top_k`` does."""
    _check_block("topk_select", block_b=block_b)
    return _select.topk_select(scores, payload, k)


def cached_topk_merge(loci, topk_score, topk_sid, k: int, block_b: int = 8):
    """Cached-top-K locus gather + merge over a dense cache: loci
    int32[B, F] (-1 padded), topk_score/topk_sid int32[N, K] ->
    (scores[B, k], sids[B, k]), -1 where empty (``k >= F*K`` is the
    whole union sorted and padded); see ``kernels/locus_merge.py``."""
    _check_block("cached_topk_merge", block_b=block_b)
    return _merge.dense_topk_merge(topk_score, topk_sid, loci, k)


def cached_topk_merge_packed(t, loci, k: int, block_b: int = 8):
    """The cached merge over the packed layout's quantized cache (a locus
    is ranked among the stored nodes and its row widened in the kernel):
    the same candidates, in the same order, as the dense cache's."""
    _check_block("cached_topk_merge_packed", block_b=block_b)
    if not pk.is_packed(t) or t.pc_score is None:
        raise ValueError("cached_topk_merge_packed needs a packed index "
                         "with its top-K cache")
    return _merge.locus_topk_merge(t, loci, k)


def embedding_bag(table: torch.Tensor, indices, offsets, weights=None,
                  mode: str = "sum", max_bag: int | None = None):
    """EmbeddingBag over a ragged (indices, offsets) batch: indices [I]
    (-1 entries skipped), offsets [B+1], weights [I] or None; bag b keeps
    its first ``max_bag`` entries (all when None).  On a CUDA table the
    kernel reads the flat arrays (no dense copy, no host sync); on the CPU
    the batch is densified to [B, max_bag] for the plain version."""
    return embedding_bag_ragged(table, indices, offsets, weights, mode=mode,
                                max_bag=max_bag)
