"""Plain PyTorch versions of the port's kernels, under the names of the
JAX package's references (``repro.kernels.ref``): each mirrors its
kernel's contract exactly, and the CPU tests hold it against its JAX
counterpart."""

from __future__ import annotations

import torch

from repro_torch.core.engine.cached import select_topk as topk_select_ref
from repro_torch.core.engine.structs import NEG_ONE
from repro_torch.kernels.beam_topk import beam_topk_plain as beam_topk_ref
from repro_torch.kernels.candidate_topk import \
    candidate_topk_plain as candidate_topk_ref
from repro_torch.kernels.locus_dp import locus_dp_plain as locus_walk_ref
from repro_torch.kernels.trie_walk import trie_walk_plain as trie_walk_ref

__all__ = ["beam_topk_ref", "cached_topk_merge_ref", "candidate_topk_ref",
           "embedding_bag_ref", "locus_walk_ref", "topk_select_ref",
           "trie_walk_ref"]


def embedding_bag_ref(table, indices, offsets, weights=None,
                      mode: str = "sum"):
    """``torch.nn.EmbeddingBag`` semantics on a ragged (indices int32[I],
    offsets int32[B+1]) batch, -1 indices skipped
    (``repro.kernels.ref.embedding_bag_ref``); the sum in float32, the
    result in the table's type."""
    V = int(table.shape[0])
    B = int(offsets.shape[0]) - 1
    n = int(indices.shape[0])
    valid = indices >= 0
    rows = table[indices.clamp(0, V - 1).long()].float()
    if weights is not None:
        rows = rows * weights.float()[:, None]
    rows = torch.where(valid[:, None], rows, 0.0)
    seg = torch.searchsorted(offsets[1:].long().contiguous(),
                             torch.arange(n, device=indices.device),
                             right=True)
    keep = seg < B
    out = torch.zeros((B, int(table.shape[1])), dtype=torch.float32,
                      device=table.device)
    out.index_add_(0, seg[keep], rows[keep])
    if mode == "mean":
        cnt = torch.zeros(B, dtype=torch.float32, device=table.device)
        cnt.index_add_(0, seg[keep], valid[keep].float())
        out = out / cnt.clamp(min=1)[:, None]
    return out.to(table.dtype)


def cached_topk_merge_ref(loci, topk_score, topk_sid, k: int):
    """Cached-top-K locus gather + merge over a dense [N, K] cache
    (``repro.kernels.ref.cached_topk_merge_ref``): loci int32[B, F] ->
    (scores[B, k], sids[B, k]), score-descending, -1 where empty,
    candidates loci-major/K-minor."""
    valid = loci >= 0
    n = torch.where(valid, loci, 0).long()
    sc = torch.where(valid[..., None], topk_score[n], NEG_ONE)
    si = torch.where(valid[..., None], topk_sid[n], NEG_ONE)
    b = int(loci.shape[0])
    return topk_select_ref(sc.reshape(b, -1), si.reshape(b, -1), k)
