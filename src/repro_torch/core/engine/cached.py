"""Phase 2b — cached top-k (beyond the paper, cf. Li et al. [9]).

Gather the materialized per-node top-K lists of the locus antichain and
merge: no search loop, exact for k <= K.  The plain PyTorch counterpart
of ``repro.core.engine.cached`` with the batch dimension written out, plus
the two selections the substrates share:

- :func:`select_topk` — top-k by score with a payload carried along,
  ties to the lower candidate index (``lax.top_k`` order); the plain
  version of the ``topk_select`` kernel;
- :func:`cached_topk` — gather + select over the loci-major, K-minor
  candidate union, padded with -1 when k outgrows the union; the plain
  version of the ``locus_topk_merge`` kernel.

When k outgrows the materialized K — and on the widened exactness-retry
rounds, which turn the cache off — phase 2 drops to the beam.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.structs import DeviceTrie, NEG_ONE

#: calls of :func:`select_topk` (the plain version of ``topk_select``)
select_calls = 0
#: calls of :func:`cached_topk` (the plain version of ``locus_topk_merge``)
calls = 0


def gather_cached(t: DeviceTrie, loci: torch.Tensor):
    """Flatten the per-node top-K lists of a locus batch.

    loci int32[..., F] -> (scores[..., F*K], sids[..., F*K]), -1 where the
    locus slot is empty, loci-major/K-minor candidate order."""
    if pk.is_packed(t):
        return pk.gather_cached(t, loci)
    return gather_dense(t.topk_score, t.topk_sid, loci)


def gather_dense(topk_score: torch.Tensor, topk_sid: torch.Tensor,
                 loci: torch.Tensor):
    """:func:`gather_cached` over a dense cache given as its two tables,
    topk_score/topk_sid int32[N, K]."""
    valid = loci >= 0
    n = torch.where(valid, loci, 0).long()
    sc = torch.where(valid[..., None], topk_score[n], NEG_ONE)
    si = torch.where(valid[..., None], topk_sid[n], NEG_ONE)
    flat = tuple(loci.shape[:-1]) + (-1,)
    return sc.reshape(flat), si.reshape(flat)


def select_topk(scores: torch.Tensor, payload: torch.Tensor, k: int):
    """scores/payload int32[B, C] -> (top_s[B, k], top_p[B, k]):
    score-descending, ties to the lower candidate index.  k > C raises,
    as ``lax.top_k`` does."""
    global select_calls
    select_calls += 1
    C = int(scores.shape[1])
    if not 1 <= k <= C:
        raise ValueError(f"top-k select needs 1 <= k <= C; got k={k}, "
                         f"C={C}")
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    idx = order[:, :k]
    return scores.gather(1, idx), payload.gather(1, idx)


def cached_topk(t: DeviceTrie, loci: torch.Tensor, k: int):
    """Cached merge: loci int32[B, F] -> (scores[B, k], sids[B, k]).  When
    k >= F*K the whole union is sorted and the rest padded with -1."""
    global calls
    calls += 1
    return _select_padded(*gather_cached(t, loci), k)


def dense_cached_topk(topk_score: torch.Tensor, topk_sid: torch.Tensor,
                      loci: torch.Tensor, k: int):
    """:func:`cached_topk` over a dense cache given as its two tables."""
    global calls
    calls += 1
    return _select_padded(*gather_dense(topk_score, topk_sid, loci), k)


def _select_padded(flat_s: torch.Tensor, flat_i: torch.Tensor, k: int):
    """Top-k of a candidate union, padded with -1 past its width."""
    width = int(flat_s.shape[1])
    s, p = select_topk(flat_s, flat_i, min(k, width))
    if k > width:
        pad = torch.full((int(flat_s.shape[0]), k - width), NEG_ONE,
                         dtype=torch.int32, device=flat_s.device)
        s, p = torch.cat([s, pad], dim=1), torch.cat([p, pad], dim=1)
    return s, p
