"""Public wrappers around the off-path kernels, under the JAX package's
names (``repro.kernels.ops``): ragged-to-dense conversion and padding
rules live here, the launches in the kernel modules.  Each wrapper takes
the kernel on CUDA tensors and the plain version on CPU tensors."""

from __future__ import annotations

import torch

from repro_torch.kernels.candidate_topk import candidate_topk
from repro_torch.kernels.embedding_bag import embedding_bag_dense

__all__ = ["candidate_topk", "densify_bags", "embedding_bag",
           "embedding_bag_dense"]


def densify_bags(indices, offsets, weights, max_bag: int | None,
                 dtype: torch.dtype, device):
    """A ragged (indices int32[I], offsets int32[B+1], weights [I] or None)
    batch as (idx int32[B, MB] with -1 padding, weights [B, MB] of
    ``dtype`` with 0 padding), MB = ``max_bag`` or the longest bag (at
    least 1); entries past MB in a bag are dropped (``repro``'s
    ``ops.embedding_bag``)."""
    indices = torch.as_tensor(indices, device=device).to(torch.int32)
    offsets = torch.as_tensor(offsets, device=device).long()
    B = int(offsets.shape[0]) - 1
    n = int(indices.shape[0])
    lens = offsets[1:] - offsets[:-1]
    mb = int(max_bag if max_bag is not None
             else max(int(lens.max()) if B > 0 else 1, 1))
    w = (torch.ones(n, dtype=dtype, device=device) if weights is None
         else torch.as_tensor(weights, device=device).to(dtype))
    at = torch.arange(n, device=device)
    bag = torch.searchsorted(offsets[1:].contiguous(), at, right=True)
    bag_c = bag.clamp(max=max(B - 1, 0))
    pos = at - offsets[bag_c] if B > 0 else at
    ok = (bag < B) & (pos >= 0) & (pos < mb)
    dense = torch.full((B, mb), -1, dtype=torch.int32, device=device)
    wdense = torch.zeros((B, mb), dtype=dtype, device=device)
    dense[bag_c[ok], pos[ok]] = indices[ok]
    wdense[bag_c[ok], pos[ok]] = w[ok]
    return dense, wdense


def embedding_bag(table: torch.Tensor, indices, offsets, weights=None,
                  mode: str = "sum", max_bag: int | None = None):
    """EmbeddingBag over a ragged (indices, offsets) batch: densified to
    [B, max_bag] on the table's device, then :func:`embedding_bag_dense`.
    indices int32[I] (-1 entries skipped), offsets int32[B+1]."""
    idx, w = densify_bags(indices, offsets, weights, max_bag, table.dtype,
                          table.device)
    return embedding_bag_dense(table, idx, w, mode=mode)
