"""Public wrappers around the off-path kernels, under the JAX package's
names (``repro.kernels.ops``).  Each takes the kernel on CUDA tensors and
the plain version on CPU tensors."""

from __future__ import annotations

import torch

from repro_torch.kernels.candidate_topk import candidate_topk
from repro_torch.kernels.embedding_bag import (densify_bags,
                                               embedding_bag_dense,
                                               embedding_bag_ragged)

__all__ = ["candidate_topk", "densify_bags", "embedding_bag",
           "embedding_bag_dense"]


def embedding_bag(table: torch.Tensor, indices, offsets, weights=None,
                  mode: str = "sum", max_bag: int | None = None):
    """EmbeddingBag over a ragged (indices, offsets) batch: indices [I]
    (-1 entries skipped), offsets [B+1], weights [I] or None; bag b keeps
    its first ``max_bag`` entries (all when None).  On a CUDA table the
    kernel reads the flat arrays (no dense copy, no host sync); on the CPU
    the batch is densified to [B, max_bag] for the plain version."""
    return embedding_bag_ragged(table, indices, offsets, weights, mode=mode,
                                max_bag=max_bag)
